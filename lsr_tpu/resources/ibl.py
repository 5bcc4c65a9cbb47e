"""Image-based lighting precompute: irradiance + prefiltered specular.

Analog of resources/ibl.hpp:21-272 (CubeMapLinear, diffuse irradiance via
cosine-hemisphere sampling :86-139, specular prefilter via Phong-lobe
sampling per mip :140-213, trilinear prefiltered lookup :272).  The Monte
Carlo estimators are replaced by deterministic quasi-Monte-Carlo (Hammersley)
sequences so results are reproducible, and every integral is one batched
einsum over sample directions instead of per-texel loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lsr_tpu.sky.sky_models import sample_cubemap


def _face_dirs(size: int):
    """(6, S, S, 3) outward direction for each cubemap texel (matches
    sample_cubemap's face conventions)."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(t, t)
    one = np.ones_like(u)
    faces = [
        np.stack([one, v, -u], -1),    # +X
        np.stack([-one, v, u], -1),    # -X
        np.stack([u, one, -v], -1),    # +Y
        np.stack([u, -one, v], -1),    # -Y
        np.stack([u, v, one], -1),     # +Z
        np.stack([-u, v, -one], -1),   # -Z
    ]
    d = np.stack(faces)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _hammersley(n: int):
    """Deterministic 2D low-discrepancy sequence (replaces the reference's
    rand() MC sampling for reproducibility)."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = (((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1))
    bits = (((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2))
    bits = (((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4))
    bits = (((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8))
    return np.stack([i / n, bits.astype(np.float64) / 2**32], -1).astype(np.float32)


def _tangent_basis(n):
    up = jnp.where(jnp.abs(n[..., 1:2]) < 0.95,
                   jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                   jnp.asarray([1.0, 0.0, 0.0], jnp.float32))
    t = jnp.cross(up, n)
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-8)
    b = jnp.cross(n, t)
    return t, b


@functools.partial(jax.jit, static_argnames=("out_size", "samples"))
def compute_irradiance_map(env_faces, out_size: int = 16, samples: int = 256):
    """Cosine-weighted diffuse irradiance cubemap (ibl.hpp:86-139)."""
    dirs = jnp.asarray(_face_dirs(out_size))  # (6, S, S, 3)
    xi = jnp.asarray(_hammersley(samples))    # (N, 2)

    phi = 2.0 * jnp.pi * xi[:, 0]
    cos_t = jnp.sqrt(1.0 - xi[:, 1])
    sin_t = jnp.sqrt(xi[:, 1])
    local = jnp.stack([jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t], -1)

    t, b = _tangent_basis(dirs)
    # (6,S,S,N,3) sample dirs; evaluated in sample chunks to bound memory.
    def body(carry, chunk):
        acc = carry
        lc = chunk  # (C, 3)
        sd = (
            t[..., None, :] * lc[:, 0, None]
            + b[..., None, :] * lc[:, 1, None]
            + dirs[..., None, :] * lc[:, 2, None]
        )  # (6,S,S,C,3)
        col = sample_cubemap(env_faces, sd)
        return acc + col.sum(axis=-2), None

    chunks = local.reshape(-1, 32, 3)
    acc, _ = jax.lax.scan(body, jnp.zeros_like(dirs), chunks)
    return acc / samples


@functools.partial(jax.jit, static_argnames=("out_size", "samples", "mips"))
def compute_prefiltered_specular(env_faces, out_size: int = 32,
                                 samples: int = 128, mips: int = 5):
    """Phong-lobe prefiltered specular chain (ibl.hpp:140-213).

    Returns list of (6, S_m, S_m, 3) maps, roughness = mip/(mips-1)."""
    xi = jnp.asarray(_hammersley(samples))
    out = []
    for mip in range(mips):
        size = max(4, out_size >> mip)
        rough = mip / max(1, mips - 1)
        power = jnp.float32(max(2.0, (1.0 - rough) * 512.0))
        dirs = jnp.asarray(_face_dirs(size))
        t, b = _tangent_basis(dirs)

        phi = 2.0 * jnp.pi * xi[:, 0]
        cos_t = jnp.power(xi[:, 1], 1.0 / (power + 1.0))
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        local = jnp.stack([jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t], -1)

        def body(carry, chunk, t=t, b=b, dirs=dirs):
            acc, wsum = carry
            sd = (
                t[..., None, :] * chunk[:, 0, None]
                + b[..., None, :] * chunk[:, 1, None]
                + dirs[..., None, :] * chunk[:, 2, None]
            )
            w = chunk[:, 2]  # cos weight
            col = sample_cubemap(env_faces, sd)
            return (acc + (col * w[:, None]).sum(-2), wsum + w.sum()), None

        chunks = local.reshape(-1, 32, 3)
        (acc, wsum), _ = jax.lax.scan(
            body, (jnp.zeros_like(dirs), jnp.float32(0.0)), chunks
        )
        out.append(acc / jnp.maximum(wsum, 1e-6))
    return out


def sample_prefiltered(mip_maps, dirs, roughness):
    """Trilinear-in-roughness prefiltered lookup (ibl.hpp:272)."""
    mips = len(mip_maps)
    level = jnp.clip(roughness, 0.0, 1.0) * (mips - 1)
    lo = jnp.clip(jnp.floor(level).astype(jnp.int32), 0, mips - 1)
    frac = level - lo.astype(jnp.float32)
    out = jnp.zeros(dirs.shape[:-1] + (3,), jnp.float32)
    for m in range(mips):
        cm = sample_cubemap(mip_maps[m], dirs)
        w_lo = jnp.where(lo == m, 1.0 - frac, 0.0)
        w_hi = jnp.where((lo + 1) == m, frac, 0.0)
        w = (w_lo + w_hi)
        if w.ndim < cm.ndim:
            w = w[..., None]
        out = out + cm * w
    return out


def eval_ibl(irradiance_faces, prefiltered_mips, n, v, base_color, metallic,
             roughness, ao):
    """Real IBL ambient term (replaces eval_fake_ibl when maps exist)."""
    ndv = jnp.maximum(jnp.sum(n * v, axis=-1, keepdims=True), 0.0)
    r = 2.0 * ndv * n - v
    irr = sample_cubemap(irradiance_faces, n)
    spec_env = sample_prefiltered(prefiltered_mips, r, roughness[..., 0]
                                  if roughness.ndim > n.ndim - 1 else roughness)
    f0 = 0.04 + (base_color - 0.04) * metallic
    fres = jnp.power(1.0 - ndv, 5.0)
    f = f0 + (jnp.maximum(1.0 - roughness, f0) - f0) * fres
    kd = (1.0 - f) * (1.0 - metallic)
    return (kd * base_color * irr + spec_env * f) * jnp.clip(ao, 0.0, 1.0)
