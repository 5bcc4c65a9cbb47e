"""Shading common: materials SoA, texture sampling, shared BRDF helpers.

Fragment shaders in this framework are fused fullscreen array transforms over
the G-buffer (the JAX re-expression of the per-pixel std::function FS of
shader/program.hpp:22).  Per-object uniforms live in SoA arrays gathered by
the per-pixel object id.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["base_color", "metallic", "roughness", "ao", "emissive",
                 "tex_id", "normal_tex", "orm_tex", "emissive_tex"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class MaterialsSoA:
    """Per-object material table (analog of MaterialData, resources/material.hpp:22).

    The four texture slots mirror MaterialData's base_color_tex / normal_tex
    / orm_tex / emissive_tex (material.hpp:36-39); all index the ONE shared
    texture array of the shade context (-1 = slot unused).  Normal maps are
    tangent-space (x,y,z in [0,1]); ORM follows the glTF layout
    (R=occlusion, G=roughness, B=metallic) and multiplies the scalar
    factors; the emissive map multiplies `emissive`."""

    base_color: jnp.ndarray  # (O, 3) linear
    metallic: jnp.ndarray    # (O,)
    roughness: jnp.ndarray   # (O,)
    ao: jnp.ndarray          # (O,)
    emissive: jnp.ndarray    # (O, 3)
    tex_id: jnp.ndarray      # (O,) i32 base-color texture; -1 = none
    normal_tex: jnp.ndarray  # (O,) i32 tangent-space normal map; -1 = none
    orm_tex: jnp.ndarray     # (O,) i32 occlusion/roughness/metallic map
    emissive_tex: jnp.ndarray  # (O,) i32 emissive map; -1 = none


def make_materials(
    base_color=((1.0, 1.0, 1.0),),
    metallic=(0.0,),
    roughness=(0.6,),
    ao=(1.0,),
    emissive=None,
    tex_id=None,
    normal_tex=None,
    orm_tex=None,
    emissive_tex=None,
) -> MaterialsSoA:
    base_color = jnp.asarray(base_color, jnp.float32)
    o = base_color.shape[0]
    if emissive is None:
        emissive = jnp.zeros((o, 3), jnp.float32)

    def bcast(x, dt=jnp.float32):
        return jnp.broadcast_to(jnp.asarray(x, dt), (o,))

    def tex_col(x):
        return bcast(-1 if x is None else x, jnp.int32)

    return MaterialsSoA(
        base_color=base_color,
        metallic=bcast(metallic),
        roughness=bcast(roughness),
        ao=bcast(ao),
        emissive=jnp.broadcast_to(jnp.asarray(emissive, jnp.float32), (o, 3)),
        tex_id=tex_col(tex_id),
        normal_tex=tex_col(normal_tex),
        orm_tex=tex_col(orm_tex),
        emissive_tex=tex_col(emissive_tex),
    )


def _norm(v, eps=1e-12):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


def pack_material_records(m: MaterialsSoA):
    """(O, 16) packed record: one wide per-pixel gather beats per-column
    gathers.  Layout: [0:3] base_color | [3] metallic |
    [4] roughness | [5] ao | [6:9] emissive | [9] tex_id | [10] normal_tex |
    [11] orm_tex | [12] emissive_tex | [13:16] pad."""
    o = m.base_color.shape[0]
    return jnp.concatenate(
        [
            m.base_color,
            m.metallic[:, None], m.roughness[:, None], m.ao[:, None],
            m.emissive,
            m.tex_id.astype(jnp.float32)[:, None],
            m.normal_tex.astype(jnp.float32)[:, None],
            m.orm_tex.astype(jnp.float32)[:, None],
            m.emissive_tex.astype(jnp.float32)[:, None],
            jnp.zeros((o, 3), jnp.float32),
        ],
        axis=-1,
    )


def gather_materials(m: MaterialsSoA, obj_id, mat_rec=None):
    """Per-pixel material fields via one packed gather (or a pre-baked
    per-pixel record plane, e.g. GBuffer.mat).

    Returns (base_color, metallic, roughness, ao, emissive, tex_id)."""
    from lsr_tpu.core.gather import take_rows

    rec = mat_rec if mat_rec is not None \
        else take_rows(pack_material_records(m), jnp.maximum(obj_id, 0))
    return (
        rec[..., 0:3],
        rec[..., 3:4],
        rec[..., 4:5],
        rec[..., 5:6],
        rec[..., 6:9],
        rec[..., 9].astype(jnp.int32),
    )


def gather_material_texture_slots(m: MaterialsSoA, obj_id, mat_rec=None):
    """(normal_tex, orm_tex, emissive_tex) per pixel from the packed record
    lanes 10-12 (material.hpp:37-39 slots)."""
    from lsr_tpu.core.gather import take_rows

    rec = mat_rec if mat_rec is not None \
        else take_rows(pack_material_records(m), jnp.maximum(obj_id, 0))
    return (rec[..., 10].astype(jnp.int32),
            rec[..., 11].astype(jnp.int32),
            rec[..., 12].astype(jnp.int32))


def apply_surface_maps(textures, quads, uv, tangent, n,
                       normal_tex, orm_tex, emissive_tex,
                       metallic, roughness, ao, emissive):
    """Apply the normal / ORM / emissive texture slots per pixel.

    Normal mapping (the missing half of SURVEY §7 step 4; config 2 includes
    "texture + normal mapping"): per-triangle tangent (GBuffer.tangent) is
    Gram-Schmidt-orthogonalized against the interpolated normal, the
    bitangent completes the TBN frame, and the tangent-space sample
    (x,y,z in [0,1] -> [-1,1]) rotates into world space.  ORM and emissive
    maps multiply their factors; unused slots sample 1.0 so they are
    identity without masking.

    Returns (n', metallic', roughness', ao', emissive')."""
    t = tangent - n * jnp.sum(n * tangent, -1, keepdims=True)
    t = _norm(t)
    b = jnp.cross(n, t)
    ts = sample_texture_bilinear(textures, normal_tex, uv, quads) * 2.0 - 1.0
    n_mapped = _norm(
        t * ts[..., 0:1] + b * ts[..., 1:2] + n * ts[..., 2:3])
    n_out = jnp.where((normal_tex >= 0)[..., None], n_mapped, n)

    orm = sample_texture_bilinear(textures, orm_tex, uv, quads)
    ao_out = ao * orm[..., 0:1]
    rough_out = roughness * orm[..., 1:2]
    metal_out = metallic * orm[..., 2:3]

    em = sample_texture_bilinear(textures, emissive_tex, uv, quads)
    return n_out, metal_out, rough_out, ao_out, emissive * em


def pack_texture_quads(textures):
    """(NT, TH, TW, 3) -> (NT*TH*TW, 12): each texel row holds its 2x2
    clamped neighborhood [c00 c10 c01 c11], so bilinear sampling needs ONE
    row gather instead of four (gathers pay a per-row overhead)."""
    nt, th, tw, _ = textures.shape
    right = jnp.concatenate([textures[:, :, 1:], textures[:, :, -1:]], axis=2)
    down = jnp.concatenate([textures[:, 1:], textures[:, -1:]], axis=1)
    down_right = jnp.concatenate([down[:, :, 1:], down[:, :, -1:]], axis=2)
    quads = jnp.concatenate([textures, right, down, down_right], axis=-1)
    return quads.reshape(nt * th * tw, 12)


def sample_texture_bilinear(textures, tex_id, uv, quads=None):
    """Bilinear, repeat-wrapped texture sampling over a texture array.

    textures: (NT, TH, TW, 3) f32 LINEAR texels (sRGB decode happens at
    upload; the reference decodes per-texel before the bilinear mix
    (builtin_shaders.hpp:47-54), which is numerically identical).
    tex_id: (H, W) i32 (-1 = none -> white).
    uv: (H, W, 2).
    quads: optional pack_texture_quads(textures) for the fast one-gather path.
    Returns (H, W, 3).
    """
    nt, th, tw, _ = textures.shape
    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    fx = u * (tw - 1)
    fy = v * (th - 1)
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    tid = jnp.maximum(tex_id, 0)

    from lsr_tpu.core.gather import take_rows

    if quads is not None:
        flat = (tid * th + y0) * tw + x0
        q = take_rows(quads, flat)  # ONE (..., 12) gather
        c00, c10, c01, c11 = q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12]
    else:
        x1 = jnp.minimum(x0 + 1, tw - 1)
        y1 = jnp.minimum(y0 + 1, th - 1)
        texf = textures.reshape(nt * th * tw, 3)
        c00 = take_rows(texf, (tid * th + y0) * tw + x0)
        c10 = take_rows(texf, (tid * th + y0) * tw + x1)
        c01 = take_rows(texf, (tid * th + y1) * tw + x0)
        c11 = take_rows(texf, (tid * th + y1) * tw + x1)
    cx0 = c00 + (c10 - c00) * tx
    cx1 = c01 + (c11 - c01) * tx
    out = cx0 + (cx1 - cx0) * ty
    return jnp.where((tex_id >= 0)[..., None], out, 1.0)


def eval_fake_ibl(n, v, base_color, metallic, roughness, ao):
    """Ambient approximation without LUT/PMREM (builtin_shaders.hpp:57-89).

    All args broadcastable to (H, W, 3) / (H, W, 1).
    """
    n = _norm(n)
    v = _norm(v)
    ndv = jnp.sum(n * v, axis=-1, keepdims=True)
    r = 2.0 * ndv * n - v  # reflect(-v, n)

    sky_zenith = jnp.array([0.32, 0.46, 0.72], jnp.float32)
    sky_horizon = jnp.array([0.62, 0.66, 0.72], jnp.float32)
    ground = jnp.array([0.16, 0.15, 0.14], jnp.float32)

    up_n = jnp.clip(n[..., 1:2] * 0.5 + 0.5, 0.0, 1.0)
    up_r = jnp.clip(r[..., 1:2] * 0.5 + 0.5, 0.0, 1.0)
    env_n = ground + ((sky_horizon + (sky_zenith - sky_horizon) * up_n) - ground) * up_n
    env_r = ground + ((sky_horizon + (sky_zenith - sky_horizon) * up_r) - ground) * up_r

    m = jnp.clip(metallic, 0.0, 1.0)
    rgh = jnp.clip(roughness, 0.0, 1.0)
    f0 = 0.04 + (jnp.maximum(base_color, 0.0) - 0.04) * m
    fres = jnp.power(1.0 - jnp.maximum(ndv, 0.0), 5.0)
    f = f0 + (1.0 - f0) * fres

    kd = (1.0 - f) * (1.0 - m)
    diffuse = kd * base_color * env_n * 0.12
    spec_strength = 0.02 + (1.0 - rgh) * 0.18
    spec = env_r * f * spec_strength
    return (diffuse + spec) * jnp.clip(ao, 0.0, 1.0)


def checkerboard_texture(size: int = 64, squares: int = 8,
                         c0=(0.8, 0.8, 0.8), c1=(0.2, 0.25, 0.35)) -> np.ndarray:
    """Host-side procedural test texture (linear color)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = ((xx * squares // size) + (yy * squares // size)) % 2
    tex = np.where(cell[..., None] == 0, np.float32(c0), np.float32(c1))
    return tex.astype(np.float32)


def bump_normal_texture(size: int = 128, bumps: int = 6,
                        amplitude: float = 0.8) -> np.ndarray:
    """Host-side tangent-space normal map: a grid of cosine bumps.

    Returns (size, size, 3) in [0,1] encoding (x,y,z in [-1,1]) — the
    standard normal-map convention apply_surface_maps decodes.  Data is
    LINEAR (never sRGB-decode a normal map on upload)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    phase = 2.0 * np.pi * bumps
    # height = sum of cosine bumps; analytic derivatives give the slope.
    dhdx = amplitude * np.sin(phase * xx) * phase / size * 8.0
    dhdy = amplitude * np.sin(phase * yy) * phase / size * 8.0
    n = np.stack([-dhdx, -dhdy, np.ones_like(dhdx)], -1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)
