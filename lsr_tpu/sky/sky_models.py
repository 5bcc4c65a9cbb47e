"""Sky models + fullscreen sky rendering.

Analog of sky/sky_model.hpp:17 (ISkyModel::sample(dir)), cubemap_sky.hpp:73,
procedural_sky.hpp:19 and skybox_renderer.hpp:25 (render_skybox_to_hdr):
a sky model is a function direction -> linear RGB, evaluated for every pixel
from the camera ray reconstructed via the inverse view-projection.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsr_tpu.core import math3d as m3


def procedural_sky(dirs, zenith=(0.2, 0.38, 0.72), horizon=(0.68, 0.72, 0.78),
                   ground=(0.18, 0.16, 0.15), sun_dir_ws=None,
                   sun_color=(1.0, 0.95, 0.85), sun_size: float = 0.995,
                   sun_intensity: float = 12.0):
    """Gradient + sun disk sky (procedural_sky.hpp:19 semantics)."""
    d = dirs / jnp.maximum(jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-8)
    up = jnp.clip(d[..., 1:2], -1.0, 1.0)
    t = jnp.clip(up, 0.0, 1.0)
    sky = jnp.asarray(horizon, jnp.float32) + (
        jnp.asarray(zenith, jnp.float32) - jnp.asarray(horizon, jnp.float32)
    ) * jnp.sqrt(t)
    gnd = jnp.asarray(ground, jnp.float32) * (1.0 + up * 0.5)
    col = jnp.where(up >= 0.0, sky, gnd)
    if sun_dir_ws is not None:
        to_sun = -jnp.asarray(sun_dir_ws, jnp.float32)
        to_sun = to_sun / jnp.maximum(jnp.linalg.norm(to_sun), 1e-8)
        cos_a = jnp.sum(d * to_sun, axis=-1, keepdims=True)
        disk = jnp.clip((cos_a - sun_size) / jnp.maximum(1.0 - sun_size, 1e-5),
                        0.0, 1.0) ** 2
        col = col + jnp.asarray(sun_color, jnp.float32) * disk * sun_intensity
    return col


def sample_cubemap(faces, dirs):
    """Bilinear cubemap sampling (cubemap_sky.hpp:73).

    faces: (6, S, S, 3) linear, order [+X, -X, +Y, -Y, +Z, -Z].
    dirs: (..., 3).  Returns (..., 3).
    """
    d = dirs / jnp.maximum(jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-8)
    ax, ay, az = jnp.abs(d[..., 0]), jnp.abs(d[..., 1]), jnp.abs(d[..., 2])
    x, y, z = d[..., 0], d[..., 1], d[..., 2]

    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    is_z = ~(is_x | is_y)

    face = jnp.where(
        is_x, jnp.where(x > 0, 0, 1),
        jnp.where(is_y, jnp.where(y > 0, 2, 3), jnp.where(z > 0, 4, 5)),
    ).astype(jnp.int32)

    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))
    ma = jnp.maximum(ma, 1e-8)
    # Standard cube face (u, v) conventions.
    u = jnp.where(is_x, jnp.where(x > 0, -z, z),
                  jnp.where(is_y, x, jnp.where(z > 0, x, -x)))
    v = jnp.where(is_y, jnp.where(y > 0, -z, z), y)
    u = (u / ma + 1.0) * 0.5
    v = (v / ma + 1.0) * 0.5

    s = faces.shape[1]
    fx = u * (s - 1)
    fy = v * (s - 1)
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, s - 1)
    y1 = jnp.minimum(y0 + 1, s - 1)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    c00 = faces[face, y0, x0]
    c10 = faces[face, y0, x1]
    c01 = faces[face, y1, x0]
    c11 = faces[face, y1, x1]
    return (c00 + (c10 - c00) * tx) + ((c01 + (c11 - c01) * tx) - (c00 + (c10 - c00) * tx)) * ty


def camera_ray_dirs(inv_viewproj, width: int, height: int):
    """Per-pixel world-space ray directions from the inverse view-projection
    (skybox_renderer.hpp:25: NDC point at far plane un-projected)."""
    xs = ((jnp.arange(width, dtype=jnp.float32) + 0.5) / width) * 2.0 - 1.0
    ys = ((jnp.arange(height, dtype=jnp.float32) + 0.5) / height) * 2.0 - 1.0
    nx, ny = jnp.meshgrid(xs, ys)
    near = jnp.stack([nx, ny, jnp.full_like(nx, -1.0), jnp.ones_like(nx)], -1)
    far = jnp.stack([nx, ny, jnp.ones_like(nx), jnp.ones_like(nx)], -1)
    pn = near @ inv_viewproj.T
    pf = far @ inv_viewproj.T
    pn = pn[..., :3] / jnp.where(jnp.abs(pn[..., 3:4]) > 1e-8, pn[..., 3:4], 1.0)
    pf = pf[..., :3] / jnp.where(jnp.abs(pf[..., 3:4]) > 1e-8, pf[..., 3:4], 1.0)
    d = pf - pn
    return d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-8)


def procedural_sky_cubemap(size: int = 64, sun_dir_ws=None,
                           ground=(0.18, 0.16, 0.15)):
    """Bake the procedural sky into a (6, S, S, 3) cubemap (IBL source /
    CubemapSky input)."""
    from lsr_tpu.resources.ibl import _face_dirs

    dirs = jnp.asarray(_face_dirs(size))
    return procedural_sky(dirs, ground=ground, sun_dir_ws=sun_dir_ws)


@functools.partial(jax.jit, static_argnames=("width", "height", "kind"))
def render_sky(viewproj, width: int, height: int, kind: str = "procedural",
               sun_dir_ws=None, cubemap=None):
    """Fullscreen sky background (H, W, 3) linear HDR."""
    inv_vp = jnp.linalg.inv(viewproj)
    dirs = camera_ray_dirs(inv_vp, width, height)
    if kind == "cubemap" and cubemap is not None:
        return sample_cubemap(cubemap, dirs)
    return procedural_sky(dirs, sun_dir_ws=sun_dir_ws)
