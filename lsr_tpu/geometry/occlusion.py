"""Occlusion culling: low-res occluder depth raster + HiZ AABB rect tests.

Array-program re-design of the reference's two occlusion backends:
- software occlusion (culling_software.hpp:117-289): depth-rasterize occluder
  geometry at a low-res proxy buffer (the flagship uses 320x180,
  hello_rendering_paths.cpp:94-97), then test each occludee's projected AABB
  rect against the buffer;
- HiZ occlusion (jolt_occlusion_culling.hpp:112-152): same, but the rect test
  samples a max-depth mip pyramid at a level where the rect spans <=2x2
  texels.

Here both are one path: raster depth via the standard rasterizer, build a
max pyramid with strided reductions, and evaluate ALL objects' rect tests as
one vectorized gather — visibility comes back as a mask.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsr_tpu.raster.brute import rasterize_brute
from lsr_tpu.raster.tiled import rasterize_direct


def render_occluder_depth(geom, objects, viewproj, zn, zf,
                          width: int = 320, height: int = 180,
                          occluder_mask=None, use_tiled: bool = True):
    """Depth-only raster of occluder geometry at proxy resolution
    (use_tiled=False: the brute XLA anchor)."""
    mask = objects.visible if occluder_mask is None else occluder_mask
    # Depth-only setup (same CULL_BACK facing rule as the main view; the
    # occluder proxy never reads normals/uvs — raster/setup.py).
    from lsr_tpu.raster.setup import CULL_BACK, scene_setup_depth

    setup = scene_setup_depth(
        geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
        objects.model, viewproj, width, height,
        cull_mode=CULL_BACK, obj_visible=mask,
    )
    if use_tiled:
        depth, _, _ = rasterize_direct(setup, width, height, zn, zf,
                                       track_ids=False, spatial_sort=True)
    else:
        depth, _ = rasterize_brute(setup, width, height, zn, zf)
    return depth


def build_hiz_pyramid(depth, levels: int):
    """Max-depth mip chain: level 0 = input; each level 2x2-max-pools the
    previous (padded with the far value 1.0 on odd sizes)."""
    pyr = [depth]
    cur = depth
    for _ in range(levels - 1):
        h, w = cur.shape
        ph, pw = h + (h & 1), w + (w & 1)
        cur = jnp.pad(cur, ((0, ph - h), (0, pw - w)), constant_values=1.0)
        cur = jnp.max(
            cur.reshape(ph // 2, 2, pw // 2, 2), axis=(1, 3)
        )
        pyr.append(cur)
    return pyr


@functools.partial(jax.jit, static_argnames=("levels",))
def occlusion_cull_aabbs(depth, viewproj, wmins, wmaxs, zn, zf,
                         levels: int = 8):
    """Occlusion mask for object world AABBs vs an occluder depth buffer.

    Returns (B,) bool: True = POTENTIALLY VISIBLE (not occluded).
    Conservative: objects crossing the near plane or off-screen edges are
    kept visible (is_rect_occluded semantics, culling_software.hpp:201-250).
    """
    h, w = depth.shape
    pyr = build_hiz_pyramid(depth, levels)

    # Project the 8 corners of every AABB.
    b = wmins.shape[0]
    sel = jnp.array(
        [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], jnp.float32
    )  # (8, 3)
    corners = wmins[:, None, :] + (wmaxs - wmins)[:, None, :] * sel[None]  # (B,8,3)
    hom = jnp.concatenate([corners, jnp.ones((b, 8, 1), jnp.float32)], -1)
    clip = jnp.matmul(hom, viewproj.T,
                      precision=jax.lax.Precision.HIGHEST)  # (B, 8, 4)
    wc = clip[..., 3]
    near_cross = jnp.any(wc <= 1e-6, axis=-1)  # behind/at camera -> keep

    w_safe = jnp.maximum(wc, 1e-6)
    ndc = clip[..., :3] / w_safe[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * (w - 1)
    sy = (ndc[..., 1] * 0.5 + 0.5) * (h - 1)

    x0 = jnp.clip(jnp.floor(sx.min(axis=1)), 0, w - 1).astype(jnp.int32)
    x1 = jnp.clip(jnp.ceil(sx.max(axis=1)), 0, w - 1).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(sy.min(axis=1)), 0, h - 1).astype(jnp.int32)
    y1 = jnp.clip(jnp.ceil(sy.max(axis=1)), 0, h - 1).astype(jnp.int32)
    degenerate = (sx.max(axis=1) < 0) | (sx.min(axis=1) > w - 1) | \
                 (sy.max(axis=1) < 0) | (sy.min(axis=1) > h - 1)

    # Nearest depth of the object (conservative min over corners).
    view_z = jnp.min(wc, axis=1)
    obj_z01 = jnp.clip((view_z - zn) / jnp.maximum(zf - zn, 1e-6), 0.0, 1.0)

    # Pick the mip level where the rect spans <= 2 texels, then take the max
    # of the 2x2 footprint there.
    span = jnp.maximum(x1 - x0, y1 - y0)
    level = jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(span, 1).astype(jnp.float32))).astype(jnp.int32),
        0, levels - 1,
    )

    occ_max = jnp.zeros((b,), jnp.float32)
    for lv, p in enumerate(pyr):
        lh, lw = p.shape
        lx0 = jnp.clip(x0 >> lv, 0, lw - 1)
        ly0 = jnp.clip(y0 >> lv, 0, lh - 1)
        lx1 = jnp.clip(x1 >> lv, 0, lw - 1)
        ly1 = jnp.clip(y1 >> lv, 0, lh - 1)
        m = jnp.maximum(
            jnp.maximum(p[ly0, lx0], p[ly0, lx1]),
            jnp.maximum(p[ly1, lx0], p[ly1, lx1]),
        )
        occ_max = jnp.where(level == lv, m, occ_max)

    occluded = occ_max < obj_z01 - 1e-4
    visible = ~occluded | near_cross | degenerate
    return visible


def run_occlusion_pass(geom, objects, viewproj, zn, zf, frustum_mask,
                       width: int = 320, height: int = 180,
                       occluder_mask=None, levels: int = 8):
    """Full SW occlusion pass (run_software_occlusion_pass analog,
    culling_software.hpp:253): render occluders, test frustum-visible
    objects, return the refined visibility mask."""
    from lsr_tpu.scene.scene import object_world_aabbs

    occ_mask = frustum_mask if occluder_mask is None else occluder_mask
    depth = render_occluder_depth(
        geom, objects, viewproj, zn, zf, width, height, occluder_mask=occ_mask
    )
    wmin, wmax = object_world_aabbs(objects)
    vis = occlusion_cull_aabbs(depth, viewproj, wmin, wmax, zn, zf, levels=levels)
    return frustum_mask & vis
