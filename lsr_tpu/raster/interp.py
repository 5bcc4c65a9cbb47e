"""Attribute interpolation pass: visibility buffer -> G-buffer.

Given the (depth01, tid) planes from the rasterizer, re-evaluates the winning
triangle's barycentrics per pixel and produces perspective-correct interpolated
attributes (the `FragmentIn` fields of shader/types.hpp:69-80: world_pos,
normal_ws, uv, depth01) as fullscreen arrays — the visibility-buffer analog of
the reference's in-loop varying interpolation (rasterizer.hpp:368-385).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from lsr_tpu.raster.setup import TriSetup


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "world_pos", "normal_ws", "uv", "depth01", "obj_id", "covered",
        "bary", "face_normal", "tri_id", "mat", "tangent",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class GBuffer:
    """Fullscreen interpolated fragment attributes (all (H, W, ...))."""

    world_pos: jnp.ndarray    # (H, W, 3)
    normal_ws: jnp.ndarray    # (H, W, 3) normalized
    uv: jnp.ndarray           # (H, W, 2)
    depth01: jnp.ndarray      # (H, W)
    obj_id: jnp.ndarray       # (H, W) i32, -1 = background
    covered: jnp.ndarray      # (H, W) bool
    bary: jnp.ndarray         # (H, W, 3) perspective-corrected weights
    face_normal: jnp.ndarray  # (H, W, 3) geometric (flat) normal
    tri_id: jnp.ndarray       # (H, W) i32 winning triangle (-1 = none)
    mat: jnp.ndarray | None = None  # (H, W, 16) per-pixel material record
                                    # (pack_material_records layout), baked
                                    # into the interp gather when materials
                                    # are passed to interpolate_gbuffer
    tangent: jnp.ndarray | None = None  # (H, W, 3) per-triangle world
                                        # tangent (normal-mapping TBN)


def pack_interp_records(setup: TriSetup, materials=None):
    """Pack everything the interp pass needs into ONE (N, 40|56) f32 record.

    Gathers pay a per-row overhead: one wide row gather beats seven narrow
    ones — so the per-object MATERIAL record is baked in
    per triangle too when given (lanes 40:56, pack_material_records layout),
    making the shading-time material lookup free.

    Layout: [0:9] coef | [9:12] iw | [12:21] wp | [21:30] nw | [30:36] uv |
            [36] obj_id | [37:40] tangent | [40:56] material (optional).
    """
    n = setup.coef.shape[0]
    # Per-triangle world tangent from uv-space edge derivatives (the
    # standard TBN construction; flat per face, orthogonalized against the
    # smooth normal at the pixel in apply_surface_maps).
    e1 = setup.wp[:, 1] - setup.wp[:, 0]
    e2 = setup.wp[:, 2] - setup.wp[:, 0]
    duv1 = setup.uv[:, 1] - setup.uv[:, 0]
    duv2 = setup.uv[:, 2] - setup.uv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    ok = jnp.abs(det) > 1e-12
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)[:, None]
    tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv
    # Degenerate uv mapping: fall back to the first edge direction.
    tangent = jnp.where(ok[:, None], tangent, e1)

    cols = [
        setup.coef,
        setup.iw,
        setup.wp.reshape(n, 9),
        setup.nw.reshape(n, 9),
        setup.uv.reshape(n, 6),
        setup.obj_id.astype(jnp.float32)[:, None],
        tangent,
    ]
    if materials is not None:
        from lsr_tpu.shading.common import pack_material_records

        cols.append(pack_material_records(materials)[setup.obj_id])
    return jnp.concatenate(cols, axis=-1)


def reconstruct_world_pos(depth01, view, proj, zn, zf,
                          width: int, height: int):
    """World position from the depth plane + camera rays (no interp gather).

    Inverts the raster's DEPTH_VIEWZ storage (z01 = (view_z - zn)/(zf - zn),
    raster/tiled.py) and the screen mapping sx = (ndc*0.5+0.5)*(W-1) at
    pixel centers +0.5 (setup.py:144).  Agrees with the interpolated
    GBuffer.world_pos to ~1e-3 on covered pixels (tests) — enough for
    shadow projection, decoupling the PCF visibility pass from attribute
    interpolation (the fused resolve path).
    """
    view_z = zn + depth01 * (zf - zn)
    xs = jnp.arange(width, dtype=jnp.float32)[None, :] + 0.5
    ys = jnp.arange(height, dtype=jnp.float32)[:, None] + 0.5
    ndc_x = xs / (width - 1) * 2.0 - 1.0
    ndc_y = ys / (height - 1) * 2.0 - 1.0
    vx = ndc_x * (1.0 / proj[0, 0]) * view_z
    vy = ndc_y * (1.0 / proj[1, 1]) * view_z
    # view = [R | t]; world = R^T (v - t).
    rot = view[:3, :3]
    t = view[:3, 3]
    ax = vx - t[0]
    ay = vy - t[1]
    az = view_z - t[2]
    wx = rot[0, 0] * ax + rot[1, 0] * ay + rot[2, 0] * az
    wy = rot[0, 1] * ax + rot[1, 1] * ay + rot[2, 1] * az
    wz = rot[0, 2] * ax + rot[1, 2] * ay + rot[2, 2] * az
    return jnp.stack([wx, wy, wz], -1)


def interpolate_gbuffer(setup: TriSetup, depth01, tid, y_offset=0,
                        materials=None, want_face_normal: bool = True) -> GBuffer:
    """Gather per-pixel triangle data and interpolate attributes.

    y_offset: global row of this band's first row (screen-space sharding).
    materials: optional MaterialsSoA — bakes per-pixel material records into
    the same gather (GBuffer.mat).
    want_face_normal=False skips the geometric-normal cross products (only
    flat shading and debug views read GBuffer.face_normal; the forward+
    path doesn't — saves a few ms/frame at 1080p)."""
    h, w = tid.shape
    covered = tid >= 0
    safe = jnp.where(covered, tid, 0)

    from lsr_tpu.core.gather import take_rows

    rec = take_rows(pack_interp_records(setup, materials), safe)  # ONE gather
    coef = rec[..., 0:9]
    iw = rec[..., 9:12]

    px = (jnp.arange(w, dtype=jnp.float32) + 0.5)[None, :]
    py = (jnp.arange(h, dtype=jnp.float32) + 0.5)[:, None] + jnp.asarray(
        y_offset, jnp.float32
    )

    bc = jnp.stack(
        [
            coef[..., 3 * i] * px + coef[..., 3 * i + 1] * py + coef[..., 3 * i + 2]
            for i in range(3)
        ],
        axis=-1,
    )  # (H, W, 3) screen-space barycentrics
    bciw = bc * iw
    denom = jnp.sum(bciw, axis=-1, keepdims=True)
    weights = bciw / jnp.maximum(denom, 1e-12)  # perspective-correct (H, W, 3)

    def interp(flat, width_):  # flat: (H, W, 3*width_) corner-major
        a = flat.reshape(flat.shape[:-1] + (3, width_))
        return jnp.sum(a * weights[..., None], axis=-2)

    wp = interp(rec[..., 12:21], 3)
    nw = interp(rec[..., 21:30], 3)
    nw = nw / jnp.maximum(jnp.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
    uv = interp(rec[..., 30:36], 2)
    obj = jnp.where(covered, rec[..., 36].astype(jnp.int32), -1)

    if want_face_normal:
        # Geometric per-face normal from world-space corners (flat shading).
        corners = rec[..., 12:21].reshape(rec.shape[:-1] + (3, 3))
        fn = jnp.cross(corners[..., 1, :] - corners[..., 0, :],
                       corners[..., 2, :] - corners[..., 0, :])
        fn = fn / jnp.maximum(jnp.linalg.norm(fn, axis=-1, keepdims=True),
                              1e-12)
        # Orient toward the smooth normal so winding doesn't flip lighting.
        flip = jnp.sum(fn * nw, axis=-1, keepdims=True) < 0.0
        fn = jnp.where(flip, -fn, fn)
    else:
        fn = nw

    return GBuffer(
        world_pos=wp,
        normal_ws=nw,
        uv=uv,
        depth01=depth01,
        obj_id=obj,
        covered=covered,
        bary=weights,
        face_normal=fn,
        tri_id=tid,
        mat=rec[..., 40:56] if materials is not None else None,
        tangent=rec[..., 37:40],
    )
