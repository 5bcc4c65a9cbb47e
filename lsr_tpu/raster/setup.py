"""Triangle setup: vertex transform -> near clip -> screen-space edge setup.

This is the geometry front-end of the rasterizer (the analog of the
per-triangle prologue of rasterize_mesh, rasterizer.hpp:206-328), restructured
as batched SoA array transforms:

- vertex transform is one big (V,4) x (4,4) matmul per scene batch,
- near clipping is the static 2-slot expansion from raster/clip.py,
- per-triangle "setup" precomputes the affine barycentric coefficients
  bc_i(x, y) = A_i x + B_i y + C_i, the per-corner 1/w, and the screen bbox,
  so the rasterization kernel does pure FMA work per (triangle, pixel).

Backface culling replicates RasterizerCullMode/front_face_ccw semantics
(rasterizer.hpp:26, :275-281): screen-space signed area in the bottom-left
canvas basis decides facing.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

CULL_NONE = 0
CULL_BACK = 1
CULL_FRONT = 2

DEPTH_VIEWZ = 0   # z01 = (1/denom - zn) / (zf - zn)   (perspective, rasterizer.hpp:349-360)
DEPTH_NDC01 = 1   # z01 = z_ndc * 0.5 + 0.5            (ortho / shadow passes)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["coef", "iw", "ziw", "bbox", "valid", "obj_id", "wp", "nw", "uv"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class TriSetup:
    """Post-clip per-triangle SoA raster setup (N = 2 * input triangles)."""

    coef: jnp.ndarray    # (N, 9) f32: A0,B0,C0,A1,B1,C1,A2,B2,C2
    iw: jnp.ndarray      # (N, 3) f32: per-corner 1/w_clip
    ziw: jnp.ndarray     # (N, 3) f32: per-corner z_ndc * (1/w)
    bbox: jnp.ndarray    # (N, 4) i32: x0, y0, x1, y1 (inclusive, clamped)
    valid: jnp.ndarray   # (N,) bool
    obj_id: jnp.ndarray  # (N,) i32 object index (for material lookup)
    wp: jnp.ndarray      # (N, 3, 3) f32 per-corner world position
    nw: jnp.ndarray      # (N, 3, 3) f32 per-corner world normal
    uv: jnp.ndarray      # (N, 3, 2) f32 per-corner uv

    @property
    def count(self) -> int:
        return int(self.coef.shape[0])


def vertex_stage(positions, normals, uvs, vtx_obj, models, normal_mats, viewproj):
    """Batched vertex shader (make_default_vertex_out semantics,
    builtin_shaders.hpp:92-107).

    positions/normals: (V, 3); uvs: (V, 2); vtx_obj: (V,) i32;
    models: (O, 4, 4); normal_mats: (O, 3, 3); viewproj: (4, 4).
    Returns (world (V,3), clip (V,4), normal_ws (V,3)).
    """
    # ONE packed per-vertex gather (model 16 + normal-matrix 9 floats)
    # instead of separate (V,4,4)/(V,3,3) row gathers.
    o = models.shape[0]
    xf = jnp.concatenate(
        [models.reshape(o, 16), normal_mats.reshape(o, 9)], axis=-1
    )[vtx_obj]                                   # (V, 25)
    # Per-vertex tiny matmuls written as explicit FMAs over (V,) columns:
    # one fused elementwise pass instead of (V,4,4)x(V,4) batched matmuls.
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]

    def row4(c):
        return xf[:, c] * x + xf[:, c + 1] * y + xf[:, c + 2] * z + xf[:, c + 3]

    world_h = jnp.stack([row4(0), row4(4), row4(8), row4(12)], axis=-1)
    world = world_h[:, :3]
    # Full f32: a TF32 product would move vertices by about a pixel.
    clip = jnp.matmul(world_h, viewproj.T, precision=jax.lax.Precision.HIGHEST)
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]

    def nrow(c):
        return xf[:, 16 + c] * nx + xf[:, 17 + c] * ny + xf[:, 18 + c] * nz

    n_ws = jnp.stack([nrow(0), nrow(3), nrow(6)], axis=-1)
    n_len = jnp.linalg.norm(n_ws, axis=-1, keepdims=True)
    n_ws = n_ws / jnp.maximum(n_len, 1e-12)
    return world, clip, n_ws


def vertex_stage_world(positions, vtx_obj, models):
    """World-only vertex stage for depth targets: the model transform's
    exact FMA order from vertex_stage (bit-identical world positions), no
    normal matrix gather/transform/normalize and no uv plumbing.

    Returns world_h (V, 4) homogeneous world positions (w = model row 3
    applied, identical to vertex_stage's world_h)."""
    o = models.shape[0]
    xf = models.reshape(o, 16)[vtx_obj]          # (V, 16)
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]

    def row4(c):
        return xf[:, c] * x + xf[:, c + 1] * y + xf[:, c + 2] * z + xf[:, c + 3]

    return jnp.stack([row4(0), row4(4), row4(8), row4(12)], axis=-1)


def assemble_and_clip(clip_v, world_v, normal_v, uv_v, indices, tri_obj):
    """Gather triangle corners and near-clip with static expansion.

    Returns flattened post-clip arrays of length N = 2 * T:
    (clip (N,3,4), attrs dict of (N,3,A), valid (N,), obj_id (N,)).
    """
    from lsr_tpu.raster.clip import clip_triangles_near

    # ONE packed per-corner gather (clip 4 + world 3 + normal 3 + uv 2).
    vrec = jnp.concatenate([clip_v, world_v, normal_v, uv_v], axis=-1)
    crec = vrec[indices]              # (T, 3, 12)
    tri_clip = crec[..., 0:4]
    attrs = {
        "wp": crec[..., 4:7],
        "normal": crec[..., 7:10],
        "uv": crec[..., 10:12],
    }
    clip2, attrs2, valid2 = clip_triangles_near(attrs, tri_clip)
    t = indices.shape[0]
    flat = lambda x: x.reshape((2 * t,) + x.shape[2:])  # noqa: E731
    obj2 = jnp.broadcast_to(tri_obj[:, None], (t, 2)).reshape(-1)
    return (
        flat(clip2),
        {k: flat(v) for k, v in attrs2.items()},
        valid2.reshape(-1),
        obj2,
    )


def build_setup(
    clip_tris,
    attrs,
    valid,
    obj_id,
    width: int,
    height: int,
    cull_mode: int = CULL_BACK,
    front_face_ccw: bool = True,
) -> TriSetup:
    """Compute screen-space raster setup for post-clip triangles.

    clip_tris: (N, 3, 4); attrs: dict wp/normal/uv (N, 3, A); valid: (N,).
    """
    w_clip = clip_tris[..., 3]  # (N, 3)
    w_ok = jnp.all(w_clip > 1e-8, axis=-1)
    iw = jnp.where(w_clip > 1e-8, 1.0 / jnp.maximum(w_clip, 1e-8), 0.0)
    ndc = clip_tris[..., :3] * iw[..., None]  # (N, 3, 3)
    finite = jnp.all(jnp.isfinite(ndc), axis=(1, 2))

    # Screen mapping (rasterizer.hpp:267-269): bottom-left origin canvas.
    sx = (ndc[..., 0] * 0.5 + 0.5) * (width - 1)   # (N, 3)
    sy = (ndc[..., 1] * 0.5 + 0.5) * (height - 1)

    # Facing / degeneracy (rasterizer.hpp:271-281).
    e0x, e0y = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
    e1x, e1y = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
    area2 = e0x * e1y - e0y * e1x
    nondegenerate = jnp.abs(area2) >= 1e-10
    tri_ccw = area2 > 0.0
    is_front = tri_ccw == front_face_ccw
    if cull_mode == CULL_BACK:
        face_ok = is_front
    elif cull_mode == CULL_FRONT:
        face_ok = ~is_front
    else:
        face_ok = jnp.ones_like(is_front)

    # Affine barycentric coefficients: bc_i = cross(s_k - s_j, p - s_j)/area2
    # for (i,j,k) cyclic.  bc_i(s_i) == 1.
    inv_area = jnp.where(nondegenerate, 1.0 / jnp.where(nondegenerate, area2, 1.0), 0.0)

    def edge_coef(j, k):
        a = (sy[:, j] - sy[:, k]) * inv_area
        b = (sx[:, k] - sx[:, j]) * inv_area
        c = (sx[:, j] * sy[:, k] - sx[:, k] * sy[:, j]) * inv_area
        return a, b, c

    a0, b0, c0 = edge_coef(1, 2)
    a1, b1, c1 = edge_coef(2, 0)
    a2, b2, c2 = edge_coef(0, 1)
    coef = jnp.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2], axis=-1)

    # Screen bbox (rasterizer.hpp:283-292).
    x0 = jnp.clip(jnp.floor(jnp.min(sx, axis=1)), 0, width - 1).astype(jnp.int32)
    x1 = jnp.clip(jnp.ceil(jnp.max(sx, axis=1)), 0, width - 1).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(jnp.min(sy, axis=1)), 0, height - 1).astype(jnp.int32)
    y1 = jnp.clip(jnp.ceil(jnp.max(sy, axis=1)), 0, height - 1).astype(jnp.int32)
    # Reject triangles entirely off-screen.
    on_screen = (
        (jnp.max(sx, axis=1) >= 0.0)
        & (jnp.min(sx, axis=1) <= width - 1)
        & (jnp.max(sy, axis=1) >= 0.0)
        & (jnp.min(sy, axis=1) <= height - 1)
    )
    bbox = jnp.stack([x0, y0, x1, y1], axis=-1)

    ok = valid & w_ok & finite & nondegenerate & face_ok & on_screen

    n = clip_tris.shape[0]
    zero3 = jnp.zeros((n, 3, 0), jnp.float32)
    return TriSetup(
        coef=coef,
        iw=iw,
        ziw=ndc[..., 2] * iw,
        bbox=bbox,
        valid=ok,
        obj_id=obj_id.astype(jnp.int32),
        # Depth-only targets (shadow maps, occluder proxies) carry no
        # shading attributes: zero-width corner arrays keep TriSetup's
        # pytree shape without the gather/interp cost.
        wp=attrs.get("wp", zero3),
        nw=attrs.get("normal", zero3),
        uv=attrs.get("uv", jnp.zeros((n, 3, 0), jnp.float32)),
    )


def scene_setup_depth(
    positions,
    indices,
    vtx_obj,
    tri_obj,
    models,
    viewproj,
    width: int,
    height: int,
    cull_mode: int = CULL_NONE,
    front_face_ccw: bool = True,
    obj_visible=None,
) -> TriSetup:
    """Depth-only geometry front-end for shadow/occluder targets.

    Same case tables and build math as scene_setup; it skips what a depth
    raster never reads — the normal-matrix gather + transform + normalize,
    the uv plumbing, and the 12-wide per-corner attribute gather (4-wide
    clip corners instead) — and computes the clip transform with the same
    explicit lane-FMA order as scene_setup_slots_depth, so single-slot and
    stacked-slot depth setups are bit-identical by construction (scene_setup
    uses a `world_h @ viewproj.T` dot that may accumulate in another order;
    depth consumers are re-goldened on this path).
    TriSetup.wp/nw/uv come back zero-width."""
    world_h = vertex_stage_world(positions, vtx_obj, models)
    wx, wy, wz, ww = (world_h[:, 0], world_h[:, 1], world_h[:, 2],
                      world_h[:, 3])

    def crow(r):
        return (viewproj[r, 0] * wx + viewproj[r, 1] * wy
                + viewproj[r, 2] * wz + viewproj[r, 3] * ww)

    clip_v = jnp.stack([crow(0), crow(1), crow(2), crow(3)], axis=-1)
    from lsr_tpu.raster.clip import clip_triangles_near

    tri_clip = clip_v[indices]                    # (T, 3, 4)
    clip2, _, valid2 = clip_triangles_near({}, tri_clip)
    t = indices.shape[0]
    obj2 = jnp.broadcast_to(tri_obj[:, None], (t, 2)).reshape(-1)
    valid = valid2.reshape(-1)
    if obj_visible is not None:
        valid = valid & obj_visible[obj2]
    return build_setup(
        clip2.reshape(2 * t, 3, 4), {}, valid, obj2, width, height,
        cull_mode, front_face_ccw,
    )


def scene_setup_slots_depth(
    positions,
    indices,
    vtx_obj,
    tri_obj,
    models,
    viewprojs,
    size: int,
    cull_mode: int = CULL_NONE,
    front_face_ccw: bool = True,
    obj_visible_slots=None,
) -> TriSetup:
    """Depth-only multi-view front-end: one setup per shadow-atlas slot.

    viewprojs: (S, 4, 4).  Returns a TriSetup with a leading (S,) slot dim
    and zero-width attrs (see scene_setup_depth).

    Structure (the r4 packed-atlas setup, restructured once more): the
    world transform and the corner gather run ONCE (view-independent), and
    each slot's clip corners are broadcast lane-FMAs over the shared world
    corners — no per-slot row gather at all.  The per-corner clip value is
    viewproj[s] @ world_h[v] in the same scalar FMA order as
    scene_setup_slots' crow(), so results stay bit-identical to the
    per-slot scene_setup path (which computes the identical contraction via
    the world_h @ viewproj.T matmul: f32 row-times-column either way)."""
    s = viewprojs.shape[0]
    t = indices.shape[0]
    world_h = vertex_stage_world(positions, vtx_obj, models)
    wc = world_h[indices]                         # (T, 3, 4) gathered ONCE
    wx, wy, wz, ww = (wc[..., 0][None], wc[..., 1][None],
                      wc[..., 2][None], wc[..., 3][None])

    def crow(r):
        return (viewprojs[:, None, None, r, 0] * wx
                + viewprojs[:, None, None, r, 1] * wy
                + viewprojs[:, None, None, r, 2] * wz
                + viewprojs[:, None, None, r, 3] * ww)

    tri_clip = jnp.stack([crow(0), crow(1), crow(2), crow(3)],
                         axis=-1).reshape(s * t, 3, 4)
    from lsr_tpu.raster.clip import clip_triangles_near

    clip2, _, valid2 = clip_triangles_near({}, tri_clip)
    obj2 = jnp.broadcast_to(tri_obj[None, :, None], (s, t, 2)).reshape(-1)
    valid = valid2.reshape(-1)
    if obj_visible_slots is not None:
        o = obj_visible_slots.shape[1]
        slot_of = jnp.repeat(jnp.arange(s, dtype=jnp.int32), 2 * t)
        valid = valid & obj_visible_slots.reshape(-1)[slot_of * o + obj2]
    setup = build_setup(
        clip2.reshape(2 * s * t, 3, 4), {}, valid, obj2, size, size,
        cull_mode, front_face_ccw,
    )
    import dataclasses as _dc

    def unflat(x):
        return x.reshape((s, 2 * t) + x.shape[1:])

    return TriSetup(**{
        f.name: unflat(getattr(setup, f.name))
        for f in _dc.fields(TriSetup)
    })


def scene_setup_slots(
    positions,
    normals,
    uvs,
    indices,
    vtx_obj,
    tri_obj,
    models,
    normal_mats,
    viewprojs,
    size: int,
    cull_mode: int = CULL_NONE,
    front_face_ccw: bool = True,
    obj_visible_slots=None,
) -> TriSetup:
    """Multi-view geometry front-end: one setup per shadow-atlas slot.

    viewprojs: (S, 4, 4); obj_visible_slots: optional (S, O) per-slot object
    masks.  Returns a TriSetup whose fields carry a leading (S,) slot dim.

    Equivalent to vmapping scene_setup over slots but restructured:
    the world transform and per-corner attribute gather run ONCE (they are
    view-independent), per-slot clip positions come from one flat offset row
    gather (vmapped gathers lower to slow batched-gather HLO), and the
    clip + edge-setup stages run on flattened (S*T) triangle rows."""
    s = viewprojs.shape[0]
    t = indices.shape[0]
    v = positions.shape[0]
    world, _, n_ws = vertex_stage(
        positions, normals, uvs, vtx_obj, models, normal_mats,
        jnp.eye(4, dtype=jnp.float32),
    )
    # Per-slot clip transform as explicit FMAs over (S, V) planes (one
    # fused elementwise pass, as in vertex_stage) instead of an
    # ("vc,src->svr") einsum of K=4 batched matmuls.
    wx, wy, wz = world[:, 0][None], world[:, 1][None], world[:, 2][None]

    def crow(r):
        return (viewprojs[:, None, r, 0] * wx
                + viewprojs[:, None, r, 1] * wy
                + viewprojs[:, None, r, 2] * wz
                + viewprojs[:, None, r, 3])

    clip_slots = jnp.stack([crow(0), crow(1), crow(2), crow(3)],
                           axis=-1)                             # (S, V, 4)

    # View-independent per-corner record, gathered once and tiled.
    vrec = jnp.concatenate([world, n_ws, uvs], axis=-1)
    crec = vrec[indices]                                   # (T, 3, 8)
    attrs_flat = jnp.broadcast_to(crec[None], (s, t, 3, 8)) \
        .reshape(s * t, 3, 8)
    attrs = {
        "wp": attrs_flat[..., 0:3],
        "normal": attrs_flat[..., 3:6],
        "uv": attrs_flat[..., 6:8],
    }
    # Per-slot clip corners: ONE flat row gather with slot offsets.
    from lsr_tpu.core.gather import take_rows

    rows = (jnp.arange(s, dtype=jnp.int32)[:, None, None] * v
            + indices[None])                               # (S, T, 3)
    tri_clip = take_rows(clip_slots.reshape(s * v, 4), rows) \
        .reshape(s * t, 3, 4)

    from lsr_tpu.raster.clip import clip_triangles_near

    clip2, attrs2, valid2 = clip_triangles_near(attrs, tri_clip)
    flat = lambda x: x.reshape((2 * s * t,) + x.shape[2:])  # noqa: E731
    obj2 = jnp.broadcast_to(tri_obj[None, :, None],
                            (s, t, 2)).reshape(-1)
    valid = valid2.reshape(-1)
    if obj_visible_slots is not None:
        o = obj_visible_slots.shape[1]
        slot_of = jnp.repeat(jnp.arange(s, dtype=jnp.int32), 2 * t)
        valid = valid & obj_visible_slots.reshape(-1)[slot_of * o + obj2]
    setup = build_setup(
        flat(clip2), {k: flat(v2) for k, v2 in attrs2.items()},
        valid, obj2, size, size, cull_mode, front_face_ccw,
    )
    import dataclasses as _dc

    def unflat(x):
        return x.reshape((s, 2 * t) + x.shape[1:])

    return TriSetup(**{
        f.name: unflat(getattr(setup, f.name))
        for f in _dc.fields(TriSetup)
    })


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["n_direct", "n_clip", "overflow"],
    meta_fields=["cap_direct", "cap_clip"],
)
@dataclasses.dataclass(frozen=True)
class CompactStats:
    """Occupancy/overflow counters of scene_setup_compact (the same
    monitoring contract as the raster bin caps: an overflow means dropped
    triangles and must be surfaced, bench_highpoly checks it)."""

    n_direct: jnp.ndarray   # () i32 surviving unclipped triangles
    n_clip: jnp.ndarray     # () i32 surviving near-clipping triangles
    overflow: jnp.ndarray   # () bool: either cap exceeded
    cap_direct: int = 0
    cap_clip: int = 0


def scene_setup_compact(
    positions,
    normals,
    uvs,
    indices,
    vtx_obj,
    tri_obj,
    models,
    normal_mats,
    viewproj,
    width: int,
    height: int,
    cull_mode: int = CULL_BACK,
    front_face_ccw: bool = True,
    obj_visible=None,
    cap_fraction: float = 0.62,
    clip_cap: int = 8192,
):
    """High-density geometry front-end: cull + COMPACT before the wide work.

    scene_setup pushes 2*T rows through the 12-wide corner gather, the
    clip case tables, and build_setup even though typically ~half the
    triangles are backfacing/off-screen and near-clipping is rare — the
    reference's density-switch intent (rasterizer.hpp:37-39) applied to
    the geometry front-end instead of the raster.  Structure:

    1. cheap stage: clip corners only (4-wide gather) -> the EXACT
       validity predicate of build_setup for unclipped triangles (same
       f32 expressions on the same rotated corner order, so decisions
       agree bit-for-bit; no conservatism needed),
    2. stable-order compaction of survivors to cap_direct = T *
       cap_fraction rows (argsort over the keep mask keeps original
       first-wins order among survivors),
    3. the 12-wide gather + build_setup run on survivors only; the rare
       near-plane-crossing triangles take a clip_cap-row side path
       through the exact clip case tables.

    Output rows are [direct survivors (original order), clipped pairs]:
    identical raster coverage/depth/attributes to scene_setup — the only
    deviation is z-tie ORDER between a clipped and an unclipped triangle
    (the documented first-wins tie class; tests pin tie-free scenes
    bit-exact).  Returns (TriSetup, CompactStats); an overflow means
    dropped triangles (callers fall back to scene_setup, same contract as
    raster bin-cap overflow monitoring)."""
    t = indices.shape[0]
    cap_d = min(t, -(-int(t * cap_fraction) // 128) * 128)
    cap_c = min(t, clip_cap)
    world, clip_v, n_ws = vertex_stage(
        positions, normals, uvs, vtx_obj, models, normal_mats, viewproj
    )
    from lsr_tpu.core.gather import take_rows

    tri_clip = take_rows(clip_v, indices)          # (T, 3, 4)
    d = tri_clip[..., 2] + tri_clip[..., 3]        # (T, 3) near-plane dist
    inside = d >= 0.0
    n_in = inside.sum(-1)
    all_in = n_in == 3
    needs_clip = (n_in > 0) & ~all_in

    # Exact build_setup validity for all-inside triangles, computed on the
    # ROTATED corner order (case-111 emits [v1, v2, v0], clip.py:45) so
    # every f32 expression sees the same operands in the same order as the
    # full path's build_setup.
    rot = tri_clip[:, (1, 2, 0)]
    w_clip = rot[..., 3]
    w_ok = jnp.all(w_clip > 1e-8, axis=-1)
    iw = jnp.where(w_clip > 1e-8, 1.0 / jnp.maximum(w_clip, 1e-8), 0.0)
    ndc = rot[..., :3] * iw[..., None]
    finite = jnp.all(jnp.isfinite(ndc), axis=(1, 2))
    sx = (ndc[..., 0] * 0.5 + 0.5) * (width - 1)
    sy = (ndc[..., 1] * 0.5 + 0.5) * (height - 1)
    e0x, e0y = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
    e1x, e1y = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
    area2 = e0x * e1y - e0y * e1x
    nondegenerate = jnp.abs(area2) >= 1e-10
    is_front = (area2 > 0.0) == front_face_ccw
    if cull_mode == CULL_BACK:
        face_ok = is_front
    elif cull_mode == CULL_FRONT:
        face_ok = ~is_front
    else:
        face_ok = jnp.ones_like(is_front)
    on_screen = (
        (jnp.max(sx, axis=1) >= 0.0)
        & (jnp.min(sx, axis=1) <= width - 1)
        & (jnp.max(sy, axis=1) >= 0.0)
        & (jnp.min(sy, axis=1) <= height - 1)
    )
    keep_direct = all_in & w_ok & finite & nondegenerate & face_ok & on_screen
    keep_clip = needs_clip
    if obj_visible is not None:
        vis = obj_visible[tri_obj]
        keep_direct = keep_direct & vis
        keep_clip = keep_clip & vis

    n_direct = keep_direct.sum().astype(jnp.int32)
    n_clip = keep_clip.sum().astype(jnp.int32)
    order_d = jnp.argsort(~keep_direct, stable=True)[:cap_d]  # (cap_d,)
    order_c = jnp.argsort(~keep_clip, stable=True)[:cap_c]
    row_d_ok = jnp.arange(cap_d, dtype=jnp.int32) < n_direct
    row_c_ok = jnp.arange(cap_c, dtype=jnp.int32) < n_clip

    # Wide work on survivors only.  Direct rows reproduce assemble's packed
    # record semantics on the rotated corners; the clip path's 'normal'
    # renormalization (clip.py:130-132) applies to pass-through corners
    # too, so renormalize here for bit-identity with the full path.
    vrec = jnp.concatenate([clip_v, world, n_ws, uvs], axis=-1)  # (V, 12)
    idx_d = take_rows(indices, order_d)[:, (1, 2, 0)]            # (D, 3)
    crec = take_rows(vrec, idx_d)                                # (D, 3, 12)
    nrm_d = crec[..., 7:10]
    nlen = jnp.linalg.norm(nrm_d, axis=-1, keepdims=True)
    attrs_d = {
        "wp": crec[..., 4:7],
        "normal": nrm_d / jnp.maximum(nlen, 1e-12),
        "uv": crec[..., 10:12],
    }
    clip_d = crec[..., 0:4]
    obj_d = take_rows(tri_obj, order_d)

    from lsr_tpu.raster.clip import clip_triangles_near

    idx_c = take_rows(indices, order_c)                          # (C, 3)
    crec_c = take_rows(vrec, idx_c)
    clip2, attrs2, valid2 = clip_triangles_near(
        {
            "wp": crec_c[..., 4:7],
            "normal": crec_c[..., 7:10],
            "uv": crec_c[..., 10:12],
        },
        crec_c[..., 0:4],
    )
    flat_c = lambda x: x.reshape((2 * cap_c,) + x.shape[2:])  # noqa: E731
    obj_c = jnp.broadcast_to(
        take_rows(tri_obj, order_c)[:, None], (cap_c, 2)).reshape(-1)
    valid_c = valid2.reshape(-1) & jnp.repeat(row_c_ok, 2)

    clip_all = jnp.concatenate([clip_d, flat_c(clip2)], axis=0)
    attrs_all = {
        k: jnp.concatenate([attrs_d[k], flat_c(attrs2[k])], axis=0)
        for k in attrs_d
    }
    valid_all = jnp.concatenate([row_d_ok, valid_c], axis=0)
    obj_all = jnp.concatenate([obj_d, obj_c], axis=0)
    setup = build_setup(
        clip_all, attrs_all, valid_all, obj_all, width, height,
        cull_mode, front_face_ccw,
    )
    stats = CompactStats(
        n_direct=n_direct,
        n_clip=n_clip,
        overflow=(n_direct > cap_d) | (n_clip > cap_c),
        cap_direct=cap_d,
        cap_clip=cap_c,
    )
    return setup, stats


def scene_setup(
    positions,
    normals,
    uvs,
    indices,
    vtx_obj,
    tri_obj,
    models,
    normal_mats,
    viewproj,
    width: int,
    height: int,
    cull_mode: int = CULL_BACK,
    front_face_ccw: bool = True,
    obj_visible=None,
) -> TriSetup:
    """Full geometry front-end: vertex stage + clip + setup, jit-friendly.

    obj_visible: optional (O,) bool mask (frustum/occlusion culling output)
    folded into triangle validity — the array form of per-item culling.
    """
    world, clip_v, n_ws = vertex_stage(
        positions, normals, uvs, vtx_obj, models, normal_mats, viewproj
    )
    clip_t, attrs, valid, obj2 = assemble_and_clip(
        clip_v, world, n_ws, uvs, indices, tri_obj
    )
    if obj_visible is not None:
        valid = valid & obj_visible[obj2]
    return build_setup(
        clip_t, attrs, valid, obj2, width, height, cull_mode, front_face_ccw
    )
