"""Analytic culling volumes + frustum tests (vectorized SoA).

The JAX re-expression of geometry/volumes.hpp:25-129 and
frustum_culling.hpp:48-84: volumes live as batched arrays and every test is
an elementwise masked computation — culling produces visibility MASKS, not
compacted lists (static shapes; the rasterizer consumes masks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def extract_frustum_planes(viewproj):
    """Six frustum planes (nx,ny,nz,d) with inward-positive half-spaces.

    Gribb-Hartmann extraction for row-major clip = M @ [p,1], NDC in
    [-1,1]^3: plane_i . [p,1] >= 0 inside.
    Order: left, right, bottom, top, near, far.
    """
    m = viewproj
    rows = [
        m[3] + m[0],
        m[3] - m[0],
        m[3] + m[1],
        m[3] - m[1],
        m[3] + m[2],
        m[3] - m[2],
    ]
    planes = jnp.stack(rows)  # (6, 4)
    n = jnp.linalg.norm(planes[:, :3], axis=-1, keepdims=True)
    return planes / jnp.maximum(n, 1e-12)


def sphere_outside_planes(planes, centers, radii):
    """(B,) True where the sphere is fully outside any plane
    (frustum_culling.hpp sphere test)."""
    d = centers @ planes[:, :3].T + planes[None, :, 3]  # (B, 6)
    return jnp.any(d < -radii[:, None], axis=-1)


def aabb_outside_planes(planes, mins, maxs):
    """(B,) conservative AABB-vs-frustum: outside if the positive vertex of
    any plane is behind it (frustum_culling.hpp AABB test)."""
    pos = jnp.where(planes[None, :, :3] >= 0.0, maxs[:, None, :], mins[:, None, :])
    d = jnp.sum(pos * planes[None, :, :3], axis=-1) + planes[None, :, 3]
    return jnp.any(d < 0.0, axis=-1)


def transform_aabb(model, mins, maxs):
    """World AABB of a transformed local AABB (B per-object, model (B,4,4)).

    Uses the |R| trick: extent' = |M3| @ extent; center' = M @ center.
    """
    center = (mins + maxs) * 0.5
    extent = (maxs - mins) * 0.5
    c_h = jnp.concatenate([center, jnp.ones_like(center[..., :1])], -1)
    hi = jax.lax.Precision.HIGHEST  # culling must stay conservative
    c_w = jnp.einsum("bij,bj->bi", model, c_h, precision=hi)[..., :3]
    e_w = jnp.einsum("bij,bj->bi", jnp.abs(model[..., :3, :3]), extent,
                     precision=hi)
    return c_w - e_w, c_w + e_w


def frustum_cull_objects(viewproj, world_mins, world_maxs):
    """Visibility mask (True = visible) for object world AABBs."""
    planes = extract_frustum_planes(viewproj)
    return ~aabb_outside_planes(planes, world_mins, world_maxs)


def mesh_local_aabb(positions):
    """Host/device: local-space AABB of a vertex array."""
    return positions.min(axis=0), positions.max(axis=0)


def merge_aabbs(mins, maxs, mask=None):
    """Scene AABB from per-object AABBs, with optional inclusion mask."""
    if mask is not None:
        big = jnp.float32(1e30)
        mins = jnp.where(mask[:, None], mins, big)
        maxs = jnp.where(mask[:, None], maxs, -big)
    return mins.min(axis=0), maxs.max(axis=0)


# --- sphere/point distance helpers used by light culling -------------------

def point_aabb_distance_sq(points, mins, maxs):
    """Squared distance from points (B,3) to AABBs (B,3)/(B,3), broadcastable."""
    clamped = jnp.clip(points, mins, maxs)
    d = points - clamped
    return jnp.sum(d * d, axis=-1)


def update_visibility_history(history, visible_now, hold_frames: int = 4):
    """Visibility hysteresis (VisibilityHistory, culling_runtime.hpp:150):
    an object that becomes invisible stays renderable for `hold_frames`
    frames to suppress popping from conservative culling flicker.

    history: (B,) i32 frames-since-visible counters (init: hold_frames).
    Returns (new_history, effective_visible)."""
    new_hist = jnp.where(visible_now, 0, history + 1)
    return new_hist, new_hist <= hold_frames
