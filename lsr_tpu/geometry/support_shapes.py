"""Analytic culling volumes as batched support functions.

The JAX re-expression of the reference's volume library + SAT-style
classification (geometry/volumes.hpp:25-129 Sphere/OBB/Capsule/Cone/
Cylinder/ConeFrustum/ConvexPolyhedron; geometry/culling_query.hpp:61-151
`support_max_dot` overloads; :152 `classify_support_shape`).

Where the reference dispatches on a std::variant per shape, the array build
packs every shape into ONE fixed-width SoA record and evaluates all kinds
branchlessly — a (B, 24) array of shapes classifies against a convex cell
in a handful of vectorized ops, so thousands of shape-vs-cell queries (light
binning, scene-vs-cluster culling) are one fused elementwise program.

Record layout (B, 24) f32:
  [0]     kind
  [1:4]   p0   (center | apex | capsule endpoint a | aabb min)
  [4:7]   p1   (capsule endpoint b | aabb max)
  [7:10]  ax   (primary axis: cone/cylinder axis, obb axis_x)
  [10:13] ay   (obb axis_y)
  [13:16] az   (obb axis_z)
  [16:19] he   (obb half extents)
  [19]    r    (sphere/capsule/cone/cylinder radius)
  [20]    d0   (cone height | cone-frustum near distance)
  [21]    d1   (cylinder half height | cone-frustum far distance)
  [22]    r0   (cone-frustum near radius)
  [23]    r1   (cone-frustum far radius)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

KIND_SPHERE = 0.0
KIND_AABB = 1.0
KIND_OBB = 2.0
KIND_CAPSULE = 3.0
KIND_CONE = 4.0
KIND_CYLINDER = 5.0
KIND_CONE_FRUSTUM = 6.0

REC_WIDTH = 24

# CullClass (culling_query.hpp:22)
CULL_OUTSIDE = 0
CULL_INTERSECTING = 1
CULL_INSIDE = 2


def _zeros(b):
    return jnp.zeros((b, REC_WIDTH), jnp.float32)


def _put(rec, col, val):
    val = jnp.asarray(val, jnp.float32)
    if val.ndim == 1 and isinstance(col, int):
        return rec.at[:, col].set(val)
    return rec.at[:, col].set(val)


def make_spheres(centers, radii):
    """(B,3), (B,) -> records."""
    centers = jnp.asarray(centers, jnp.float32)
    b = centers.shape[0]
    rec = _zeros(b)
    rec = rec.at[:, 0].set(KIND_SPHERE)
    rec = rec.at[:, 1:4].set(centers)
    rec = rec.at[:, 19].set(jnp.asarray(radii, jnp.float32))
    return rec


def make_aabbs(mins, maxs):
    mins = jnp.asarray(mins, jnp.float32)
    rec = _zeros(mins.shape[0])
    rec = rec.at[:, 0].set(KIND_AABB)
    rec = rec.at[:, 1:4].set(mins)
    rec = rec.at[:, 4:7].set(jnp.asarray(maxs, jnp.float32))
    return rec


def make_obbs(centers, axis_x, axis_y, axis_z, half_extents):
    centers = jnp.asarray(centers, jnp.float32)
    rec = _zeros(centers.shape[0])
    rec = rec.at[:, 0].set(KIND_OBB)
    rec = rec.at[:, 1:4].set(centers)
    rec = rec.at[:, 7:10].set(jnp.asarray(axis_x, jnp.float32))
    rec = rec.at[:, 10:13].set(jnp.asarray(axis_y, jnp.float32))
    rec = rec.at[:, 13:16].set(jnp.asarray(axis_z, jnp.float32))
    rec = rec.at[:, 16:19].set(jnp.asarray(half_extents, jnp.float32))
    return rec


def make_capsules(a, b, radii):
    a = jnp.asarray(a, jnp.float32)
    rec = _zeros(a.shape[0])
    rec = rec.at[:, 0].set(KIND_CAPSULE)
    rec = rec.at[:, 1:4].set(a)
    rec = rec.at[:, 4:7].set(jnp.asarray(b, jnp.float32))
    rec = rec.at[:, 19].set(jnp.asarray(radii, jnp.float32))
    return rec


def make_cones(apexes, axes, heights, radii):
    """axis: normalized apex -> base (volumes.hpp Cone)."""
    apexes = jnp.asarray(apexes, jnp.float32)
    rec = _zeros(apexes.shape[0])
    rec = rec.at[:, 0].set(KIND_CONE)
    rec = rec.at[:, 1:4].set(apexes)
    rec = rec.at[:, 7:10].set(jnp.asarray(axes, jnp.float32))
    rec = rec.at[:, 19].set(jnp.asarray(radii, jnp.float32))
    rec = rec.at[:, 20].set(jnp.asarray(heights, jnp.float32))
    return rec


def make_cylinders(centers, axes, half_heights, radii):
    centers = jnp.asarray(centers, jnp.float32)
    rec = _zeros(centers.shape[0])
    rec = rec.at[:, 0].set(KIND_CYLINDER)
    rec = rec.at[:, 1:4].set(centers)
    rec = rec.at[:, 7:10].set(jnp.asarray(axes, jnp.float32))
    rec = rec.at[:, 19].set(jnp.asarray(radii, jnp.float32))
    rec = rec.at[:, 21].set(jnp.asarray(half_heights, jnp.float32))
    return rec


def make_cone_frustums(apexes, axes, near_d, far_d, near_r, far_r):
    apexes = jnp.asarray(apexes, jnp.float32)
    rec = _zeros(apexes.shape[0])
    rec = rec.at[:, 0].set(KIND_CONE_FRUSTUM)
    rec = rec.at[:, 1:4].set(apexes)
    rec = rec.at[:, 7:10].set(jnp.asarray(axes, jnp.float32))
    rec = rec.at[:, 20].set(jnp.asarray(near_d, jnp.float32))
    rec = rec.at[:, 21].set(jnp.asarray(far_d, jnp.float32))
    rec = rec.at[:, 22].set(jnp.asarray(near_r, jnp.float32))
    rec = rec.at[:, 23].set(jnp.asarray(far_r, jnp.float32))
    return rec


def transform_shapes(rec, rot, trans):
    """Rigidly transform shape records (rot (3,3), trans (3,)) — e.g. into
    view space for tile culling.  Points transform affinely, axes rotate,
    extents/radii are invariant (rigid motion)."""
    def pt(x):
        return x @ rot.T + trans[None, :]

    def vec(x):
        return x @ rot.T

    out = rec
    out = out.at[:, 1:4].set(pt(rec[:, 1:4]))
    out = out.at[:, 4:7].set(pt(rec[:, 4:7]))
    for c in (7, 10, 13):
        out = out.at[:, c:c + 3].set(vec(rec[:, c:c + 3]))
    # AABBs do not stay axis-aligned under rotation: promote to OBB with
    # the rotated unit axes and the box half-extents.
    is_aabb = rec[:, 0] == KIND_AABB
    center = (rec[:, 1:4] + rec[:, 4:7]) * 0.5
    he = (rec[:, 4:7] - rec[:, 1:4]) * 0.5
    obb = make_obbs(pt(center),
                    jnp.broadcast_to(rot[:, 0][None], he.shape),
                    jnp.broadcast_to(rot[:, 1][None], he.shape),
                    jnp.broadcast_to(rot[:, 2][None], he.shape), he)
    return jnp.where(is_aabb[:, None], obb, out)


def support_max_dot(rec, dirs):
    """max_{x in shape} dot(dir, x) for every (shape, dir) pair.

    rec: (B, 24) shape records; dirs: (P, 3) — NOT necessarily unit length
    (the reference's overloads scale radii by |dir|, culling_query.hpp:61).
    Returns (B, P).
    """
    d = jnp.asarray(dirs, jnp.float32)                     # (P, 3)
    dlen = jnp.linalg.norm(d, axis=-1)                     # (P,)
    kind = rec[:, 0:1]                                     # (B, 1)

    p0d = rec[:, 1:4] @ d.T                                # (B, P)
    p1d = rec[:, 4:7] @ d.T
    axd = rec[:, 7:10] @ d.T
    ayd = rec[:, 10:13] @ d.T
    azd = rec[:, 13:16] @ d.T
    r = rec[:, 19:20]

    sphere = p0d + r * dlen[None, :]

    # AABB: per-component positive vertex.
    pos = jnp.where(d.T[None, :, :] >= 0.0,                # (B, 3, P)
                    rec[:, 4:7, None], rec[:, 1:4, None])
    aabb = jnp.sum(pos * d.T[None, :, :], axis=1)

    obb = (p0d + rec[:, 16:17] * jnp.abs(axd)
           + rec[:, 17:18] * jnp.abs(ayd)
           + rec[:, 18:19] * jnp.abs(azd))

    capsule = jnp.maximum(p0d, p1d) + r * dlen[None, :]

    # Cone: max(apex, base disk).  perp = dir - axis * dot(dir, axis).
    perp_sq = jnp.maximum(dlen[None, :] ** 2 - axd * axd, 0.0)
    perp_len = jnp.sqrt(perp_sq)
    base = p0d + rec[:, 20:21] * axd
    cone = jnp.maximum(p0d, base + r * perp_len)

    cylinder = p0d + rec[:, 21:22] * jnp.abs(axd) + r * perp_len

    near_s = p0d + rec[:, 20:21] * axd + rec[:, 22:23] * perp_len
    far_s = p0d + rec[:, 21:22] * axd + rec[:, 23:24] * perp_len
    cone_frustum = jnp.maximum(near_s, far_s)

    return jnp.where(
        kind == KIND_SPHERE, sphere,
        jnp.where(kind == KIND_AABB, aabb,
                  jnp.where(kind == KIND_OBB, obb,
                            jnp.where(kind == KIND_CAPSULE, capsule,
                                      jnp.where(kind == KIND_CONE, cone,
                                                jnp.where(kind == KIND_CYLINDER,
                                                          cylinder,
                                                          cone_frustum))))))


def classify_support_shapes(rec, planes, outside_eps=1e-5, inside_eps=1e-5):
    """CullClass per shape vs ONE convex cell (classify_support_shape,
    culling_query.hpp:152-173).

    planes: (P, 4) rows (nx, ny, nz, d) with inside = dot(n, x) + d >= 0.
    Returns (B,) i32 in {CULL_OUTSIDE, CULL_INTERSECTING, CULL_INSIDE}.
    """
    n = planes[:, :3]
    dd = planes[:, 3][None, :]
    max_d = support_max_dot(rec, n) + dd                   # (B, P)
    min_d = -support_max_dot(rec, -n) + dd
    outside = jnp.any(max_d < -outside_eps, axis=1)
    fully_inside = jnp.all(min_d >= inside_eps, axis=1)
    return jnp.where(outside, CULL_OUTSIDE,
                     jnp.where(fully_inside, CULL_INSIDE,
                               CULL_INTERSECTING)).astype(jnp.int32)


def classify_convex_vertices(verts, planes, outside_eps=1e-5,
                             inside_eps=1e-5):
    """Vertex-cloud classification (classify_convex_vertices,
    culling_query.hpp:35-59).  verts: (B, V, 3) convex hull vertices
    (pad with repeats); planes: (P, 4).  Returns (B,) i32 CullClass."""
    d = jnp.einsum("bvc,pc->bvp", verts, planes[:, :3],
                   precision=jax.lax.Precision.HIGHEST) + planes[:, 3]
    any_inside = jnp.any(d >= -outside_eps, axis=1)        # (B, P)
    all_inside = jnp.all(d >= inside_eps, axis=1)
    outside = jnp.any(~any_inside, axis=1)
    fully = jnp.all(all_inside, axis=1)
    return jnp.where(outside, CULL_OUTSIDE,
                     jnp.where(fully, CULL_INSIDE,
                               CULL_INTERSECTING)).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Per-light-type culling shapes (light_types.hpp:251-435 builders)
# ---------------------------------------------------------------------------

def light_culling_shapes(lights, spot_cones: bool = True):
    """(L, 24) support-shape records bounding each light's influence.

    - point: sphere(pos, range)                (point_light_culling_sphere)
    - spot:  cone(pos, dir, range, range*tan(outer)) — TIGHTER than the
      reference's sphere bound (spot_light_culling_sphere): the spot BRDF
      zeroes outside the outer cone AND beyond range, so the cone contains
      the full influence; set spot_cones=False for reference-exact spheres.
    - rect:  conservative one-sided OBB       (rect_area_light_culling_obb)
    - tube:  capsule(a, b, max(range, r))     (tube_area_light_culling_capsule)
    - directional/env-probe: huge sphere (never culled; binning excludes
      them separately).
    """
    from lsr_tpu.core.math3d import normalize
    from lsr_tpu.lighting.light_types import (
        LIGHT_POINT,
        LIGHT_RECT_AREA,
        LIGHT_SPOT,
        LIGHT_TUBE_AREA,
    )

    pos = lights.position
    rng = jnp.maximum(lights.range, 0.0)
    t = lights.type

    big = jnp.full_like(rng, 1e8)
    sphere_r = jnp.where((t == LIGHT_POINT) | (t == LIGHT_SPOT), rng, big)
    rec = make_spheres(pos, sphere_r)

    if spot_cones:
        d = normalize(lights.direction)
        # Clamp to the SAME constant the shaders use (shade_kernel.py /
        # light_runtime.py: pi/2 - 0.005) so the culling cone never shrinks
        # below the shading cone — binning must stay conservative.
        outer = jnp.clip(lights.outer_angle, 0.02, np.pi / 2 - 0.005)
        cone = make_cones(pos, d, rng, rng * jnp.tan(outer))
        rec = jnp.where((t == LIGHT_SPOT)[:, None], cone, rec)

    # Rect OBB (one-sided slab + spherical dilation, light_types.hpp:267).
    d = normalize(lights.direction)
    right0 = lights.axis - d * jnp.sum(lights.axis * d, -1, keepdims=True)
    right = normalize(jnp.where(
        jnp.linalg.norm(right0, axis=-1, keepdims=True) > 1e-5, right0,
        jnp.asarray([1.0, 0.0, 0.0])[None, :]))
    up = normalize(jnp.cross(d, right))
    right = normalize(jnp.cross(up, d))
    hx = jnp.maximum(lights.rect_half_extents[:, 0], 0.001)
    hy = jnp.maximum(lights.rect_half_extents[:, 1], 0.001)
    obb = make_obbs(
        pos + d * (rng * 0.5)[:, None], right, up, d,
        jnp.stack([hx + rng, hy + rng, jnp.maximum(rng * 0.5, 0.001)], -1))
    rec = jnp.where((t == LIGHT_RECT_AREA)[:, None], obb, rec)

    axis = normalize(lights.axis)
    hl = jnp.maximum(lights.tube_half_length, 0.001)[:, None]
    cap_r = jnp.maximum(rng, jnp.maximum(lights.tube_radius, 0.001))
    cap = make_capsules(pos - axis * hl, pos + axis * hl, cap_r)
    rec = jnp.where((t == LIGHT_TUBE_AREA)[:, None], cap, rec)
    return rec
