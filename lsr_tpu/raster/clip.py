"""Near-plane clipping with static shapes (static-shape Sutherland-Hodgman).

The reference clips each triangle against all six frustum planes with a
dynamic polygon + fan re-triangulation (rasterizer.hpp:154-161, :246-258).
XLA needs static shapes, so we restructure:

- Only the NEAR plane (z_clip + w >= 0) is clipped geometrically.  For the
  LH [-1,1]-NDC projections used here, near-clipping alone guarantees w >= 0
  for all surviving vertices.
- FAR rejection happens per-fragment: depth01 clamps to 1.0 and the z-test
  against the 1.0 clear value rejects it — observably identical to the
  reference's far clip (its z01 clamp + `z01 >= zbuf` skip does the same).
- LEFT/RIGHT/TOP/BOTTOM clipping is replaced by screen-space bbox clamping
  (scissor), which produces the same coverage because clipped vertices lie
  on the original triangle's plane and interpolation is perspective-correct.

A triangle vs one plane yields at most 4 vertices = at most 2 triangles, so
every input triangle maps to a static 2-slot output with validity masks.
The emission order matches the reference's clip walk exactly (including the
rotated [v1,v2,v0] order for fully-inside triangles), so fan splitting of
quads produces the same sub-triangles.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Generators: 0..2 = original vertices, 3 = lerp(v0,v1), 4 = lerp(v1,v2),
# 5 = lerp(v2,v0), 6 = padding.
_PAD = 6

# _CASE_SLOTS[case] = polygon as generator ids; case = in0 + 2*in1 + 4*in2.
# Derived by walking edges (v0->v1, v1->v2, v2->v0) with the reference's
# emission rule (clip_polygon_plane, rasterizer.hpp:110-151).
_CASE_SLOTS = np.array(
    [
        [_PAD, _PAD, _PAD, _PAD],  # 000: fully clipped
        [3, 5, 0, _PAD],           # 100: only v0 in
        [3, 1, 4, _PAD],           # 010: only v1 in
        [1, 4, 5, 0],              # 110: v0,v1 in
        [4, 2, 5, _PAD],           # 001: only v2 in
        [3, 4, 2, 0],              # 101: v0,v2 in
        [3, 1, 2, 5],              # 011: v1,v2 in
        [1, 2, 0, _PAD],           # 111: fully inside (rotated emission)
    ],
    np.int32,
)
_CASE_COUNT = np.array([0, 3, 3, 4, 3, 4, 4, 3], np.int32)


def clip_triangles_near(corner_attrs: dict, clip: jnp.ndarray):
    """Clip triangles against the near plane with static 2x expansion.

    corner_attrs: dict of per-corner attribute arrays, each (T, 3, A...).
                  Must include none/any of the shading attributes; 'normal'
                  (if present) is re-normalized after interpolation, matching
                  lerp_rv (rasterizer.hpp:68-78).
    clip: (T, 3, 4) clip-space positions.

    Returns (clip2, attrs2, valid2): clip2 (T, 2, 3, 4); each attr (T, 2, 3, A);
    valid2 (T, 2) bool.  Slot 0 = fan tri (p0,p1,p2), slot 1 = (p0,p2,p3).
    """
    d = clip[..., 2] + clip[..., 3]  # (T, 3) signed distance to near plane
    inside = d >= 0.0
    case = (
        inside[:, 0].astype(jnp.int32)
        + 2 * inside[:, 1].astype(jnp.int32)
        + 4 * inside[:, 2].astype(jnp.int32)
    )  # (T,)

    # Edge interpolation params t = d_cur / (d_cur - d_nxt), guarded like the
    # reference (denominator |.| > 1e-8, rasterizer.hpp:131-148).
    def edge_t(a, b):
        den = d[:, a] - d[:, b]
        den = jnp.where(jnp.abs(den) > 1e-8, den, 1.0)
        return jnp.clip(d[:, a] / den, 0.0, 1.0)

    t01 = edge_t(0, 1)
    t12 = edge_t(1, 2)
    t20 = edge_t(2, 0)

    def lerp(x, a, b, t):
        ta = x[:, a]
        tb = x[:, b]
        tt = t.reshape(t.shape + (1,) * (ta.ndim - 1))
        return ta + (tb - ta) * tt

    def generators(x):
        """(T, 3, A...) -> (T, 7, A...): v0,v1,v2,e01,e12,e20,pad."""
        return jnp.stack(
            [
                x[:, 0],
                x[:, 1],
                x[:, 2],
                lerp(x, 0, 1, t01),
                lerp(x, 1, 2, t12),
                lerp(x, 2, 0, t20),
                jnp.zeros_like(x[:, 0]),
            ],
            axis=1,
        )

    slots = jnp.asarray(_CASE_SLOTS)[case]  # (T, 4)
    counts = jnp.asarray(_CASE_COUNT)[case]  # (T,)

    # ONE combined per-corner record, emitted with ONE flattened row gather:
    # take_along_axis over the generator axis lowers to element-wise
    # gathers; a (T*7, C)-row gather with wide records is cheaper, and doing
    # it once for clip+attrs instead of per-array amortizes the row overhead
    # further.
    keys = list(corner_attrs.keys())
    widths = [corner_attrs[k].shape[-1] for k in keys]
    combined = jnp.concatenate([clip] + [corner_attrs[k] for k in keys], -1)
    t = clip.shape[0]
    c_width = combined.shape[-1]
    gen = generators(combined).reshape(t * 7, c_width)
    rows = jnp.arange(t, dtype=jnp.int32)[:, None] * 7 + slots  # (T, 4)
    poly = gen[rows]  # (T, 4, C)
    tri0 = poly[:, (0, 1, 2)]
    tri1 = poly[:, (0, 2, 3)]
    emitted = jnp.stack([tri0, tri1], axis=1)  # (T, 2, 3, C)

    clip2 = emitted[..., :4]
    attrs2 = {}
    off = 4
    for k, width in zip(keys, widths):
        out = emitted[..., off:off + width]
        off += width
        if k == "normal":
            n = jnp.linalg.norm(out, axis=-1, keepdims=True)
            out = out / jnp.maximum(n, 1e-12)
        attrs2[k] = out

    valid2 = jnp.stack([counts >= 3, counts >= 4], axis=1)
    return clip2, attrs2, valid2
