"""Vectorized Bresenham line rasterization.

The reference draws lines with the all-octant Bresenham loop
(shs_renderer.hpp:808-822, Canvas::draw_line).  That loop is inherently
sequential; we use its exact closed form instead: with
n = max(|dx|, |dy|) steps, the pixel at step t is

    x(t) = x0 + sx * floor((2 t |dx| + n) / (2 n))
    y(t) = y0 + sy * floor((2 t |dy| + n) / (2 n))

which reproduces the reference loop pixel-for-pixel (verified exhaustively
against a direct simulation), while being a pure data-parallel map over
(line, step) that XLA vectorizes.
"""

from __future__ import annotations

import jax.numpy as jnp


def line_points(p0, p1, max_steps: int):
    """Expand integer line segments into per-step pixel coordinates.

    p0, p1: (L, 2) int32 endpoints (x, y).
    Returns (x, y, valid): each (L, max_steps); steps beyond a line's length
    are marked invalid.  max_steps must be >= max(|dx|, |dy|) + 1.
    """
    p0 = jnp.asarray(p0, jnp.int32)
    p1 = jnp.asarray(p1, jnp.int32)
    d = p1 - p0
    adx = jnp.abs(d[:, 0])
    ady = jnp.abs(d[:, 1])
    sx = jnp.where(d[:, 0] >= 0, 1, -1)
    sy = jnp.where(d[:, 1] >= 0, 1, -1)
    n = jnp.maximum(adx, ady)
    n_safe = jnp.maximum(n, 1)

    t = jnp.arange(max_steps, dtype=jnp.int32)[None, :]  # (1, S)
    xa = (2 * t * adx[:, None] + n_safe[:, None]) // (2 * n_safe[:, None])
    ya = (2 * t * ady[:, None] + n_safe[:, None]) // (2 * n_safe[:, None])
    x = p0[:, 0:1] + sx[:, None] * xa
    y = p0[:, 1:2] + sy[:, None] * ya
    valid = t <= n[:, None]
    return x, y, valid


def rasterize_lines(canvas_u8, p0, p1, color, max_steps: int | None = None):
    """Draw integer line segments onto a (H, W, 3) u8 canvas (bottom-left origin).

    color: (3,) or (L, 3) u8.  Out-of-bounds pixels are dropped (the reference's
    draw_pixel bounds check, shs_renderer.hpp:713-716).
    """
    h, w = canvas_u8.shape[0], canvas_u8.shape[1]
    if max_steps is None:
        max_steps = w + h
    x, y, valid = line_points(p0, p1, max_steps)
    color = jnp.asarray(color, jnp.uint8)
    if color.ndim == 1:
        color = jnp.broadcast_to(color, (x.shape[0], 3))
    colors = jnp.broadcast_to(color[:, None, :], x.shape + (3,)).reshape(-1, 3)

    # Invalid steps and negative coords -> huge positive coordinate -> dropped
    # by mode="drop".  (Negative indices would WRAP under jax .at[] indexing.)
    keep = valid & (x >= 0) & (y >= 0)
    oob = jnp.int32(2**30)
    xf = jnp.where(keep, x, oob).reshape(-1)
    yf = jnp.where(keep, y, oob).reshape(-1)
    return canvas_u8.at[yf, xf].set(colors, mode="drop")


def rasterize_lines_f32(buf, p0, p1, value, max_steps: int | None = None):
    """Same as rasterize_lines but for float (H, W, C) buffers (debug overlays)."""
    h, w = buf.shape[0], buf.shape[1]
    if max_steps is None:
        max_steps = w + h
    x, y, valid = line_points(p0, p1, max_steps)
    value = jnp.asarray(value, buf.dtype)
    if value.ndim == 1:
        value = jnp.broadcast_to(value, (x.shape[0], value.shape[-1]))
    vals = jnp.broadcast_to(value[:, None, :], x.shape + (value.shape[-1],))
    keep = valid & (x >= 0) & (y >= 0)
    oob = jnp.int32(2**30)
    xf = jnp.where(keep, x, oob).reshape(-1)
    yf = jnp.where(keep, y, oob).reshape(-1)
    return buf.at[yf, xf].set(vals.reshape(-1, vals.shape[-1]), mode="drop")
