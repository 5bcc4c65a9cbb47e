"""Pure-XLA visibility rasterizer (no Pallas): the correctness anchor.

Evaluates triangle coverage over the full framebuffer in fixed-size triangle
chunks with a lax.scan, resolving the z-buffer by (min depth, first submitted)
exactly like the reference's sequential per-pixel test
(`if (z01 >= zbuf) continue` — first triangle wins ties, rasterizer.hpp:362-365).

Output is a *visibility buffer*: per-pixel depth01 and the winning triangle id
(-1 = background).  Attribute interpolation and shading happen in separate
fullscreen passes (raster/interp.py), which is the array-friendly split: the
rasterizer is bandwidth-lean, shading is a fused elementwise pass.

This path is O(T * W * H) and is used for tests, tiny offline renders, and as
a fallback; the production path is the tiled Pallas kernel (raster/tiled.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lsr_tpu.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ, TriSetup


def _pad_to_multiple(x, m, fill=0):
    n = x.shape[0]
    pad = (-n) % m
    if pad == 0:
        return x
    pad_block = jnp.full((pad,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([x, pad_block], axis=0)


@partial(jax.jit, static_argnames=("width", "height", "depth_mode", "chunk"))
def rasterize_brute(
    setup: TriSetup,
    width: int,
    height: int,
    zn,
    zf,
    depth_init=None,
    tid_init=None,
    depth_mode: int = DEPTH_VIEWZ,
    chunk: int = 64,
):
    """Rasterize all triangles in `setup`; returns (depth01 (H,W), tid (H,W))."""
    n = setup.coef.shape[0]
    coef = _pad_to_multiple(setup.coef, chunk)
    iw = _pad_to_multiple(setup.iw, chunk)
    ziw = _pad_to_multiple(setup.ziw, chunk)
    valid = _pad_to_multiple(setup.valid, chunk, fill=False)
    ids = _pad_to_multiple(jnp.arange(n, dtype=jnp.int32), chunk, fill=-1)

    n_chunks = coef.shape[0] // chunk
    resh = lambda x: x.reshape((n_chunks, chunk) + x.shape[1:])  # noqa: E731

    # Pixel centers (+0.5 sampling, rasterizer.hpp:336).
    px = (jnp.arange(width, dtype=jnp.float32) + 0.5)[None, :]   # (1, W)
    py = (jnp.arange(height, dtype=jnp.float32) + 0.5)[:, None]  # (H, 1)

    # NDC coverage mask: the reference clips geometry to screen coords
    # [0, W-1] x [0, H-1] (x/y frustum planes + (W-1,H-1) scale), so pixel
    # centers in the last row/column ((W-1)+0.5) can never be covered.  We
    # scissor instead of clipping, so we apply that bound as a mask.
    ndc_mask = (px <= (width - 1)) & (py <= (height - 1))        # (H, W)

    if depth_init is None:
        depth_init = jnp.ones((height, width), jnp.float32)
    if tid_init is None:
        tid_init = jnp.full((height, width), -1, jnp.int32)

    inv_range = 1.0 / jnp.maximum(zf - zn, 1e-6)

    def body(carry, xs):
        depth, tid = carry
        c, w_, z_, v_, id_ = xs  # (chunk, 9), (chunk,3), (chunk,3), (chunk,), (chunk,)
        # Barycentrics for all chunk triangles over all pixels: (chunk, H, W).
        def bc(i):
            return (
                c[:, 3 * i + 0][:, None, None] * px[None]
                + c[:, 3 * i + 1][:, None, None] * py[None]
                + c[:, 3 * i + 2][:, None, None]
            )

        bc0, bc1, bc2 = bc(0), bc(1), bc(2)
        inside = (
            (bc0 >= 0.0) & (bc1 >= 0.0) & (bc2 >= 0.0)
            & v_[:, None, None] & ndc_mask[None]
        )
        denom = (
            bc0 * w_[:, 0][:, None, None]
            + bc1 * w_[:, 1][:, None, None]
            + bc2 * w_[:, 2][:, None, None]
        )
        inside &= denom > 1e-10
        if depth_mode == DEPTH_VIEWZ:
            view_z = 1.0 / jnp.maximum(denom, 1e-10)
            z01 = jnp.clip((view_z - zn) * inv_range, 0.0, 1.0)
        else:
            zlin = (
                bc0 * z_[:, 0][:, None, None]
                + bc1 * z_[:, 1][:, None, None]
                + bc2 * z_[:, 2][:, None, None]
            ) / jnp.maximum(denom, 1e-10)
            z01 = jnp.clip(zlin * 0.5 + 0.5, 0.0, 1.0)

        cand = jnp.where(inside, z01, jnp.inf)
        best = jnp.min(cand, axis=0)                    # (H, W)
        kidx = jnp.argmin(cand, axis=0)                 # first min = first submitted
        win_tid = id_[kidx]                             # (H, W)
        upd = best < depth
        depth = jnp.where(upd, best, depth)
        tid = jnp.where(upd, win_tid, tid)
        return (depth, tid), None

    (depth, tid), _ = jax.lax.scan(
        body,
        (depth_init, tid_init),
        (resh(coef), resh(iw), resh(ziw), resh(valid), resh(ids)),
    )
    return depth, tid
