"""Tiled rasterizer: the hot kernel of the framework (Pallas, Triton route).

Design (the reference's screen-tile parallelism, draw_triangle_tile /
hello_pipeline_blinn_phong_shading.cpp:189, laid out for a GPU):

1. *Binning* (plain XLA): triangles are grouped into chunks of 16 and
   supers of 256 in submission order (or in screen-tile order with
   `spatial_sort`).  Each screen tile gets the list of supers whose bbox
   overlaps it: a (tiles x supers) mask compacted with a cumsum + scatter.
   The list capacity is the number of supers, so a list can never overflow.

2. *Raster kernel* (one program per power-of-two screen tile): each program
   owns its (tile_h, tile_w) block of the depth and id buffers — the same
   disjoint-ownership trick the reference uses for lock-free z-buffering.
   It walks its super list; for each chunk whose bbox touches the tile, and
   each triangle of the chunk whose bbox touches it, it loads the
   triangle's setup record as scalars from device memory and updates the
   tile's depth and id in registers.  The buffers are read once and stored
   once.  Triangles are visited in ascending order, so the sequential
   `z01 >= zbuf -> skip` rule (rasterizer.hpp:362-365) is reproduced exactly
   by a strict less-than; sorted rasters resolve exact ties by the lower
   triangle id instead, which gives the same winner.

Output is the visibility buffer (depth01, tri id); attribute interpolation
and shading are separate fullscreen passes (raster/interp.py).

Setup records are stored field-major, (20, N) f32:
  [0:9]   barycentric affine coefficients A0,B0,C0,A1,B1,C1,A2,B2,C2
  [9:12]  per-corner 1/w
  [12:15] per-corner z_ndc/w (DEPTH_NDC01 / ortho shadow mode)
  [15]    triangle id as f32 (-1 = invalid; exact below 2^24 triangles)
  [16:20] screen bbox x0, y0, x1, y1 (inclusive)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from lsr_tpu.core.device import kernel_interpret
from lsr_tpu.core.util import cdiv
from lsr_tpu.raster.setup import DEPTH_VIEWZ, TriSetup

_SUPER = 256   # triangles per super (the unit of the per-tile lists)
_CHUNK = 16    # triangles per chunk (the unit of the in-kernel bbox skip)
_FIELDS = 20


def _chunk_bboxes(setup: TriSetup, n_pad: int, chunk: int):
    """(n_pad/chunk, 4) f32 chunk bboxes (x0,y0,x1,y1); empty for invalid."""
    big = jnp.float32(1e9)
    bb = setup.bbox.astype(jnp.float32)
    x0 = jnp.where(setup.valid, bb[:, 0], big)
    y0 = jnp.where(setup.valid, bb[:, 1], big)
    x1 = jnp.where(setup.valid, bb[:, 2], -big)
    y1 = jnp.where(setup.valid, bb[:, 3], -big)

    def padto(x, fill):
        pad = n_pad - x.shape[0]
        return jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])

    x0 = padto(x0, big).reshape(-1, chunk).min(axis=1)
    y0 = padto(y0, big).reshape(-1, chunk).min(axis=1)
    x1 = padto(x1, -big).reshape(-1, chunk).max(axis=1)
    y1 = padto(y1, -big).reshape(-1, chunk).max(axis=1)
    return jnp.stack([x0, y0, x1, y1], axis=-1)


def _super_lists(chunk_bb, chunk: int, tiles_x: int, tiles_y: int,
                 tile_w: int, tile_h: int, y_offset):
    """Per-tile overlapping-super lists from chunk bboxes, in ascending
    super order.  Returns (lists (tiles, S) i32 -1 pad, counts (tiles,),
    max_count)."""
    cps = _SUPER // chunk
    s = chunk_bb.shape[0] // cps
    sb = chunk_bb.reshape(s, cps, 4)
    sx0 = sb[..., 0].min(axis=1)
    sy0 = sb[..., 1].min(axis=1) - y_offset
    sx1 = sb[..., 2].max(axis=1)
    sy1 = sb[..., 3].max(axis=1) - y_offset

    tx = jnp.arange(tiles_x, dtype=jnp.float32) * tile_w
    ty = jnp.arange(tiles_y, dtype=jnp.float32) * tile_h
    ox = (sx0[None, :] <= tx[:, None] + (tile_w - 1)) & (sx1[None, :] >= tx[:, None])
    oy = (sy0[None, :] <= ty[:, None] + (tile_h - 1)) & (sy1[None, :] >= ty[:, None])
    mask = (oy[:, None, :] & ox[None, :, :]).reshape(tiles_y * tiles_x, s)

    pos = jnp.cumsum(mask, axis=1, dtype=jnp.int32) - 1
    counts = jnp.sum(mask, axis=1, dtype=jnp.int32)
    base = (jnp.arange(tiles_y * tiles_x, dtype=jnp.int32) * s)[:, None]
    flat = jnp.where(mask, base + pos, tiles_y * tiles_x * s)
    ids = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], mask.shape)
    lists = jnp.full((tiles_y * tiles_x * s,), -1, jnp.int32)
    lists = lists.at[flat.reshape(-1)].set(ids.reshape(-1), mode="drop")
    return lists.reshape(-1, s), counts, counts.max()


def _raster_kernel(
    params_ref,  # (4,) f32: zn, 1/(zf-zn), y_offset, last coverable row
    counts_ref,  # (tiles,) i32: supers per tile
    slist_ref,   # (tiles * S,) i32: super lists
    cbb_ref,     # (4, n_chunks) f32: chunk bboxes
    rec_ref,     # (_FIELDS, n_pad) f32: setup records, field-major
    depth_in, tid_in, depth_out, tid_out,
    *, width, tile_h, tile_w, chunk, depth_mode, tiles_x, n_super,
    track_ids: bool, band_h: int, tie_tid: bool,
):
    tyi = pl.program_id(0)
    txi = pl.program_id(1)
    zn = params_ref[0]
    inv_range = params_ref[1]
    x0 = (txi * tile_w).astype(jnp.float32)
    y0 = (tyi * tile_h).astype(jnp.float32) + params_ref[2]
    # Stacked-atlas mode (band_h > 0): slot setups are SLOT-LOCAL (their
    # coefficients and the coverage bound assume rows [0, band_h)); only
    # their bboxes were shifted to global rows for binning.  Evaluating
    # pixel rows band-locally keeps the arithmetic identical to a
    # standalone per-slot raster.
    if band_h:
        y0_cov = ((tyi * tile_h) % band_h).astype(jnp.float32)
        max_py = jnp.float32(band_h - 1)
    else:
        y0_cov = y0
        max_py = params_ref[3]

    col = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
    px = x0 + col.astype(jnp.float32) + 0.5  # pixel centers (rasterizer.hpp:336)
    py = y0_cov + row.astype(jnp.float32) + 0.5
    # NDC coverage bound (see raster/brute.py): last row/col never covered.
    ndc_ok = (px <= float(width - 1)) & (py <= max_py)

    xmax = x0 + (tile_w - 1)
    ymax = y0 + (tile_h - 1)

    def overlaps(bx0, by0, bx1, by1):
        return (bx0 <= xmax) & (bx1 >= x0) & (by0 <= ymax) & (by1 >= y0)

    def raster_tri(i, carry):
        def f(j):
            return rec_ref[j, i]

        bc0 = f(0) * px + f(1) * py + f(2)
        bc1 = f(3) * px + f(4) * py + f(5)
        bc2 = f(6) * px + f(7) * py + f(8)
        denom = bc0 * f(9) + bc1 * f(10) + bc2 * f(11)
        inside = ((bc0 >= 0.0) & (bc1 >= 0.0) & (bc2 >= 0.0) & ndc_ok
                  & (denom > 1e-10))
        if depth_mode == DEPTH_VIEWZ:
            view_z = 1.0 / jnp.maximum(denom, 1e-10)
            z01 = jnp.clip((view_z - zn) * inv_range, 0.0, 1.0)
        else:
            zlin = (bc0 * f(12) + bc1 * f(13) + bc2 * f(14)) / jnp.maximum(
                denom, 1e-10)
            z01 = jnp.clip(zlin * 0.5 + 0.5, 0.0, 1.0)
        if not track_ids:
            # Depth-only (shadow maps, occluders): pure min resolve.
            return jnp.where(inside, jnp.minimum(z01, carry), carry)
        depth, tid = carry
        t = f(15).astype(jnp.int32)
        upd = z01 < depth
        if tie_tid:
            # Order-independent resolve: min (depth, tid) lexicographic,
            # which equals the unsorted first-wins result because unsorted
            # submission is tid-ascending.
            upd = upd | ((z01 == depth) & (t < tid))
        upd = upd & inside
        return jnp.where(upd, z01, depth), jnp.where(upd, t, tid)

    def tri_body(i, carry):
        hit = (rec_ref[15, i] >= 0.0) & overlaps(
            rec_ref[16, i], rec_ref[17, i], rec_ref[18, i], rec_ref[19, i])
        return jax.lax.cond(hit, functools.partial(raster_tri, i),
                            lambda c: c, carry)

    def chunk_body(c, carry):
        hit = overlaps(cbb_ref[0, c], cbb_ref[1, c], cbb_ref[2, c],
                       cbb_ref[3, c])
        return jax.lax.cond(
            hit,
            lambda cr: jax.lax.fori_loop(c * chunk, (c + 1) * chunk,
                                         tri_body, cr),
            lambda cr: cr, carry)

    cps = _SUPER // chunk
    t_lin = tyi * tiles_x + txi

    def sup_body(k, carry):
        s = slist_ref[t_lin * n_super + k]
        return jax.lax.fori_loop(s * cps, (s + 1) * cps, chunk_body, carry)

    n_sup = counts_ref[t_lin]
    if track_ids:
        depth, tid = jax.lax.fori_loop(0, n_sup, sup_body,
                                       (depth_in[...], tid_in[...]))
    else:
        depth = jax.lax.fori_loop(0, n_sup, sup_body, depth_in[...])
        tid = tid_in[...]
    depth_out[...] = depth
    tid_out[...] = tid


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "depth_mode", "tile_h", "tile_w",
        "track_ids", "band_h", "spatial_sort", "full_height",
    ),
)
def rasterize_direct(
    setup: TriSetup,
    width: int,
    height: int,
    zn,
    zf,
    depth_init=None,
    tid_init=None,
    depth_mode: int = DEPTH_VIEWZ,
    tile_h: int = 32,
    tile_w: int = 32,
    y_offset=0,
    full_height: int | None = None,
    track_ids: bool = True,
    band_h: int = 0,
    spatial_sort: bool = False,
):
    """Tiled rasterization of `setup` into a (height, width) target.

    track_ids=False skips winner-id tracking (depth-only passes like shadow
    maps); the returned tid is then `tid_init` unchanged.

    y_offset/full_height render global rows [y_offset, y_offset + height)
    of a full_height framebuffer (screen-space row bands).

    band_h > 0: the target is a stack of band_h-row slots whose setups are
    slot-local (lighting/local_shadows._stack_slot_setups); band_h must be
    a multiple of tile_h.

    spatial_sort=True reorders setup rows by bbox-center tile before
    chunking, so chunk and super bboxes are tight when the input order is
    spatially scattered.  Emitted tids still index the CALLER's setup rows.
    Depth is identical either way (min resolve), and so are tids: sorted
    rasters resolve exact z ties by min tid, which equals the unsorted
    first-wins rule.  (Only callers that pass a non-background tid_init AND
    sort see min tid instead of keep-initial on ties.)  Not supported with
    band_h (sorting would mix slots inside one chunk).

    Returns (depth01, tid, max_supers_per_tile).
    """
    if full_height is None:
        full_height = height
    for t in (tile_h, tile_w):
        assert t & (t - 1) == 0, "tile sides must be powers of two"
    if band_h:
        assert band_h % tile_h == 0, "stacked bands must align to tiles"
        assert not spatial_sort, "spatial_sort breaks stacked-band slots"
    chunk = _CHUNK
    tiles_x = cdiv(width, tile_w)
    tiles_y = cdiv(height, tile_h)
    ph, pw = tiles_y * tile_h, tiles_x * tile_w

    n = setup.coef.shape[0]
    n_pad = cdiv(max(n, 1), _SUPER) * _SUPER
    n_super = n_pad // _SUPER

    if spatial_sort:
        cx = (setup.bbox[:, 0] + setup.bbox[:, 2]) // 2
        cy = (setup.bbox[:, 1] + setup.bbox[:, 3]) // 2
        key = (cy // tile_h) * jnp.int32(1 << 15) + (cx // tile_w)
        key = jnp.where(setup.valid, key, jnp.int32(1 << 29))
        order = jnp.argsort(key)
        orig_id = jnp.arange(n, dtype=jnp.float32)[order]
        setup = jax.tree_util.tree_map(lambda x: x[order], setup)
        tid_f = jnp.where(setup.valid, orig_id, -1.0)
    else:
        tid_f = jnp.where(setup.valid, jnp.arange(n, dtype=jnp.float32),
                          -1.0)
    rec = jnp.concatenate(
        [setup.coef, setup.iw, setup.ziw, tid_f[:, None],
         setup.bbox.astype(jnp.float32)], axis=-1)
    pad_row = jnp.zeros((_FIELDS,), jnp.float32).at[15].set(-1.0)
    rec = jnp.concatenate(
        [rec, jnp.broadcast_to(pad_row, (n_pad - n, _FIELDS))], axis=0).T

    chunk_bb = _chunk_bboxes(setup, n_pad, chunk)
    slists, counts, max_sup = _super_lists(
        chunk_bb, chunk, tiles_x, tiles_y, tile_w, tile_h,
        jnp.asarray(y_offset, jnp.float32),
    )

    if depth_init is None:
        depth_init = jnp.ones((height, width), jnp.float32)
    if tid_init is None:
        tid_init = jnp.full((height, width), -1, jnp.int32)
    dpad = jnp.pad(depth_init, ((0, ph - height), (0, pw - width)),
                   constant_values=1.0)
    tpad = jnp.pad(tid_init, ((0, ph - height), (0, pw - width)),
                   constant_values=-1)

    params = jnp.stack([
        jnp.asarray(zn, jnp.float32),
        1.0 / jnp.maximum(jnp.asarray(zf - zn, jnp.float32), 1e-6),
        jnp.asarray(y_offset, jnp.float32),
        jnp.float32(full_height - 1),
    ])

    kern = functools.partial(
        _raster_kernel,
        width=width, tile_h=tile_h, tile_w=tile_w, chunk=chunk,
        depth_mode=depth_mode, tiles_x=tiles_x, n_super=n_super,
        track_ids=track_ids, band_h=band_h, tie_tid=spatial_sort,
    )
    whole = pl.BlockSpec(None, None)
    tile = pl.BlockSpec((tile_h, tile_w), lambda i, j: (i, j))
    depth, tid = pl.pallas_call(
        kern,
        grid=(tiles_y, tiles_x),
        in_specs=[whole, whole, whole, whole, whole, tile, tile],
        out_specs=(tile, tile),
        out_shape=(
            jax.ShapeDtypeStruct((ph, pw), jnp.float32),
            jax.ShapeDtypeStruct((ph, pw), jnp.int32),
        ),
        input_output_aliases={5: 0, 6: 1},
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=kernel_interpret(),
        name="lsr_raster",
    )(params, counts, slists.reshape(-1), chunk_bb.T, rec, dpad, tpad)

    return depth[:height, :width], tid[:height, :width], max_sup
