"""The tiled Triton raster (interpret mode here) must agree with the brute
XLA path, across its arguments: depth modes, id tracking, tile shapes, row
bands, stacked slot bands, depth chaining and the spatial-sort tie rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_cube
from lsr_tpu.raster.brute import rasterize_brute
from lsr_tpu.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ, scene_setup
from lsr_tpu.raster.tiled import _SUPER, rasterize_direct
from lsr_tpu.resources.assets import make_head_mesh

ZN, ZF = jnp.float32(0.1), jnp.float32(100.0)


def _setup_for(mesh, model, width, height):
    vp = np.asarray(
        m3.perspective_lh_no(np.pi / 3, width / height, 0.1, 100.0)
        @ m3.look_at_lh(
            jnp.array([0.0, 0.0, -3.0]), jnp.array([0.0, 0.0, 0.0]),
            jnp.array([0.0, 1.0, 0.0]),
        )
    )
    return scene_setup(
        jnp.asarray(mesh.positions),
        jnp.asarray(mesh.normals),
        jnp.asarray(mesh.uvs),
        jnp.asarray(mesh.indices),
        jnp.zeros(mesh.num_vertices, jnp.int32),
        jnp.zeros(mesh.num_triangles, jnp.int32),
        jnp.asarray(model)[None],
        np.asarray(m3.normal_matrix(jnp.asarray(model)))[None],
        jnp.asarray(vp),
        width,
        height,
    )


@pytest.fixture(scope="module")
def head_setup():
    w, h = 160, 96  # not multiples of the tile sizes
    return _setup_for(make_head_mesh(), np.asarray(m3.rotate_y(0.5)), w, h), w, h


def _z_range(depth_mode):
    if depth_mode == DEPTH_VIEWZ:
        return ZN, ZF
    return jnp.float32(0.0), jnp.float32(1.0)


@pytest.mark.parametrize("depth_mode,track_ids,spatial_sort,tile", [
    (DEPTH_VIEWZ, True, False, (32, 32)),
    (DEPTH_VIEWZ, True, True, (32, 32)),
    (DEPTH_VIEWZ, True, False, (16, 64)),
    (DEPTH_VIEWZ, True, True, (16, 16)),
    (DEPTH_NDC01, False, False, (32, 32)),
    (DEPTH_NDC01, False, True, (16, 16)),
    (DEPTH_VIEWZ, False, True, (32, 32)),
], ids=["viewz", "viewz_sorted", "viewz_16x64", "viewz_sorted_16x16",
        "ndc_depth_only", "ndc_depth_only_sorted", "viewz_depth_only"])
def test_direct_matches_brute_monkey(head_setup, depth_mode, track_ids,
                                     spatial_sort, tile):
    setup, w, h = head_setup
    zn, zf = _z_range(depth_mode)
    d_b, t_b = rasterize_brute(setup, w, h, zn, zf, depth_mode=depth_mode)
    d_t, t_t, max_sup = rasterize_direct(
        setup, w, h, zn, zf, depth_mode=depth_mode, track_ids=track_ids,
        spatial_sort=spatial_sort, tile_h=tile[0], tile_w=tile[1])
    assert 0 < int(max_sup) <= -(-setup.count // _SUPER)
    d_b, t_b, d_t, t_t = map(np.asarray, (d_b, t_b, d_t, t_t))
    assert (t_b >= 0).sum() > 1000
    # Identical arithmetic and order rules: bit-exact depth and winners.
    np.testing.assert_array_equal(d_t, d_b)
    if track_ids:
        np.testing.assert_array_equal(t_t, t_b)
    else:
        assert (t_t == -1).all()  # tid_init passes through untouched


def test_super_lists_never_overflow(head_setup):
    """Per-tile lists hold every super, so a dense scene drops nothing:
    the reported max never exceeds the number of supers."""
    setup, w, h = head_setup
    dense = jax.tree_util.tree_map(
        lambda x: jnp.concatenate([x] * 3, axis=0), setup)
    d, t, max_sup = rasterize_direct(dense, w, h, ZN, ZF, tile_h=64,
                                     tile_w=64)
    # The expected maximum, from the valid triangles' bboxes: per 64x64
    # tile, the supers holding a triangle whose bbox overlaps the tile's
    # bbox-union test (super bbox = union of its valid triangles).
    valid = np.asarray(dense.valid)
    bb = np.asarray(dense.bbox)
    n_sup = -(-dense.count // _SUPER)
    sup = np.arange(dense.count) // _SUPER
    best = 0
    for ty in range(0, h, 64):
        for tx in range(0, w, 64):
            hit = np.zeros(n_sup, bool)
            for s in range(n_sup):
                m = valid & (sup == s)
                if m.any():
                    x0, y0 = bb[m, 0].min(), bb[m, 1].min()
                    x1, y1 = bb[m, 2].max(), bb[m, 3].max()
                    hit[s] = (x0 <= tx + 63) & (x1 >= tx) & \
                        (y0 <= ty + 63) & (y1 >= ty)
            best = max(best, int(hit.sum()))
    assert int(max_sup) == best > 1
    d_b, t_b = rasterize_brute(dense, w, h, ZN, ZF)
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d_b))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t_b))


def test_empty_setup_keeps_background(head_setup):
    import dataclasses

    setup, w, h = head_setup
    none = dataclasses.replace(setup, valid=jnp.zeros_like(setup.valid))
    d, t, max_sup = rasterize_direct(none, w, h, ZN, ZF)
    assert int(max_sup) == 0
    assert (np.asarray(d) == 1.0).all() and (np.asarray(t) == -1).all()


@pytest.mark.parametrize("tile", [(16, 16), (32, 32)], ids=["16", "32"])
def test_band_offset_matches_full(tile):
    w, h = 128, 64
    setup = _setup_for(make_head_mesh(), np.eye(4, dtype=np.float32), w, h)
    d_f, t_f, _ = rasterize_direct(setup, w, h, ZN, ZF)
    band = h // 2
    d_b, t_b, _ = rasterize_direct(setup, w, band, ZN, ZF,
                                   tile_h=tile[0], tile_w=tile[1],
                                   y_offset=band, full_height=h)
    np.testing.assert_array_equal(np.asarray(t_f)[band:], np.asarray(t_b))
    np.testing.assert_array_equal(np.asarray(d_f)[band:], np.asarray(d_b))


def test_stacked_bands_match_per_slot():
    """band_h: two slot-local setups stacked into one tall target render
    exactly like two separate rasters (the packed shadow-atlas path)."""
    from lsr_tpu.lighting.local_shadows import _stack_slot_setups

    s = 64
    mesh = make_head_mesh()
    slots = [_setup_for(mesh, np.asarray(m3.rotate_y(a)), s, s)
             for a in (0.3, 1.4)]
    kw = dict(depth_mode=DEPTH_NDC01, track_ids=False, tile_h=32, tile_w=32)
    zn, zf = _z_range(DEPTH_NDC01)
    ref = [np.asarray(rasterize_direct(st, s, s, zn, zf, **kw)[0])
           for st in slots]
    ts = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *slots)
    stacked = _stack_slot_setups(ts, s)
    d, _, _ = rasterize_direct(stacked, s, 2 * s, zn, zf, band_h=s, **kw)
    d = np.asarray(d)
    np.testing.assert_array_equal(d[:s], ref[0])
    np.testing.assert_array_equal(d[s:], ref[1])


@pytest.mark.parametrize("spatial_sort", [False, True],
                         ids=["submission", "sorted"])
def test_depth_chaining(spatial_sort):
    # Rasterizing mesh A then mesh B over the same buffers must equal
    # rasterizing A+B at once (depth buffer chaining across draws).
    cube = make_cube(1.5)
    w, h = 96, 64
    s_a = _setup_for(cube, np.asarray(m3.translate([-0.4, 0.0, 0.2])), w, h)
    s_b = _setup_for(cube, np.asarray(
        m3.translate([0.4, 0.0, -0.2]) @ m3.rotate_y(0.6)), w, h)
    d1, t1, _ = rasterize_direct(s_a, w, h, ZN, ZF,
                                 spatial_sort=spatial_sort)
    d2, t2, _ = rasterize_direct(s_b, w, h, ZN, ZF, depth_init=d1,
                                 tid_init=t1, spatial_sort=spatial_sort)
    d_ref_a, t_ref_a = rasterize_brute(s_a, w, h, ZN, ZF)
    d_ref, t_ref = rasterize_brute(s_b, w, h, ZN, ZF, depth_init=d_ref_a,
                                   tid_init=t_ref_a)
    t2, t_ref = np.asarray(t2), np.asarray(t_ref)
    np.testing.assert_array_equal(np.asarray(d2), np.asarray(d_ref))
    if spatial_sort:
        # Over a non-background tid_init a sorted raster resolves exact ties
        # by min tid, not keep-initial (rasterize_direct's docstring): only
        # coverage is compared.
        np.testing.assert_array_equal(t2 >= 0, t_ref >= 0)
    else:
        np.testing.assert_array_equal(t2, t_ref)
    assert (t2 >= 0).sum() > 100


def test_spatial_sort_shuffled_input_exact(head_setup):
    """spatial_sort reorders setup rows for tighter chunk bboxes; depth and
    emitted tids (which index the caller's rows) must not change."""
    setup, w, h = head_setup
    perm = np.argsort(np.arange(setup.count) % 7, kind="stable")
    shuffled = jax.tree_util.tree_map(lambda x: x[jnp.asarray(perm)], setup)
    d0, t0, _ = rasterize_direct(shuffled, w, h, ZN, ZF)
    d1, t1, _ = rasterize_direct(shuffled, w, h, ZN, ZF, spatial_sort=True)
    np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))


def test_spatial_sort_tid_ties_exact(head_setup):
    """Exact z ties: duplicating every setup row makes each covered pixel a
    perfect depth tie between tid i and tid i+n.  The sorted raster resolves
    ties by MIN TID, which must reproduce the unsorted first-wins result —
    winners all come from the first copy."""
    setup, w, h = head_setup
    n = setup.count
    doubled = jax.tree_util.tree_map(
        lambda x: jnp.concatenate([x, x], axis=0), setup)
    d0, t0, _ = rasterize_direct(doubled, w, h, ZN, ZF)
    d1, t1, _ = rasterize_direct(doubled, w, h, ZN, ZF, spatial_sort=True)
    t0n, t1n = np.asarray(t0), np.asarray(t1)
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))
    np.testing.assert_array_equal(t0n, t1n)
    covered = t0n >= 0
    assert covered.any()
    assert (t0n[covered] < n).all(), "tie must keep the lower tid copy"
