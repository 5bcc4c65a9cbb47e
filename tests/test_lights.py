"""Light types, attenuation, binning conservativeness, Forward+ equivalence."""

import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_plane
from lsr_tpu.lighting.light_culling import (
    cull_lights_clustered,
    cull_lights_tiled,
    view_depth_to_cluster_slice,
)
from lsr_tpu.lighting.light_runtime import (
    accumulate_local_lights,
    eval_distance_attenuation,
    eval_local_lights,
    _gather_light_columns,
)
from lsr_tpu.lighting.light_types import LightSetBuilder
from lsr_tpu.raster.brute import rasterize_brute
from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import scene_setup
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.resources.assets import make_head_mesh


def test_attenuation_models():
    d = jnp.array([0.0, 1.0, 2.0, 4.9, 5.0, 6.0])
    for model in (0, 1, 2):
        a = np.asarray(eval_distance_attenuation(
            d, jnp.float32(5.0), jnp.int32(model), jnp.float32(1.0),
            jnp.float32(1e-4), jnp.float32(0.0)))
        assert a[0] >= a[1] >= a[2] >= a[3]          # non-increasing
        assert a[4] == 0.0 and a[5] == 0.0           # zero at/after range
        assert a[1] > 0.0
    # Cutoff kills small tails.
    a = np.asarray(eval_distance_attenuation(
        jnp.array([4.8]), jnp.float32(5.0), jnp.int32(1), jnp.float32(1.0),
        jnp.float32(1e-4), jnp.float32(0.5)))
    assert a[0] == 0.0


def test_spot_cone_shaping():
    b = LightSetBuilder()
    b.spot((0, 2, 0), (0, -1, 0), intensity=3.0, range=10.0,
           inner_angle=0.3, outer_angle=0.5)
    lights = b.build()
    idx = jnp.zeros((2, 1), jnp.int32)  # same light for 2 sample points
    cols = _gather_light_columns(lights, idx)
    # Point directly below (inside cone) and far off-axis (outside cone).
    wp = jnp.array([[0.0, 0.0, 0.0], [8.0, 0.0, 0.0]], jnp.float32)
    n = jnp.tile(jnp.array([[0.0, 1.0, 0.0]], jnp.float32), (2, 1))
    v = jnp.tile(jnp.array([[0.0, 1.0, 0.0]], jnp.float32), (2, 1))
    d, s = eval_local_lights(cols, wp, n, v)
    d = np.asarray(d)
    assert d[0].sum() > 0.0
    assert d[1].sum() == 0.0


def test_rect_tube_fall_off():
    b = LightSetBuilder()
    b.rect_area((0, 1.5, 0), (0, -1, 0), half_extents=(1.0, 0.5), intensity=2.0, range=4.0)
    b.tube_area((0, 1.5, 0), axis=(1, 0, 0), half_length=1.0, radius=0.1,
                intensity=2.0, range=4.0)
    lights = b.build()
    idx = jnp.broadcast_to(jnp.arange(2, dtype=jnp.int32)[None], (2, 2))
    cols = _gather_light_columns(lights, idx)
    wp = jnp.array([[0.0, 0.5, 0.0], [0.0, 1.5, 40.0]], jnp.float32)  # near, far
    n = jnp.tile(jnp.array([[0.0, 1.0, 0.0]], jnp.float32), (2, 1))
    v = n
    d, _ = eval_local_lights(cols, wp, n, v)
    d = np.asarray(d)
    assert (d[0] > 0).any(axis=-1).all()   # both lights light the near point
    assert d[1].sum() == 0.0               # far point unlit


def _light_ring(n, radius=3.0, y=0.5, intensity=1.2, rng_range=3.0):
    b = LightSetBuilder()
    rng = np.random.default_rng(3)
    for i in range(n):
        a = 2 * np.pi * i / n
        color = rng.uniform(0.3, 1.0, 3)
        b.point((radius * np.cos(a), y, radius * np.sin(a)),
                color=tuple(color), intensity=intensity, range=rng_range)
    return b.build()


def _monkey_gbuffer(w, h):
    sb = SceneBuilder()
    sb.add(make_head_mesh(), np.asarray(m3.translate([0, 0.2, 0])))
    sb.add(make_plane(6.0, y=-1.0), material=0, casts_shadow=False)
    geom, objects = sb.build()
    cam = make_camera(w, h, (0.5, 1.5, -4.0), (0, 0, 0))
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h,
    )
    depth, tid = rasterize_brute(setup, w, h, cam.zn, cam.zf)
    return interpolate_gbuffer(setup, depth, tid), cam


def test_tiled_binning_matches_dense():
    w, h = 96, 64
    gb, cam = _monkey_gbuffer(w, h)
    lights = _light_ring(24)
    eye = jnp.array([0.5, 1.5, -4.0], jnp.float32)

    lists, counts, bin_stats = cull_lights_tiled(
        lights, cam.view, cam.proj, w, h, tile_size=16, cap=32
    )
    assert int(bin_stats["max_count"]) <= 32
    assert int(bin_stats["overflow_bins"]) == 0
    d_binned, s_binned = accumulate_local_lights(
        gb.world_pos, gb.normal_ws, eye, lights, lists, w, h,
        tile_size=16, chunk=8,
    )

    # Dense reference: every light against every pixel.
    all_idx = jnp.broadcast_to(
        jnp.arange(lights.count, dtype=jnp.int32)[None, None], (h, w, lights.count)
    )
    cols = _gather_light_columns(lights, all_idx)
    v = (eye[None, None] - gb.world_pos)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)
    d_dense, s_dense = eval_local_lights(cols, gb.world_pos, gb.normal_ws, v)
    d_dense = d_dense.sum(-2)
    s_dense = s_dense.sum(-2)

    np.testing.assert_allclose(np.asarray(d_binned), np.asarray(d_dense),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(s_binned), np.asarray(s_dense),
                               atol=2e-4, rtol=1e-3)
    assert float(jnp.abs(d_dense).sum()) > 1.0  # scene actually lit


def test_clustered_matches_tiled():
    w, h = 96, 64
    gb, cam = _monkey_gbuffer(w, h)
    lights = _light_ring(16)
    eye = jnp.array([0.5, 1.5, -4.0], jnp.float32)

    lists_t, _, _ = cull_lights_tiled(lights, cam.view, cam.proj, w, h,
                                      tile_size=16, cap=32)
    d_t, s_t = accumulate_local_lights(
        gb.world_pos, gb.normal_ws, eye, lights, lists_t, w, h,
        tile_size=16, chunk=8)

    slices = 8
    lists_c, _, cstats = cull_lights_clustered(
        lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=32, slices=slices)
    assert int(cstats["max_count"]) <= 32
    view_z = cam.zn + gb.depth01 * (cam.zf - cam.zn)
    cluster = view_depth_to_cluster_slice(view_z, cam.zn, cam.zf, slices)
    d_c, s_c = accumulate_local_lights(
        gb.world_pos, gb.normal_ws, eye, lights, lists_c, w, h,
        tile_size=16, chunk=8, cluster_of_pixel=cluster, slices=slices)

    # Covered pixels must agree (clustered binning is conservative per slice).
    cov = np.asarray(gb.covered)
    np.testing.assert_allclose(np.asarray(d_c)[cov], np.asarray(d_t)[cov],
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(s_c)[cov], np.asarray(s_t)[cov],
                               atol=2e-4, rtol=1e-3)


def test_forward_plus_frame():
    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    w, h = 96, 64
    gb, cam = _monkey_gbuffer(w, h)
    lights = _light_ring(32, intensity=2.0)
    mats = make_materials(base_color=[(0.7, 0.7, 0.7)])
    ctx = make_shade_context(mats, light_dir_ws=(0.3, -0.7, 0.5),
                             camera_pos=(0.5, 1.5, -4.0), light_intensity=1.0)
    for mode in ("tiled", "tiled_depth_range", "clustered"):
        hdr, stats = shade_forward_plus(
            gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
            tile_size=16, cap=64, mode=mode,
        )
        a = np.asarray(hdr)
        assert np.isfinite(a).all(), mode
        assert a[np.asarray(gb.covered)].mean() > 0.01, mode


def test_forward_plus_zero_lights_equals_sun_only():
    """Regression: with no local lights, forward+ must equal plain sun shading
    (guards against accumulator/base mixups)."""
    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import (
        SHADING_MODELS,
        composite_over_background,
        make_shade_context,
    )

    w, h = 96, 64
    gb, cam = _monkey_gbuffer(w, h)
    b = LightSetBuilder()
    b.point((50.0, 50.0, 50.0), intensity=0.0, range=0.001)  # inert
    lights = b.build()
    mats = make_materials(base_color=[(0.7, 0.4, 0.2)])
    ctx = make_shade_context(mats, light_dir_ws=(0.3, -0.7, 0.5),
                             camera_pos=(0.5, 1.5, -4.0), light_intensity=2.0)
    hdr, _ = shade_forward_plus(
        gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=16, mode="tiled", sun_model="pbr_mr",
        background=(0.1, 0.2, 0.3),
    )
    ref = composite_over_background(
        SHADING_MODELS["pbr_mr"](gb, ctx), gb,
        jnp.broadcast_to(jnp.asarray((0.1, 0.2, 0.3), jnp.float32),
                         (h, w, 3)),
    )
    np.testing.assert_allclose(np.asarray(hdr), np.asarray(ref), atol=1e-5)


def test_collect_object_lights_and_motion():
    from lsr_tpu.lighting.light_runtime import animate_lights, collect_object_lights

    lights = _light_ring(12, radius=3.0, rng_range=2.0)
    centers = jnp.asarray([[3.0, 0.5, 0.0], [50.0, 0.0, 0.0]], jnp.float32)
    radii = jnp.asarray([0.5, 0.5], jnp.float32)
    idx, counts = collect_object_lights(lights, centers, radii, cap=4)
    assert idx.shape == (2, 4)
    assert int(counts[0]) >= 1          # ring light at (3, .5, 0) reaches obj 0
    assert int(counts[1]) == 0          # far object gets none
    # Nearest light first.
    first = int(idx[0, 0])
    assert first >= 0
    d = np.asarray(lights.position)[first] - np.asarray(centers[0])
    assert np.linalg.norm(d) < 2.5

    moved = animate_lights(lights, 1.5, orbit_radius=0.5, pulse_amount=0.3)
    assert not np.allclose(np.asarray(moved.position), np.asarray(lights.position))
    assert not np.allclose(np.asarray(moved.intensity), np.asarray(lights.intensity))
    # Orbit preserves distance-to-anchor bound.
    dd = np.linalg.norm(np.asarray(moved.position - lights.position), axis=-1)
    assert np.all(dd <= 0.5 + 1e-5)


def test_clustered_kernel_matches_xla():
    """The fused kernel's clustered mode (per-slice list walks + per-pixel
    slice masking) must reproduce the XLA clustered accumulation."""
    import jax

    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    w, h = 128, 96
    gb, cam = _monkey_gbuffer(w, h)
    lights = _light_ring(24, intensity=1.5)
    mats = make_materials(base_color=[(0.7, 0.7, 0.7)])
    ctx = make_shade_context(mats, light_dir_ws=(0.3, -0.7, 0.5),
                             camera_pos=(0.5, 1.5, -4.0), light_intensity=1.0)

    def run(use_kernel):
        hdr, _ = shade_forward_plus(
            gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
            tile_size=16, cap=32, mode="clustered", slices=8,
            sun_model="pbr_mr", use_kernel=use_kernel)
        return np.asarray(jax.block_until_ready(hdr))

    a = run(False)
    b = run(True)
    d = np.abs(a - b)
    assert d.mean() < 5e-3, d.mean()
    assert (d.max(-1) > 0.05).mean() < 0.02


def test_shade_kernel_light_kinds_specialization():
    """Static light-type specialization must be BIT-exact: dropping math
    for types absent from light_kinds changes nothing, and the generic
    kernel (light_kinds=None) equals the specialized one for the full
    mixed set too."""
    from lsr_tpu.lighting.shade_kernel import shade_local_lights

    w, h = 96, 64
    gb, cam = _monkey_gbuffer(w, h)
    rng = np.random.default_rng(11)

    def build(mixed):
        b = LightSetBuilder()
        for i in range(10):
            p = tuple(rng.uniform([-3, 0, -3], [3, 2, 3]).tolist())
            c = tuple(rng.uniform(0.3, 1.0, 3).tolist())
            if mixed and i % 4 == 1:
                b.rect_area(p, (0, -1, 0), color=c, intensity=1.5,
                            range=4.0)
            elif mixed and i % 4 == 2:
                b.tube_area(p, axis=(1, 0, 0), color=c, intensity=1.5,
                            range=4.0)
            elif i % 2 == 0:
                b.spot(p, (0, -1, 0), color=c, intensity=2.0, range=4.0)
            else:
                b.point(p, color=c, intensity=1.5, range=3.0)
        return b.build()

    eye = jnp.array([0.5, 1.5, -4.0], jnp.float32)
    albedo = jnp.full((h, w, 3), 0.6, jnp.float32)

    for mixed in (False, True):
        lights = build(mixed)
        kinds = tuple(sorted(int(t) for t in
                             np.unique(np.asarray(lights.type))))

        def run(lk, lights=lights):
            lit, _ = shade_local_lights(
                gb.world_pos, gb.normal_ws, gb.covered, albedo, eye,
                lights, cam.view, cam.proj, w, h,
                tile_size=16, cap=32, light_kinds=lk)
            return np.asarray(lit)

        a = run(None)
        b_ = run(kinds)
        assert (a == b_).all(), (mixed, np.abs(a - b_).max())
