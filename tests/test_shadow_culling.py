"""Shadow mapping + frustum/occlusion culling tests (config #3 behaviors)."""

import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.core.frame import ShadowPassParams
from lsr_tpu.geometry.occlusion import (
    build_hiz_pyramid,
    occlusion_cull_aabbs,
    run_occlusion_pass,
)
from lsr_tpu.io.obj import make_cube, make_plane
from lsr_tpu.lighting.shadow_sample import shadow_visibility_dir
from lsr_tpu.passes.shadow import make_sun_shadow, render_shadow_map
from lsr_tpu.scene.scene import SceneBuilder, cull_scene, make_camera
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu.shading.common import make_materials
from lsr_tpu.resources.assets import make_head_mesh

SUN = (0.3, -1.0, 0.25)


def _shadow_scene():
    b = SceneBuilder()
    b.add(make_head_mesh(), np.asarray(m3.translate([0.0, 0.6, 0.0])))
    b.add(make_plane(5.0, y=-1.0), material=1, casts_shadow=False)
    return b.build()


def test_shadow_map_covers_casters():
    geom, objects = _shadow_scene()
    depth, light_vp = render_shadow_map(geom, objects, jnp.asarray(SUN, jnp.float32),
                                        map_size=256, use_tiled=False)
    d = np.asarray(depth)
    assert d.shape == (256, 256)
    # The monkey must have written depth strictly nearer than the 1.0 clear.
    assert (d < 0.999).sum() > 800
    assert d.min() >= 0.0


def test_ground_is_shadowed_under_monkey():
    geom, objects = _shadow_scene()
    shadow = make_sun_shadow(geom, objects, jnp.asarray(SUN, jnp.float32),
                             ShadowPassParams(map_size=512, pcf_radius=1))
    # Sample ground points: one under the monkey (offset along sun dir from
    # (0, 0.6, 0) to y=-1: t = 1.6/1.0), one far away.
    t = 1.6 / 1.0
    sx, sz = 0.3 * t, 0.25 * t
    pts = jnp.array([[[sx, -1.0, sz], [4.0, -1.0, 4.0]]], jnp.float32)  # (1,2,3)
    ndl = jnp.ones((1, 2), jnp.float32)
    vis = np.asarray(shadow_visibility_dir(shadow, pts, ndl))[0]
    assert vis[0] < 0.35, f"under-monkey point not shadowed: {vis}"
    assert vis[1] > 0.9, f"far point wrongly shadowed: {vis}"


def test_pcf_soft_edges():
    geom, objects = _shadow_scene()
    hard = make_sun_shadow(geom, objects, jnp.asarray(SUN, jnp.float32),
                           ShadowPassParams(map_size=512, pcf_radius=0))
    soft = make_sun_shadow(geom, objects, jnp.asarray(SUN, jnp.float32),
                           ShadowPassParams(map_size=512, pcf_radius=2))
    xs = np.linspace(-1.5, 1.5, 512, dtype=np.float32)
    pts = jnp.asarray(
        np.stack([xs + 0.48, np.full_like(xs, -1.0), np.full_like(xs, 0.4)], -1)
    )[None]
    ndl = jnp.ones((1, 512), jnp.float32)
    v_hard = np.asarray(shadow_visibility_dir(hard, pts, ndl))[0]
    v_soft = np.asarray(shadow_visibility_dir(soft, pts, ndl))[0]
    # Hard shadows are binary; PCF produces intermediate penumbra values.
    assert set(np.unique(v_hard)) <= {0.0, 1.0}
    assert ((v_soft > 0.02) & (v_soft < 0.98)).sum() >= 2


def test_frustum_culling_masks():
    b = SceneBuilder()
    b.add(make_cube(1.0), np.asarray(m3.translate([0, 0, 2.0])))     # in front
    b.add(make_cube(1.0), np.asarray(m3.translate([0, 0, -10.0])))   # behind
    b.add(make_cube(1.0), np.asarray(m3.translate([50.0, 0, 2.0])))  # far right
    geom, objects = b.build()
    cam = make_camera(128, 128, (0, 0, -3.0), (0, 0, 0))
    vis = np.asarray(cull_scene(objects, cam.viewproj))
    assert vis.tolist() == [True, False, False]


def test_hiz_pyramid_max():
    d = jnp.zeros((8, 8), jnp.float32).at[3, 5].set(0.7).at[0, 0].set(0.2)
    pyr = build_hiz_pyramid(d, 4)
    assert np.asarray(pyr[1]).shape == (4, 4)
    assert np.isclose(float(pyr[3][0, 0]), 0.7)  # global max propagates


def test_occlusion_cull_wall():
    # Big wall in front of a small cube: cube occluded; control cube beside
    # the wall stays visible.
    b = SceneBuilder()
    wall = b.add(make_cube(1.0), np.asarray(
        m3.translate([0, 0, 0.0]) @ m3.scale([6.0, 6.0, 0.2])))
    b.add(make_cube(0.8), np.asarray(m3.translate([0.0, 0.0, 3.0])))   # behind wall
    b.add(make_cube(0.8), np.asarray(m3.translate([8.0, 0.0, 3.0])))   # beside
    geom, objects = b.build()
    cam = make_camera(160, 96, (0, 0, -6.0), (0, 0, 0), fov=np.pi / 2)
    frustum = cull_scene(objects, cam.viewproj)
    occluders = jnp.asarray([True, False, False])
    vis = np.asarray(run_occlusion_pass(
        geom, objects, cam.viewproj, cam.zn, cam.zf, frustum,
        width=160, height=96, occluder_mask=occluders,
    ))
    assert vis[0]          # wall visible
    assert not vis[1]      # hidden cube culled
    assert vis[2]          # side cube kept


def test_occlusion_conservative_near_crossing():
    b = SceneBuilder()
    b.add(make_cube(1.0), np.asarray(m3.scale([6.0, 6.0, 0.2])))
    # Object straddling the camera position -> must stay visible.
    b.add(make_cube(1.0), np.asarray(m3.translate([0, 0, -6.0]) @ m3.scale(3.0)))
    geom, objects = b.build()
    cam = make_camera(64, 64, (0, 0, -6.0), (0, 0, 0))
    frustum = jnp.asarray([True, True])
    vis = np.asarray(run_occlusion_pass(
        geom, objects, cam.viewproj, cam.zn, cam.zf, frustum,
        width=64, height=64, occluder_mask=jnp.asarray([True, False]),
    ))
    assert vis[1]


def test_visibility_hysteresis():
    from lsr_tpu.geometry.volumes import update_visibility_history

    hist = jnp.full((3,), 10, jnp.int32)  # long-invisible
    vis = jnp.asarray([True, False, False])
    hist, eff = update_visibility_history(hist, vis, hold_frames=2)
    assert np.asarray(eff).tolist() == [True, False, False]
    # Object 1 becomes visible then flickers off: stays effective 2 frames.
    vis2 = jnp.asarray([True, True, False])
    hist, eff = update_visibility_history(hist, vis2, hold_frames=2)
    assert bool(eff[1])
    for _ in range(2):
        hist, eff = update_visibility_history(
            hist, jnp.asarray([True, False, False]), hold_frames=2)
        assert bool(eff[1])  # held
    hist, eff = update_visibility_history(
        hist, jnp.asarray([True, False, False]), hold_frames=2)
    assert not bool(eff[1])  # hold expired


def test_pcf_quad_path_matches_naive():
    import dataclasses
    from lsr_tpu.lighting.shadow_sample import make_shadow_context

    geom, objects = _shadow_scene()
    ctx_quad = make_sun_shadow(geom, objects, jnp.asarray(SUN, jnp.float32),
                               ShadowPassParams(map_size=256, pcf_radius=2))
    assert ctx_quad.depth_taps is not None
    ctx_naive = dataclasses.replace(ctx_quad, depth_taps=None)

    rng = np.random.default_rng(11)
    pts = jnp.asarray(rng.uniform([-2.5, -1.0, -2.5], [2.5, 1.5, 2.5],
                                  (1, 2048, 3)).astype(np.float32))
    ndl = jnp.ones((1, 2048), jnp.float32)
    v_q = np.asarray(shadow_visibility_dir(ctx_quad, pts, ndl))
    v_n = np.asarray(shadow_visibility_dir(ctx_naive, pts, ndl))
    # Identical except where the 5x5 window crosses the map border
    # (anchor-clamp vs per-tap-clamp); must be rare and small.
    diff = np.abs(v_q - v_n)
    assert (diff > 1e-6).mean() < 0.02
    assert diff.max() <= 4.0 / 25.0 + 1e-6


def test_pcf_packed_path_odd_map_size():
    """Strided-anchor windows must stay exact when the map size is not a
    multiple of the anchor stride (clamp-pad geometry edge cases)."""
    import dataclasses

    import jax.numpy as jnp

    from lsr_tpu.lighting.shadow_sample import make_shadow_context, \
        shadow_visibility_dir

    from lsr_tpu.lighting import shadow_sample as ss

    rng = np.random.default_rng(5)
    # Pin the u16 tap quantization off: this test proves the anchor-window
    # GEOMETRY exact (quantization tolerance is covered separately by
    # test_u16_taps_match_f32).
    old = ss.TAPS_U16
    ss.TAPS_U16 = False
    try:
        for size, stride in ((300, 8), (130, 4), (257, 8)):
            depth = jnp.asarray(rng.random((size, size), np.float32))
            vp = jnp.eye(4, dtype=jnp.float32)
            packed = make_shadow_context(depth, vp, pcf_radius=2,
                                         tap_stride=stride)
            naive = dataclasses.replace(packed, depth_taps=None)
            pts = jnp.asarray(
                rng.uniform(-0.999, 0.999, (1, 256, 3)).astype(np.float32))
            ndl = jnp.ones((1, 256), jnp.float32)
            va = np.asarray(shadow_visibility_dir(packed, pts, ndl))
            vb = np.asarray(shadow_visibility_dir(naive, pts, ndl))
            np.testing.assert_array_equal(va, vb), (size, stride)
    finally:
        ss.TAPS_U16 = old


def test_u16_taps_match_f32():
    """The u32-packed u16 tap path (4x smaller tables, half the gather
    lanes) must agree with the f32 packed path except at taps within one
    u16 quantum (1/65535) of the biased test depth — far below the 2e-3
    bias floor, so real scenes never straddle it systematically."""
    import dataclasses

    import jax.numpy as jnp

    from lsr_tpu.lighting import shadow_sample as ss

    rng = np.random.default_rng(7)
    depth = jnp.asarray(rng.random((256, 256), np.float32))
    vp = jnp.eye(4, dtype=jnp.float32)
    old = ss.TAPS_U16
    try:
        ss.TAPS_U16 = False
        ctx_f32 = ss.make_shadow_context(depth, vp, pcf_radius=2)
        ss.TAPS_U16 = True
        ctx_u16 = ss.make_shadow_context(depth, vp, pcf_radius=2)
    finally:
        ss.TAPS_U16 = old
    assert ctx_u16.depth_taps.dtype == jnp.uint32
    assert ctx_u16.depth_taps.shape[-1] * 2 == ctx_f32.depth_taps.shape[-1]

    pts = jnp.asarray(rng.uniform(-0.999, 0.999, (1, 2048, 3))
                      .astype(np.float32))
    ndl = jnp.asarray(rng.random((1, 2048), np.float32))
    va = np.asarray(shadow_visibility_dir(ctx_u16, pts, ndl))
    vb = np.asarray(shadow_visibility_dir(ctx_f32, pts, ndl))
    # Each flipped tap moves the lit fraction by 1/25; with uniform random
    # depths the flip probability per tap is ~2/65535, so whole-window
    # divergence is impossible and per-pixel diffs stay tiny and rare.
    diff = np.abs(va - vb)
    assert diff.max() <= 2.0 / 25.0 + 1e-6, diff.max()
    assert (diff > 1e-6).mean() < 0.01

    # Hard-shadow (radius 0 via _pcf_from_rows) and the local-shadow
    # consumer share count_lit; check the packer + counter directly against
    # an f32 reference on one window table.
    taps = ss.pack_shadow_taps(depth, 1, 6)
    packed = ss.pack_taps_u16(taps)
    z = jnp.asarray(rng.random((512,), np.float32))
    rows = jnp.asarray(rng.integers(0, taps.shape[0], 512, endpoint=False))
    mask = jnp.asarray(
        rng.random((512, taps.shape[1]), np.float32) > 0.5, jnp.float32)
    from lsr_tpu.core.gather import take_rows

    c16 = np.asarray(ss.count_lit(take_rows(packed, rows), z, mask))
    c32 = np.asarray(ss.count_lit(take_rows(taps, rows), z, mask))
    assert np.abs(c16 - c32).max() <= 2.0


def test_pack_shadow_taps_u16_quantize_at_source_identity():
    """pack_shadow_taps_u16 (quantize the map first, assemble windows at
    2 bytes/texel) must be BIT-identical to quantizing the assembled f32
    table — window assembly is pure data movement, so the two commute."""
    import jax.numpy as jnp

    from lsr_tpu.lighting import shadow_sample as ss

    rng = np.random.default_rng(11)
    for size, radius, stride in ((256, 2, 8), (130, 1, 6), (300, 2, 6),
                                 (256, 0, 8)):
        depth = jnp.asarray(rng.random((size, size), np.float32))
        a = np.asarray(ss.pack_shadow_taps_u16(depth, radius, stride))
        b = np.asarray(ss.pack_taps_u16(
            ss.pack_shadow_taps(depth, radius, stride)))
        assert a.dtype == np.uint32 and (a == b).all(), (size, radius,
                                                         stride)
