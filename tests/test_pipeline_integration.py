"""End-to-end: the 5 render-path presets through the real pass library.

The analog of the reference's Phase-I composition sweep
(hello_rendering_paths.cpp:389-414): compile each preset recipe, plan it,
execute it on a real scene, and check the produced image.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lsr_tpu.core import math3d as m3
from lsr_tpu.core.frame import FrameParams, LightCullingMode, TechniqueMode
from lsr_tpu.io.obj import make_plane
from lsr_tpu.lighting.light_types import LightSetBuilder
from lsr_tpu.passes.standard_passes import make_standard_registry
from lsr_tpu.pipeline.executor import RenderContext
from lsr_tpu.pipeline.pipeline import PluggablePipeline
from lsr_tpu.pipeline.recipe import builtin_render_path_presets, compile_recipe
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import make_materials
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu.resources.assets import make_head_mesh


_MODE_FOR = {
    "forward_classic": TechniqueMode.FORWARD,
    "forward_plus": TechniqueMode.FORWARD_PLUS,
    "deferred": TechniqueMode.DEFERRED,
    "tiled_deferred": TechniqueMode.TILED_DEFERRED,
    "clustered_forward": TechniqueMode.CLUSTERED_FORWARD,
}


def _scene_state(w, h):
    sb = SceneBuilder()
    sb.add(make_head_mesh(), np.asarray(m3.translate([0, 0.2, 0])))
    sb.add(make_plane(6.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build()
    cam = make_camera(w, h, (0.5, 1.5, -4.0), (0, 0, 0))
    lb = LightSetBuilder()
    rng = np.random.default_rng(1)
    for _ in range(24):
        lb.point(tuple(rng.uniform([-3, 0.2, -3], [3, 2, 3]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.5, range=2.5)
    mats = make_materials(base_color=[(0.8, 0.5, 0.3), (0.5, 0.55, 0.6)],
                          roughness=[0.4, 0.8])
    ctx = make_shade_context(mats, light_dir_ws=(0.35, -0.7, 0.5),
                             camera_pos=(0.5, 1.5, -4.0), light_intensity=2.0)
    return {
        "geom": geom, "objects": objects, "camera": cam,
        "lights": lb.build(), "shade_ctx": ctx,
    }


@pytest.mark.parametrize("preset", builtin_render_path_presets(),
                         ids=lambda p: p.name)
def test_preset_renders(preset):
    w, h = 96, 64
    reg = make_standard_registry()
    fp = FrameParams(width=w, height=h)
    fp.technique.mode = _MODE_FOR[preset.name]
    fp.technique.light_culling = preset.light_culling
    fp.technique.tile_size = 16
    fp.technique.cluster_slices = 8
    fp.technique.max_lights_per_tile = 32
    fp.pass_params.shadow.map_size = 128

    pipe = PluggablePipeline(preexisting_semantics=())
    report = pipe.configure_from_recipe(preset, reg)
    assert report.ok, (preset.name, report.errors)

    plan = pipe.build_plan(fp)
    assert plan.ok, (preset.name, plan.errors)

    ctx = RenderContext()
    state = pipe.execute(ctx, _scene_state(w, h), fp)
    assert "ldr" in state, preset.name
    img = np.asarray(state["ldr"])
    assert img.shape == (h, w, 3)
    cov = np.asarray(state["gbuffer"].covered)
    assert cov.sum() > 1000
    assert img[cov].std() > 5.0  # actually shaded, not flat
    # Per-pass timings were recorded (PipelineRuntimeExecutor analog).
    assert "tonemap" in ctx.debug.pass_ms


def test_full_post_stack_runs():
    w, h = 96, 64
    reg = make_standard_registry()
    from lsr_tpu.pipeline.recipe import POST_STACK_PRESETS, RenderPathRecipe

    recipe = RenderPathRecipe(
        name="full", technique=TechniqueMode.FORWARD_PLUS,
        light_culling=LightCullingMode.TILED, shadows=True,
        post_stack=POST_STACK_PRESETS["full"],
    )
    fp = FrameParams(width=w, height=h)
    fp.technique.mode = TechniqueMode.FORWARD_PLUS
    fp.technique.tile_size = 16
    fp.technique.max_lights_per_tile = 32
    fp.pass_params.shadow.map_size = 128
    fp.enable_motion_vectors = True
    fp.enable_motion_blur = True
    fp.enable_light_shafts = True
    fp.enable_dof = True
    fp.enable_bloom = True
    fp.enable_taa = True
    fp.enable_fxaa = True

    pipe = PluggablePipeline(preexisting_semantics=())
    report = pipe.configure_from_recipe(recipe, reg)
    assert report.ok, report.errors
    plan = pipe.build_plan(fp)
    assert plan.ok, plan.errors
    order = [pipe.passes[i].pass_id for i in plan.order]
    assert order[-1] == "fxaa" and order[-2] == "tonemap"

    ctx = RenderContext()
    state = pipe.execute(ctx, _scene_state(w, h), fp)
    img = np.asarray(state["ldr"])
    assert np.isfinite(img.astype(np.float64)).all()
    assert img.std() > 5.0

    # Run a second frame: TAA history persists without shape errors.
    state2 = pipe.execute(ctx, _scene_state(w, h), fp)
    assert np.asarray(state2["ldr"]).shape == (h, w, 3)
    pipe.reset_history()


def test_debug_views_through_pipeline():
    from lsr_tpu.core.frame import DebugViewMode

    w, h = 64, 48
    reg = make_standard_registry()
    preset = builtin_render_path_presets()[0]
    fp = FrameParams(width=w, height=h)
    fp.technique.mode = TechniqueMode.FORWARD
    fp.pass_params.shadow.map_size = 64
    pipe = PluggablePipeline(preexisting_semantics=())
    assert pipe.configure_from_recipe(preset, reg).ok
    for mode in (DebugViewMode.ALBEDO, DebugViewMode.NORMAL, DebugViewMode.DEPTH):
        fp.debug_view = mode
        state = pipe.execute(RenderContext(), _scene_state(w, h), fp)
        assert np.asarray(state["ldr"]).shape == (h, w, 3)


def test_jitted_execution_matches_eager():
    """execute_jitted (whole-plan jit) must equal the instrumented path."""
    w, h = 96, 64
    reg = make_standard_registry()
    preset = builtin_render_path_presets()[1]  # forward_plus
    fp = FrameParams(width=w, height=h)
    fp.technique.mode = _MODE_FOR[preset.name]
    fp.technique.light_culling = preset.light_culling
    fp.technique.tile_size = 16
    fp.technique.max_lights_per_tile = 32
    fp.pass_params.shadow.map_size = 128
    fp.enable_taa = False

    pipe = PluggablePipeline(preexisting_semantics=())
    assert pipe.configure_from_recipe(preset, reg).ok

    state = _scene_state(w, h)
    eager = pipe.execute(RenderContext(), dict(state), fp)
    jitted = pipe.execute_jitted(RenderContext(), dict(state), fp)
    np.testing.assert_array_equal(np.asarray(eager["ldr"]),
                                  np.asarray(jitted["ldr"]))

    # TAA history persists across jitted frames via pipeline state.
    fp.enable_taa = True
    fp.enable_motion_vectors = True
    pipe2 = PluggablePipeline(preexisting_semantics=())
    from lsr_tpu.pipeline.recipe import RenderPathRecipe, compile_recipe

    r = RenderPathRecipe(name="taa", technique=fp.technique.mode,
                         light_culling=fp.technique.light_culling,
                         shadows=False, post_stack=("taa",))
    assert pipe2.configure_from_recipe(r, reg).ok
    out1 = pipe2.execute_jitted(RenderContext(), dict(state), fp)
    assert "history_color" in out1
    out2 = pipe2.execute_jitted(RenderContext(), dict(state), fp)
    assert np.isfinite(np.asarray(out2["ldr"]).astype(np.float64)).all()
    pipe2.reset_history()


def test_flagship_workload_culling_and_local_shadows():
    """The reference-complete flagship frame through a preset: per-frame
    scene+light culling (hello_rendering_paths.cpp:94-97) and the budgeted
    local shadow atlas (:104-109) both run inside the pipeline."""
    import dataclasses

    from lsr_tpu.io.obj import make_cube
    from lsr_tpu.lighting.local_shadows import plan_shadow_casters

    w, h = 96, 64
    sb = SceneBuilder()
    sb.add(make_head_mesh(), np.asarray(m3.translate([0, 0.2, 0])))
    sb.add(make_cube(0.8), np.asarray(m3.translate([1.2, 0.3, 0.5])))
    # Behind the camera: frustum culling must drop it from the view (but it
    # may still cast shadows).
    sb.add(make_head_mesh(), np.asarray(m3.translate([0.5, 1.5, -9.0])))
    sb.add(make_plane(6.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build()
    cam = make_camera(w, h, (0.5, 1.5, -4.0), (0, 0, 0))
    lb = LightSetBuilder()
    lb.spot((1.2, 3.0, 0.5), (0, -1, 0), intensity=6.0, range=8.0,
            inner_angle=0.5, outer_angle=1.0)
    lb.point((0.0, 1.2, 1.5), intensity=3.0, range=6.0)
    # A far-away light the frustum light-culling should disable.
    lb.point((80.0, 1.0, 80.0), intensity=3.0, range=2.0)
    lights = lb.build()
    mats = make_materials(base_color=[(0.8, 0.5, 0.3), (0.5, 0.55, 0.6)],
                          roughness=[0.4, 0.8])
    ctx = make_shade_context(mats, light_dir_ws=(0.35, -0.7, 0.5),
                             camera_pos=(0.5, 1.5, -4.0), light_intensity=2.0)
    state0 = {"geom": geom, "objects": objects, "camera": cam,
              "lights": lights, "shade_ctx": ctx}

    spot_ids, point_ids = plan_shadow_casters(lights)
    assert spot_ids == (0,) and 1 in point_ids

    preset = builtin_render_path_presets()[1]  # forward_plus, full workload
    reg = make_standard_registry()
    fp = FrameParams(width=w, height=h)
    fp.technique.mode = TechniqueMode.FORWARD_PLUS
    fp.technique.light_culling = preset.light_culling
    fp.technique.tile_size = 16
    fp.technique.max_lights_per_tile = 32
    fp.pass_params.shadow.map_size = 128
    fp.pass_params.local_shadow = dataclasses.replace(
        fp.pass_params.local_shadow, spot_ids=spot_ids,
        point_ids=point_ids, map_size=128, point_size=64)

    pipe = PluggablePipeline(preexisting_semantics=())
    assert pipe.configure_from_recipe(preset, reg).ok
    order = [p.pass_id for p in pipe.passes]
    assert order[0] == "scene_cull" and "local_shadows" in order

    ctx_rt = RenderContext()
    state = pipe.execute(ctx_rt, dict(state0), fp)
    img_sh = np.asarray(state["ldr"])

    # Culling: the behind-camera monkey is view-culled; others visible.
    vm = np.asarray(state["view_mask"])
    assert not vm[2] and vm[0] and vm[1] and vm[3]
    # Light culling disabled the far light, kept the near ones.
    le = np.asarray(state["lights"].enabled)
    assert le[0] and le[1] and not le[2]
    # Local shadow maps were rendered (1 spot + 2 points x 6 cube faces —
    # the static budget includes the far light; only per-frame culling
    # disables it).
    sh = state["local_shadow_maps"]
    assert sh is not None and sh.n_slots == 13

    # Local shadows darken: re-run with the atlas disabled.
    fp2 = FrameParams(width=w, height=h)
    fp2.technique.mode = fp.technique.mode
    fp2.technique.light_culling = fp.technique.light_culling
    fp2.technique.tile_size = 16
    fp2.technique.max_lights_per_tile = 32
    fp2.pass_params.shadow.map_size = 128
    fp2.pass_params.local_shadow = dataclasses.replace(
        fp2.pass_params.local_shadow, enabled=False)
    pipe2 = PluggablePipeline(preexisting_semantics=())
    assert pipe2.configure_from_recipe(preset, reg).ok
    img_ns = np.asarray(pipe2.execute(RenderContext(), dict(state0),
                                      fp2)["ldr"])
    diff = img_ns.astype(np.int32).sum(-1) - img_sh.astype(np.int32).sum(-1)
    assert (diff > 8).sum() > 20, f"local shadows changed {(diff>8).sum()} px"

    # Backend parity: brute anchor matches the tiled kernel bit-exactly on
    # the full workload (Phase-I property).
    fp.use_tiled_raster = False
    pipe3 = PluggablePipeline(preexisting_semantics=())
    assert pipe3.configure_from_recipe(preset, reg).ok
    img_brute = np.asarray(pipe3.execute(RenderContext(), dict(state0),
                                         fp)["ldr"])
    np.testing.assert_array_equal(img_sh, img_brute)


def test_segmented_execution_times_passes():
    """execute_segmented (per-pass jit, device-honest timing) must produce
    the same frame as the instrumented path and record a per-pass ms for
    every executed pass."""
    w, h = 96, 64
    reg = make_standard_registry()
    preset = builtin_render_path_presets()[1]  # forward_plus
    fp = FrameParams(width=w, height=h)
    fp.technique.mode = _MODE_FOR[preset.name]
    fp.technique.light_culling = preset.light_culling
    fp.technique.tile_size = 16
    fp.technique.max_lights_per_tile = 32
    fp.pass_params.shadow.map_size = 128
    fp.enable_taa = False

    pipe = PluggablePipeline(preexisting_semantics=())
    assert pipe.configure_from_recipe(preset, reg).ok

    state = _scene_state(w, h)
    eager = pipe.execute(RenderContext(), dict(state), fp)
    ctx = RenderContext()
    seg = pipe.execute_segmented(ctx, dict(state), fp, reps=2)
    np.testing.assert_allclose(np.asarray(seg["ldr"]),
                               np.asarray(eager["ldr"]), atol=1)
    executed = [p.pass_id for p in pipe.passes
                if p.pass_id in ctx.debug.pass_ms]
    assert len(executed) >= 5, ctx.debug.pass_ms
    assert all(np.isfinite(v) for v in ctx.debug.pass_ms.values())


@pytest.mark.slow
def test_preset_esm_filter_mode():
    """FrameParams filter_mode="esm" (the r4 production stack: prefiltered
    sun + local maps, half-res vis planes) runs through the preset pipeline
    and stays close to the exact-PCF image (penumbra-only deltas)."""
    import dataclasses

    from lsr_tpu.lighting.local_shadows import plan_shadow_casters

    w, h = 96, 64
    state0 = _scene_state(w, h)
    spot_ids, point_ids = plan_shadow_casters(state0["lights"])
    preset = builtin_render_path_presets()[1]  # forward_plus
    reg = make_standard_registry()

    imgs = {}
    for mode, vs in (("pcf", 1), ("esm", 2)):
        fp = FrameParams(width=w, height=h)
        fp.technique.mode = TechniqueMode.FORWARD_PLUS
        fp.technique.light_culling = preset.light_culling
        fp.technique.tile_size = 16
        fp.technique.max_lights_per_tile = 32
        fp.pass_params.shadow = dataclasses.replace(
            fp.pass_params.shadow, map_size=128, filter_mode=mode,
            sun_vis_scale=vs)
        fp.pass_params.local_shadow = dataclasses.replace(
            fp.pass_params.local_shadow, spot_ids=spot_ids,
            point_ids=point_ids, map_size=128, point_size=64,
            filter_mode=mode, vis_scale=vs)
        pipe = PluggablePipeline(preexisting_semantics=())
        assert pipe.configure_from_recipe(preset, reg).ok
        imgs[mode] = np.asarray(
            pipe.execute(RenderContext(), dict(state0), fp)["ldr"])

    d = np.abs(imgs["esm"].astype(np.int32) - imgs["pcf"].astype(np.int32))
    frac_big = (d.max(-1) > 8).mean()
    assert frac_big < 0.10, f"esm diverged on {frac_big:.1%} of pixels"
    assert d.max() > 0 or True  # identical is fine too at this scale
