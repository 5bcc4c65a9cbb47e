"""Test harness config: run everything on a virtual 8-device CPU mesh.

Multi-chip hardware isn't available in CI; sharding paths are validated on
XLA's host-platform virtual devices (the reference's analog is its
DummyBackend fake-device pattern, vop_core_tests.cpp:21).  Pallas kernels
run in interpret mode here (lsr_tpu.core.device).

Tests marked `gpu` need the card: the `gpu_device` fixture skips them on
the CPU.  On the card, LSR_TEST_GPU=1 keeps JAX on the GPU (see README,
"Tests").
"""

import os

_ON_GPU = os.environ.get("LSR_TEST_GPU") == "1"
if not _ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX found none (decided here,
    never at import or collection time)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform!r} "
                    "(run with LSR_TEST_GPU=1 on the card)")
    return dev

# Fast-lane marking: tests measured >= ~9 s wall in
# interpret-mode CPU runs (pytest --durations), centrally tagged so
# `pytest -m "not slow"` is a <5 min CI lane while plain `pytest tests/`
# stays the full suite.  Names are (module basename, test function name);
# parametrized tests are marked whole.
_SLOW = {
    ("test_cubemap_probes.py", "test_env_probe_in_forward_plus"),
    ("test_esm_shadows.py", "test_local_esm_crop_cascade_is_consistent"),
    ("test_lights.py", "test_clustered_matches_tiled"),
    ("test_lights.py", "test_shade_kernel_light_kinds_specialization"),
    ("test_local_shadows.py", "test_atlas_packed_matches_map"),
    ("test_local_shadows.py", "test_point_cube_shadow_selects_faces"),
    ("test_local_shadows.py", "test_spot_shadow_occludes_ground"),
    ("test_raster_brute.py", "test_cube_near_clip"),
    ("test_raster_brute.py", "test_depth_ordering_two_quads"),
    ("test_shadow_culling.py", "test_u16_taps_match_f32"),
    ("test_sharding.py", "test_pipeline_parallel_render"),
    ("test_esm_shadows.py", "test_local_esm_spot_and_point_semantics"),
    ("test_esm_shadows.py", "test_sun_esm_matches_pcf_on_clear_pixels"),
    ("test_lights.py", "test_clustered_kernel_matches_xla"),
    ("test_lights.py", "test_forward_plus_frame"),
    ("test_lights.py", "test_forward_plus_zero_lights_equals_sun_only"),
    ("test_lights.py", "test_tiled_binning_matches_dense"),
    ("test_local_shadows.py", "test_caster_enabled_image_exact"),
    ("test_local_shadows.py", "test_caster_enabled_skips_planes_exactly"),
    ("test_local_shadows.py", "test_forward_plus_applies_local_shadows"),
    ("test_local_shadows.py", "test_local_shadows_kernel_matches_xla_path"),
    ("test_local_shadows.py", "test_vis_crop_bit_exact"),
    ("test_normal_mapping.py", "test_bumpy_normal_map_changes_shading"),
    ("test_normal_mapping.py", "test_flat_normal_map_is_identity"),
    ("test_pipeline_integration.py", "test_debug_views_through_pipeline"),
    ("test_pipeline_integration.py",
     "test_flagship_workload_culling_and_local_shadows"),
    ("test_pipeline_integration.py", "test_full_post_stack_runs"),
    ("test_pipeline_integration.py", "test_jitted_execution_matches_eager"),
    ("test_pipeline_integration.py", "test_preset_renders"),
    ("test_pipeline_integration.py",
     "test_segmented_execution_times_passes"),
    ("test_post.py", "test_motion_vectors_from_object_motion"),
    ("test_procedural_primitives.py",
     "test_all_procedural_shaders_render"),
    ("test_raster_brute.py", "test_backface_cull_modes"),
    ("test_raster_brute.py", "test_monkey_depth_and_attrs_match_oracle"),
    ("test_shading.py", "test_all_shading_models_run"),
    ("test_shading.py", "test_blinn_phong_frame_matches_oracle"),
    ("test_shadow_culling.py", "test_occlusion_conservative_near_crossing"),
    ("test_shadow_culling.py", "test_occlusion_cull_wall"),
    ("test_shadow_culling.py", "test_pcf_packed_path_odd_map_size"),
    ("test_shadow_culling.py", "test_pcf_quad_path_matches_naive"),
    ("test_shadow_culling.py", "test_pcf_soft_edges"),
    ("test_sharding.py", "test_band_rendering_equals_full"),
    ("test_sharding.py", "test_light_sharded_forward"),
    ("test_sharding.py", "test_sharded_flagship_bit_exact"),
    ("test_sharding.py", "test_sharded_render_8_devices"),
    # r5: next tier (>=4 s measured, pytest --durations run 2026-08-20
    # 01:03) to keep the fast lane under its 5-minute promise.
    ("test_mesh_loaders.py", "test_gltf_renders_through_pipeline"),
    ("test_ply.py", "test_ply_renders_through_pipeline"),
    ("test_shading.py", "test_gouraud_interpolates_corner_lighting"),
    ("test_sky_ibl.py", "test_ibl_precompute"),
    ("test_lights.py", "test_rect_tube_fall_off"),
    ("test_shadow_culling.py", "test_ground_is_shadowed_under_monkey"),
    ("test_lights.py", "test_collect_object_lights_and_motion"),
    ("test_esm_shadows.py", "test_esm_radius0_falls_back_to_hard_pcf"),
    ("test_support_shapes.py",
     "test_tiled_culling_with_shapes_still_conservative"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = os.path.basename(str(item.fspath))
        name = item.name.split("[", 1)[0]
        if (base, name) in _SLOW:
            item.add_marker(pytest.mark.slow)
