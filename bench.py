"""Flagship benchmark: Forward+ tiled, 256 lights, 25 seeded heads @1080p.

Mirrors the reference's flagship workload (hello_rendering_paths.cpp:89-99:
1280x720 default / our north-star 1920x1080, 16-px light tiles, <=128 lights
per tile) measured Phase-F style (warmup + sampled frames).

The frame is the flagship composition (hello_rendering_paths.cpp:8360 frame
structure): per-frame frustum + occlusion cull, sun shadow map and the
8-spot/2-point local shadow atlas re-rendered every frame, raster, G-buffer
interp, forward+ (sun with shadow visibility + 256 binned local lights),
tonemap and FXAA, with a moving camera so no frame-invariant work can be
hoisted.  The scene is generated from a seed (lsr_tpu/resources/assets.py).

Runs on the GPU only (exits non-zero elsewhere).  Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}; vs_baseline is
against the 60 FPS north-star target (BASELINE.md), since the reference
publishes no numbers.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import json

import numpy as np

SCENE_SEED = 42


def build_scene(seed: int = SCENE_SEED):
    """25 head meshes on a 5x5 grid + ground plane, 256 lights (8 spot and
    2 point shadow casters first), PBR materials, checker-textured ground."""
    import jax.numpy as jnp

    from lsr_tpu.lighting.light_types import LightSetBuilder
    from lsr_tpu.resources.assets import instanced_grid_scene, make_head_mesh
    from lsr_tpu.shading.common import checkerboard_texture, make_materials
    from lsr_tpu.shading.models import make_shade_context

    geom, objects = instanced_grid_scene(make_head_mesh(seed), grid=5,
                                         spacing=2.4, seed=seed, ground=10.0)

    rng = np.random.default_rng(seed + 1)
    lb = LightSetBuilder()
    n_lights = int(os.environ.get("LSR_BENCH_LIGHTS", "256"))
    # The shadow budget picks the FIRST 8 spots + 2 points in visit order
    # (plan_shadow_casters); emit those first so the budgeted casters sit
    # over the scene like the reference workload.
    for i in range(8):
        x, z = float(rng.uniform(-5, 5)), float(rng.uniform(-5, 5))
        color = tuple(rng.uniform(0.2, 1.0, 3).tolist())
        lb.spot((x, 3.0, z), (0, -1, 0), color=color, intensity=2.4,
                range=5.0, inner_angle=0.4, outer_angle=0.7)
    for i in range(2):
        x, z = float(rng.uniform(-3, 3)), float(rng.uniform(-3, 3))
        lb.point((x, 1.2, z), color=tuple(rng.uniform(0.2, 1.0, 3).tolist()),
                 intensity=1.8, range=3.5)
    for i in range(max(0, n_lights - 10)):
        x = float(rng.uniform(-7, 7))
        z = float(rng.uniform(-7, 7))
        y = float(rng.uniform(0.2, 2.2))
        color = tuple(rng.uniform(0.2, 1.0, 3).tolist())
        if i % 4 == 0:
            lb.spot((x, y + 1.0, z), (0, -1, 0), color=color, intensity=2.0,
                    range=3.5, inner_angle=0.35, outer_angle=0.6)
        else:
            lb.point((x, y, z), color=color, intensity=1.5, range=2.5)
    lights = lb.build()

    eye = (6.0, 6.5, -10.0)
    mats = make_materials(
        base_color=[(0.85, 0.5, 0.3), (0.4, 0.65, 0.85), (0.6, 0.8, 0.45),
                    (0.9, 0.85, 0.5), (0.5, 0.5, 0.55)],
        metallic=[0.05, 0.4, 0.0, 0.8, 0.0],
        roughness=[0.4, 0.25, 0.7, 0.35, 0.9],
        tex_id=[-1, -1, -1, -1, 0],
    )
    ctx = make_shade_context(
        mats, light_dir_ws=(0.35, -0.75, 0.45), light_color=(1.0, 0.96, 0.9),
        light_intensity=2.0, camera_pos=eye,
        textures=jnp.asarray(checkerboard_texture(128))[None],
    )
    return geom, objects, lights, ctx, eye


def orbit_camera(ctx, eye0, i, width, height):
    """Frame i of the orbiting camera: every frame distinct, nothing
    hoistable.  Returns (camera, shade context at that eye)."""
    import dataclasses

    import jax.numpy as jnp

    from lsr_tpu.scene.scene import make_camera

    ang = 0.02 * i
    eye = (float(eye0[0] * np.cos(ang) - eye0[2] * np.sin(ang)),
           float(eye0[1]),
           float(eye0[0] * np.sin(ang) + eye0[2] * np.cos(ang)))
    cam = make_camera(width, height, eye, (0, 0, 0), fov=np.pi / 3.2)
    return cam, dataclasses.replace(ctx, camera_pos=jnp.asarray(eye,
                                                                jnp.float32))


def make_flagship_frame(geom, objects, lights, ctx, width, height,
                        shadow_size=1024, local_map=512, local_point=256,
                        vis_scale=2, shadow_filter="esm", use_kernels=True):
    """The flagship frame fn (hello_rendering_paths.cpp:8360 structure):
    per-frame cull -> sun + local shadow atlas -> raster -> forward+ ->
    tonemap -> FXAA.

    The defaults are the ESM stack: prefiltered sun + local maps at sun
    1024^2, spot 512^2, point 6x256^2 and sun and local visibility at half
    resolution (vis_scale), cropped to default_vis_crop.
    shadow_filter="pcf" with 2048/1024/512 and vis_scale=1 is the
    reference-exact configuration (hello_rendering_paths.cpp:104-109).

    use_kernels=False composes the same frame from the plain XLA
    references: rasterize_brute for every raster and
    shade_forward_plus(use_kernel=False).

    Returns (frame(cam, ctx) -> outputs, spot_ids, point_ids)."""
    import dataclasses

    import jax.numpy as jnp

    from lsr_tpu.core.frame import ShadowPassParams
    from lsr_tpu.geometry.occlusion import (
        occlusion_cull_aabbs, render_occluder_depth)
    from lsr_tpu.geometry.volumes import frustum_cull_objects
    from lsr_tpu.lighting.light_culling import cull_lights_camera
    from lsr_tpu.lighting.local_shadows import (
        default_vis_crop, plan_shadow_casters, render_local_shadow_maps)
    from lsr_tpu.lighting.shadow_sample import make_shadow_context
    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.passes.post import fxaa_pass
    from lsr_tpu.passes.shadow import render_shadow_map
    from lsr_tpu.passes.tonemap import tonemap_pass
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import object_world_aabbs

    sun_dir = np.asarray([0.35, -0.75, 0.45], np.float32)
    shadow_params = ShadowPassParams(map_size=shadow_size, pcf_radius=2)
    spot_ids, point_ids = plan_shadow_casters(lights)
    vis_crop = default_vis_crop(height, width)

    def frame(cam, ctx_t):
        # Per-frame frustum + occlusion scene cull (:94-97), and the same
        # proxies cull the light set: culled lights drop out of the bins
        # AND out of the local-shadow atlas/vis work.
        wmin, wmax = object_world_aabbs(objects)
        vis = objects.visible & frustum_cull_objects(cam.viewproj, wmin, wmax)
        occ = render_occluder_depth(
            geom, objects, cam.viewproj, cam.zn, cam.zf, 320, 180,
            occluder_mask=vis, use_tiled=use_kernels)
        vis = vis & occlusion_cull_aabbs(
            occ, cam.viewproj, wmin, wmax, cam.zn, cam.zf)
        objs = dataclasses.replace(objects, visible=vis)
        lmask = cull_lights_camera(lights, cam.viewproj, occ_depth=occ,
                                   zn=cam.zn, zf=cam.zf)
        lights_f = dataclasses.replace(lights, enabled=lights.enabled & lmask)
        caster_en = None
        ids = list(spot_ids) + list(point_ids)
        if ids:
            caster_en = lights_f.enabled[jnp.asarray(ids)]

        local_sh = None
        if ids:
            local_sh = render_local_shadow_maps(
                geom, objects, lights_f, spot_ids, point_ids,
                map_size=local_map, point_size=local_point,
                # The reference flagship samples spot AND point shadows at
                # the sun's pcf radius 2 (hello_rendering_paths.cpp:6397,
                # :6650 pass sun_shadow_params.w=2.0 per light).
                pcf_radius=2, vis_scale=vis_scale, vis_crop=vis_crop,
                caster_enabled=caster_en, filter_mode=shadow_filter,
                use_tiled=use_kernels)

        sm_depth, light_vp = render_shadow_map(
            geom, objects, jnp.asarray(sun_dir), map_size=shadow_size,
            use_tiled=use_kernels)
        shadow_ctx = make_shadow_context(
            sm_depth, light_vp,
            bias_const=shadow_params.bias_const,
            bias_slope=shadow_params.bias_slope,
            strength=shadow_params.strength,
            pcf_radius=shadow_params.pcf_radius,
            pcf_step=shadow_params.pcf_step,
            filter_mode=shadow_filter,
        )
        ctx_sh = dataclasses.replace(ctx_t, shadow=shadow_ctx)

        setup = scene_setup(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objs.model, objs.normal_mat,
            cam.viewproj, width, height, obj_visible=objs.visible,
        )
        if use_kernels:
            depth, tid, max_bin = rasterize_direct(
                setup, width, height, cam.zn, cam.zf, spatial_sort=True)
        else:
            depth, tid = rasterize_brute(setup, width, height, cam.zn,
                                         cam.zf)
            max_bin = jnp.int32(0)
        gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials,
                                 want_face_normal=False)
        hdr, stats = shade_forward_plus(
            gb, ctx_sh, lights_f, cam.view, cam.proj, cam.zn, cam.zf,
            width, height, tile_size=16, cap=128,
            # tiled_depth_range: per-tile depth bounds shorten the lists.
            mode="tiled_depth_range",
            sun_model="pbr_mr",
            local_shadows=local_sh,
            sun_vis_scale=vis_scale,
            use_kernel=use_kernels,
        )
        ldr = fxaa_pass(tonemap_pass(hdr))
        n_valid = jnp.sum(setup.valid)
        return (ldr, n_valid, max_bin, stats["max_lights_per_bin"],
                stats["overflow_bins"])

    return frame, spot_ids, point_ids


def main():
    import jax

    from lsr_tpu.core.device import (
        device_summary, enable_compile_cache, require_gpu)

    require_gpu()
    enable_compile_cache()

    width = int(os.environ.get("LSR_BENCH_W", "1920"))
    height = int(os.environ.get("LSR_BENCH_H", "1080"))
    frames = int(os.environ.get("LSR_BENCH_FRAMES", "60"))
    warmup = int(os.environ.get("LSR_BENCH_WARMUP", "10"))
    sf = os.environ.get("LSR_BENCH_SHADOW_FILTER", "esm")
    esm = sf == "esm"
    # "pcf" restores the reference budgets (sun 2048^2, spot 1024^2, point
    # 512^2, full-res vis; hello_rendering_paths.cpp:104-109) and the
    # exact window-PCF filter.
    shadow_size, local_map, local_point, vis_scale = (
        (1024, 512, 256, 2) if esm else (2048, 1024, 512, 1))

    geom, objects, lights, ctx, eye0 = build_scene()
    frame, spot_ids, point_ids = make_flagship_frame(
        geom, objects, lights, ctx, width, height,
        shadow_size=shadow_size, local_map=local_map,
        local_point=local_point, vis_scale=vis_scale, shadow_filter=sf)
    frame_j = jax.jit(frame)

    # Every frame's camera/context is staged on the device before timing.
    staged = [jax.device_put(orbit_camera(ctx, eye0, i, width, height))
              for i in range(warmup + frames)]

    ldr, n_valid, max_bin, max_lights, overflow = jax.block_until_ready(
        frame_j(*staged[0]))
    tris = int(n_valid)
    print(
        f"# compile ok: {tris} tris, max_supers_per_tile={int(max_bin)}, "
        f"max_lights_per_tile={int(max_lights)}, "
        f"overflowed_bins={int(overflow)}",
        file=sys.stderr,
    )

    for i in range(warmup):
        out = frame_j(*staged[i])
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    for i in range(frames):
        out = frame_j(*staged[warmup + i])
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    fps = frames / dt
    wk = (f"shadow {shadow_size} + local atlas {len(spot_ids)}x{local_map}"
          f"+{len(point_ids)}x6x{local_point} + cull 320x180 + {sf} filter")
    print(
        f"# {fps:.2f} fps ({dt / frames * 1000:.2f} ms/frame), "
        f"{tris * fps / 1e6:.2f} Mtris/s at {width}x{height} "
        f"(full frame: {wk} + forward+ + tonemap + fxaa)",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": (f"flagship_{width}x{height}_{lights.count}lights"
                   f"_shadow{shadow_size}_{sf}_fps"),
        "value": fps,
        "unit": "fps",
        "vs_baseline": fps / 60.0,
        "device": device_summary(),
    }))


if __name__ == "__main__":
    main()
