"""Per-stage timing of the flagship frame on the GPU.

Times each stage of the flagship composition (sun shadow + raster + interp
+ forward+ + tonemap + FXAA, cull, local atlas) separately at the bench
workload, each stage jitted on its own, so optimization effort lands where
the milliseconds are.  The sum of stages is not the fused frame's time.

Usage: python scripts/profile_frame.py [--w 1920 --h 1080 --iters 20]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(name, fn, *args, iters=20):
    """Mean ms per call after one warm call; one block at the end."""
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1000.0 / iters
    print(f"{name:36s} {ms:8.3f} ms", flush=True)
    return out, ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--h", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--lights", type=int, default=256)
    ap.add_argument("--shadow", type=int, default=2048)
    args = ap.parse_args()

    os.environ["LSR_BENCH_LIGHTS"] = str(args.lights)
    import bench
    from lsr_tpu.core.device import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()

    from lsr_tpu.lighting.shadow_sample import (
        make_shadow_context, pack_shadow_taps, shadow_visibility_dir)
    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.passes.post import fxaa_pass
    from lsr_tpu.passes.shadow import render_shadow_map
    from lsr_tpu.passes.tonemap import tonemap_pass
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import make_camera

    w, h = args.w, args.h
    geom, objects, lights, ctx, eye = bench.build_scene()
    cam = make_camera(w, h, eye, (0, 0, 0), fov=np.pi / 3.2)
    sun_dir = np.asarray([0.35, -0.75, 0.45], np.float32)

    it = args.iters
    total = 0.0

    f_setup = jax.jit(lambda vp: scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        vp, w, h))
    setup, ms = timeit("scene_setup", f_setup, cam.viewproj, iters=it)
    total += ms
    print(f"  tris: {int(jnp.sum(setup.valid))}")

    f_shadow = jax.jit(lambda: render_shadow_map(
        geom, objects, jnp.asarray(sun_dir), map_size=args.shadow))
    (sm_depth, light_vp), ms = timeit(
        f"shadow_map_{args.shadow} (incl setup)", f_shadow, iters=it)
    total += ms

    f_taps = jax.jit(lambda d: pack_shadow_taps(d, 2))
    taps, ms = timeit("pack_shadow_taps r2", f_taps, sm_depth, iters=it)
    total += ms

    f_raster = jax.jit(lambda s: rasterize_direct(
        s, w, h, cam.zn, cam.zf, spatial_sort=True))
    (depth, tid, max_sup), ms = timeit("rasterize_direct", f_raster, setup,
                                       iters=it)
    total += ms

    f_interp = jax.jit(lambda s, d, t: interpolate_gbuffer(
        s, d, t, materials=ctx.materials))
    gb, ms = timeit("interpolate_gbuffer", f_interp, setup, depth, tid,
                    iters=it)
    total += ms

    # The shadow context (incl. the packed tap table) is a jit ARGUMENT:
    # closed-over big arrays would be embedded as compile-time constants.
    shadow_ctx = make_shadow_context(sm_depth, light_vp)

    f_vis = jax.jit(lambda sc, g: shadow_visibility_dir(
        sc, g.world_pos, jnp.ones_like(g.depth01)))
    _, ms = timeit("shadow_visibility (PCF r2 packed)", f_vis, shadow_ctx,
                   gb, iters=it)
    total += ms

    import dataclasses
    ctx_sh = dataclasses.replace(ctx, shadow=shadow_ctx) \
        if hasattr(ctx, "shadow") else ctx

    f_shade = jax.jit(lambda c, g: shade_forward_plus(
        g, c, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=128, mode="tiled", sun_model="pbr_mr"))
    (hdr, stats), ms = timeit("shade_forward_plus (fused+cull+vis)",
                              f_shade, ctx_sh, gb, iters=it)
    total += ms

    f_tm = jax.jit(tonemap_pass)
    ldr, ms = timeit("tonemap", f_tm, hdr, iters=it)
    total += ms

    f_fxaa = jax.jit(fxaa_pass)
    _, ms = timeit("fxaa", f_fxaa, ldr, iters=it)
    total += ms

    # --- per-frame cull + local shadow atlas
    from lsr_tpu.geometry.occlusion import (
        occlusion_cull_aabbs, render_occluder_depth)
    from lsr_tpu.geometry.volumes import frustum_cull_objects
    from lsr_tpu.lighting.local_shadows import (
        local_shadow_vis_stack, plan_shadow_casters, render_local_shadow_maps)
    from lsr_tpu.scene.scene import object_world_aabbs
    from lsr_tpu.shading.models import _norm

    def cull_step(vp):
        wmin, wmax = object_world_aabbs(objects)
        vis = objects.visible & frustum_cull_objects(vp, wmin, wmax)
        occ = render_occluder_depth(geom, objects, vp, cam.zn, cam.zf,
                                    320, 180, occluder_mask=vis)
        return vis & occlusion_cull_aabbs(occ, vp, wmin, wmax, cam.zn, cam.zf)

    _, ms = timeit("scene_cull (frustum+occ 320x180)", jax.jit(cull_step),
                   cam.viewproj, iters=it)
    total += ms

    spot_ids, point_ids = plan_shadow_casters(lights)
    if spot_ids or point_ids:
        vis_scale = 1
        f_local = jax.jit(lambda: render_local_shadow_maps(
            geom, objects, lights, spot_ids, point_ids,
            map_size=1024, point_size=512, pcf_radius=1,
            vis_scale=vis_scale))
        sh, ms = timeit(
            f"local_atlas {len(spot_ids)}sx1024+{len(point_ids)}px512",
            f_local, iters=it)
        total += ms

        f_vstack = jax.jit(lambda s, g: local_shadow_vis_stack(
            s, g.world_pos, _norm(g.normal_ws)))
        _, ms = timeit(f"local_vis_stack K={sh.n_shadowed} vs={vis_scale}",
                       f_vstack, sh, gb, iters=it)
        total += ms

    print(f"{'TOTAL (sum of stages)':36s} {total:8.2f} ms "
          f"({1000.0 / total:.1f} fps equivalent)")


if __name__ == "__main__":
    main()
