"""Smoke test of the renderer's main path on one NVIDIA GPU.

    python3 chip_smoke.py           # phases (a)-(e) on one card
    python3 chip_smoke.py --four    # the sp / lp / pp mesh paths on 4 cards

Phases, in one process:
  (a) device: JAX must find a GPU, else exit non-zero with no result;
  (b) every Triton kernel at real widths against its plain XLA reference
      (camera raster 1920x1080, sun depth 1024^2 and 2048^2, local shadow
      atlas 8x512^2 + 2x6x256^2, occluder proxy 320x180, fused shade
      1920x1080 with 256 lights and local visibility planes), timed;
  (c) the bench flagship frame at 1920x1080 against the same frame composed
      from the references, plus a check that its compiled HLO holds the
      Triton custom call of every kernel (so nothing ran interpreted);
  (d) the PluggablePipeline forward+ preset at 1280x720;
  (e) one ~1M-triangle frame (33x33 heads) through the pipeline's raster
      pass (compact setup), whose overflow flag must read 0.
Any failed check exits non-zero.  The last line of stdout is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.

Tolerances (kernel vs reference, matmuls at HIGHEST precision):
  raster depth01 within 1e-6 where both pick the same triangle;
  coverage/tid mismatches at most 1e-4 of pixels and only on triangle
  edges (depth-only targets: pixels off by > 1e-6 at most 1e-4); shade
  within 1e-4 relative (atol 2e-5 for near-black pixels); flagship LDR mean |diff| <= 0.5 levels and at most 0.1% of
  pixels more than 8 levels off.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Real widths (module constants, so a rehearsal can shrink them).
CAM = (1920, 1080)          # flagship camera / shade target
SUN_SIZES = (1024, 2048)    # ESM default and the reference-exact sun map
ATLAS = (512, 256)          # spot map / point cube face
OCCLUDER = (320, 180)
PIPE = (1280, 720)          # the reference's default target
HIGHPOLY_GRID = 33          # 33 x 33 heads x 967 = 1,053,063 triangles
DEPTH_TOL = 1e-6            # depth01, kernel vs reference, both covering
SHADE_RTOL, SHADE_ATOL = 1e-4, 2e-5        # fused shade vs XLA path
KERNELS = ("lsr_raster", "lsr_shade")      # pallas_call names
TRITON_CALL = "__gpu$xla.gpu.triton"


def log(msg):
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    log(f"  ok: {what}")


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def compile_fn(name, fn, *args):
    """jit + lower + compile, logging compile seconds and memory."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    dt = time.perf_counter() - t0
    m = compiled.memory_analysis()
    mib = 1.0 / (1 << 20)
    log(f"  [{name}] compile {dt:.2f} s; memory: args "
        f"{m.argument_size_in_bytes * mib:.1f} MiB, out "
        f"{m.output_size_in_bytes * mib:.1f} MiB, temp "
        f"{m.temp_size_in_bytes * mib:.1f} MiB, code "
        f"{m.generated_code_size_in_bytes * mib:.2f} MiB")
    return compiled


def time_ms(compiled, *args, reps=10):
    """Mean ms per call: async dispatch, one block at the end."""
    import jax

    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = compiled(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) * 1000.0 / reps, out


def kernel_vs_ref(name, fn_k, fn_r, args, reps=10, ref_reps=3):
    ck = compile_fn(f"{name} kernel", fn_k, *args)
    cr = compile_fn(f"{name} xla", fn_r, *args)
    ms_k, out_k = time_ms(ck, *args, reps=reps)
    ms_r, out_r = time_ms(cr, *args, reps=ref_reps)
    log(f"  [{name}] kernel {ms_k:.3f} ms | xla reference {ms_r:.3f} ms "
        f"| {ms_r / ms_k:.1f}x")
    return out_k, out_r


def _edge_mask(tid):
    """Pixels whose 3x3 neighbourhood holds more than one triangle id."""
    import numpy as np

    p = np.pad(tid, 1, mode="edge")
    h, w = tid.shape
    edge = np.zeros((h, w), bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            edge |= p[dy:dy + h, dx:dx + w] != tid
    return edge


def raster_parity(name, d_k, t_k, d_r, t_r):
    """Where kernel and reference pick the same triangle, depth01 agrees to
    DEPTH_TOL.  Pixels where they pick different ones (coverage of an edge
    pixel decided by the last bit of an edge function) are at most 1e-4 of
    the image and lie on triangle edges.  Depth-only targets have no ids:
    there a pixel off by more than DEPTH_TOL counts as a mismatch."""
    import numpy as np

    d_k, d_r = np.asarray(d_k), np.asarray(d_r)
    n = d_k.size
    check(np.isfinite(d_k).all(), f"{name}: depth finite")
    if t_k is None:
        off = np.abs(d_k - d_r) > DEPTH_TOL
        log(f"  [{name}] covered {int((d_r < 1.0).sum())} of {n}; max |dz| "
            f"{float(np.abs(d_k - d_r).max()):.3g}; pixels off by > "
            f"{DEPTH_TOL:g}: {int(off.sum())}")
        check(off.sum() <= 1e-4 * n,
              f"{name}: pixels off by > {DEPTH_TOL:g} <= 1e-4 of pixels")
        return
    t_k, t_r = np.asarray(t_k), np.asarray(t_r)
    same = (t_k == t_r) & (t_r >= 0)
    dz = float(np.abs(d_k - d_r)[same].max(initial=0.0))
    cov_mis = int(((t_k >= 0) != (t_r >= 0)).sum())
    tid_mis = t_k != t_r
    off_edge = int((tid_mis & ~_edge_mask(t_r)).sum())
    log(f"  [{name}] covered {int((t_r >= 0).sum())} of {n}; max |dz| on "
        f"the same triangle {dz:.3g}; coverage mismatches {cov_mis}; tid "
        f"mismatches {int(tid_mis.sum())} ({off_edge} off edges)")
    check(dz <= DEPTH_TOL,
          f"{name}: depth01 within {DEPTH_TOL:g} on the same triangle")
    check(int(tid_mis.sum()) <= 1e-4 * n,
          f"{name}: coverage/tid mismatches <= 1e-4 of pixels")
    check(off_edge == 0, f"{name}: mismatches on triangle edges only")


def image_parity(name, a, b):
    import numpy as np

    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    d = np.abs(a - b)
    mad = float(d.mean())
    far = float((d.max(axis=-1) > 8).mean())
    log(f"  [{name}] LDR mean |diff| {mad:.4f} levels, max {int(d.max())}, "
        f"pixels > 8 levels off {far * 100:.4f}%")
    check(mad <= 0.5, f"{name}: LDR mean |diff| <= 0.5 levels")
    check(far <= 1e-3, f"{name}: <= 0.1% of pixels > 8 levels off")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_kernels(scene, cam, ctx):
    """(b) each kernel at real widths against its plain XLA reference."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from lsr_tpu.camera.light_camera import build_dir_light_camera
    from lsr_tpu.geometry.volumes import frustum_cull_objects
    from lsr_tpu.lighting.local_shadows import (
        plan_shadow_casters, plan_slot_stacks, render_local_shadow_maps)
    from lsr_tpu.lighting.shadow_sample import make_shadow_context
    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.passes.shadow import render_shadow_map
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import (
        CULL_BACK, CULL_NONE, DEPTH_NDC01, DEPTH_VIEWZ, scene_setup,
        scene_setup_depth)
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import object_world_aabbs, shadow_caster_aabb

    geom, objects, lights = scene
    W, H = CAM
    sun = jnp.asarray([0.35, -0.75, 0.45], jnp.float32)

    log(f"(b1) camera raster {W}x{H}")
    setup = compile_fn(
        "camera setup", lambda c: scene_setup(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            c.viewproj, W, H), cam)(cam)
    log(f"  post-setup triangles {int(setup.valid.sum())} "
        f"(rows {setup.count})")
    (d_k, t_k), (d_r, t_r) = kernel_vs_ref(
        "camera raster",
        lambda s: rasterize_direct(s, W, H, cam.zn, cam.zf,
                                   spatial_sort=True)[:2],
        lambda s: rasterize_brute(s, W, H, cam.zn, cam.zf), (setup,))
    raster_parity("camera raster", d_k, t_k, d_r, t_r)

    def depth_only(name, st, w, h, zn, zf, mode):
        """Depth-only raster of one shared setup: kernel vs brute."""
        dk, dr = kernel_vs_ref(
            name,
            lambda t: rasterize_direct(t, w, h, zn, zf, depth_mode=mode,
                                       track_ids=False,
                                       spatial_sort=True)[0],
            lambda t: rasterize_brute(t, w, h, zn, zf, depth_mode=mode)[0],
            (st,))
        raster_parity(name, dk, None, dr, None)

    casters = objects.casts_shadow & objects.visible
    smin, smax = shadow_caster_aabb(objects)
    for size in SUN_SIZES:
        log(f"(b2) sun depth-only raster {size}^2")
        light_vp = build_dir_light_camera(smin, smax, sun, size)[2]
        st = jax.jit(lambda vp: scene_setup_depth(
            geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
            objects.model, vp, size, size, cull_mode=CULL_NONE,
            obj_visible=casters))(light_vp)
        depth_only(f"sun {size}", st, size, size, 0.0, 1.0, DEPTH_NDC01)

    spot_ids, point_ids = plan_shadow_casters(lights)
    log(f"(b3) local shadow atlas {len(spot_ids)}x{ATLAS[0]}^2 + "
        f"{len(point_ids)}x6x{ATLAS[1]}^2")
    spot_vp, point_vp = plan_slot_stacks(lights, spot_ids, point_ids)[-2:]
    wmin, wmax = object_world_aabbs(objects)

    def slot_setups(vps, size):
        # The atlas slots of lighting/local_shadows._render_slot_stack:
        # per-slot frustum-culled depth-only setups, stacked.
        return jax.jit(jax.vmap(lambda vp: scene_setup_depth(
            geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
            objects.model, vp, size, size, cull_mode=CULL_NONE,
            obj_visible=casters & frustum_cull_objects(vp, wmin, wmax))))(
                vps)

    for name, vps, size in (("spot maps", spot_vp, ATLAS[0]),
                            ("point faces", point_vp, ATLAS[1])):
        st = slot_setups(vps, size)
        dk, dr = kernel_vs_ref(
            name,
            lambda t: jax.lax.map(lambda t1: rasterize_direct(
                t1, size, size, 0.0, 1.0, depth_mode=DEPTH_NDC01,
                track_ids=False, spatial_sort=True)[0], t),
            lambda t: jax.lax.map(lambda t1: rasterize_brute(
                t1, size, size, 0.0, 1.0, depth_mode=DEPTH_NDC01)[0], t),
            (st,), ref_reps=2)
        raster_parity(name, np.asarray(dk).reshape(-1, size), None,
                      np.asarray(dr).reshape(-1, size), None)
    sh_k = render_local_shadow_maps(
        geom, objects, lights, spot_ids, point_ids, map_size=ATLAS[0],
        point_size=ATLAS[1], pcf_radius=2, vis_scale=2, filter_mode="esm")

    log(f"(b4) occluder proxy raster {OCCLUDER[0]}x{OCCLUDER[1]}")
    st = jax.jit(lambda c: scene_setup_depth(
        geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
        objects.model, c.viewproj, *OCCLUDER, cull_mode=CULL_BACK,
        obj_visible=objects.visible))(cam)
    depth_only("occluder", st, *OCCLUDER, cam.zn, cam.zf, DEPTH_VIEWZ)

    log(f"(b5) fused shade {W}x{H}, {lights.count} lights, local "
        "visibility planes")
    gb = interpolate_gbuffer(setup, d_k, t_k, materials=ctx.materials,
                             want_face_normal=False)
    sm, light_vp = render_shadow_map(geom, objects, sun,
                                     map_size=SUN_SIZES[0])
    ctx_sh = dataclasses.replace(ctx, shadow=make_shadow_context(
        sm, light_vp, pcf_radius=2, filter_mode="esm"))

    def shade(use_kernel):
        return lambda g, c: shade_forward_plus(
            g, c, lights, cam.view, cam.proj, cam.zn, cam.zf, W, H,
            tile_size=16, cap=128, mode="tiled_depth_range",
            sun_model="pbr_mr", local_shadows=sh_k, sun_vis_scale=2,
            use_kernel=use_kernel)

    (hk, st), (hr, _) = kernel_vs_ref("shade", shade(True), shade(False),
                                      (gb, ctx_sh))
    hk, hr = np.asarray(hk), np.asarray(hr)
    err = np.abs(hk - hr)
    # The CPU tests' tolerance: rtol 1e-4 with an atol of 2e-5 for the
    # near-black pixels (HDR values run to ~10; an LDR step is ~4e-3).
    excess = err - (SHADE_RTOL * np.abs(hr) + SHADE_ATOL)
    worst = np.unravel_index(np.argmax(excess), excess.shape)
    log(f"  [shade] max lights per tile {int(st['max_lights_per_bin'])}, "
        f"overflowed tiles {int(st['overflow_bins'])}; max |diff| "
        f"{float(err.max()):.3g}; max relative where |ref| > 0.01: "
        f"{float((err / np.abs(hr))[np.abs(hr) > 0.01].max()):.3g}; "
        f"worst pixel {worst}: kernel {float(hk[worst]):.7g} ref "
        f"{float(hr[worst]):.7g}; over tolerance: "
        f"{int((excess > 0).sum())} of {hk.size}")
    check(np.isfinite(hk).all(), "shade: finite")
    check((excess <= 0).all(),
          f"shade: within rtol {SHADE_RTOL:g} + atol {SHADE_ATOL:g}")


def phase_flagship(scene_full, eye):
    """(c) bench flagship vs the reference composition."""
    import jax
    import numpy as np

    import bench

    geom, objects, lights, ctx = scene_full
    W, H = CAM
    frames = [bench.orbit_camera(ctx, eye, i, W, H) for i in range(4)]
    kw = dict(shadow_size=SUN_SIZES[0], local_map=ATLAS[0],
              local_point=ATLAS[1])
    fk, _, _ = bench.make_flagship_frame(geom, objects, lights, ctx, W, H,
                                         **kw)
    fr, _, _ = bench.make_flagship_frame(geom, objects, lights, ctx, W, H,
                                         use_kernels=False, **kw)
    ck = compile_fn("flagship", fk, *frames[0])
    cr = compile_fn("flagship reference", fr, *frames[0])

    # A kernel run in interpret mode lowers to plain HLO loops; a compiled
    # one is a Triton custom call that carries the kernel's name.
    calls = [ln for ln in ck.as_text().splitlines() if TRITON_CALL in ln]
    log(f"  [flagship] Triton custom calls in compiled HLO: {len(calls)}")
    for kname in KERNELS:
        n = sum(kname in ln for ln in calls)
        log(f"  [flagship] {kname}: {n} Triton call(s)")
        check(n > 0, f"flagship HLO holds the Triton call {kname}")
    check(TRITON_CALL not in cr.as_text(),
          "reference composition holds no Triton call")

    for name, comp in (("flagship", ck), ("flagship reference", cr)):
        outs = [comp(*f) for f in frames]          # warm: one per camera
        jax.block_until_ready(outs)
        t0 = time.perf_counter()
        outs = [comp(*f) for f in frames]
        jax.block_until_ready(outs)
        ms = (time.perf_counter() - t0) * 1000.0 / len(frames)
        log(f"  [{name}] {ms:.2f} ms/frame over {len(frames)} orbit frames")
        if name == "flagship":
            ldr_k = [np.asarray(o[0]) for o in outs]
            stats = [int(x) for x in outs[0][1:]]
            log(f"  [flagship] tris {stats[0]}, max supers per tile "
                f"{stats[1]}, max lights per tile {stats[2]}, overflowed "
                f"light tiles {stats[3]}")
        else:
            ldr_r = [np.asarray(o[0]) for o in outs]
    for i, (a, b) in enumerate(zip(ldr_k, ldr_r)):
        check(a.shape == (H, W, 3) and a.any(), f"flagship frame {i}: shape")
        image_parity(f"flagship frame {i}", a, b)


def _pipeline(W, H, use_tiled_raster=True):
    from lsr_tpu.core.frame import FrameParams, TechniqueMode
    from lsr_tpu.passes.standard_passes import make_standard_registry
    from lsr_tpu.pipeline.pipeline import PluggablePipeline
    from lsr_tpu.pipeline.recipe import builtin_render_path_presets

    preset = [p for p in builtin_render_path_presets()
              if p.name == "forward_plus"][0]
    fp = FrameParams(width=W, height=H)
    fp.technique.mode = TechniqueMode.FORWARD_PLUS
    fp.technique.light_culling = preset.light_culling
    fp.use_tiled_raster = use_tiled_raster
    pipe = PluggablePipeline(preexisting_semantics=())
    check(pipe.configure_from_recipe(preset, make_standard_registry()).ok,
          "forward+ preset configures")
    check(pipe.build_plan(fp).ok, "forward+ plan builds")
    return pipe, fp


def _run_pipeline(name, geom, objects, lights, ctx, eye, W, H, n_frames,
                  use_tiled_raster=True):
    import jax
    import numpy as np

    import bench
    from lsr_tpu.pipeline.executor import RenderContext

    pipe, fp = _pipeline(W, H, use_tiled_raster)
    rctx = RenderContext()

    def state(i):
        cam, c = bench.orbit_camera(ctx, eye, i, W, H)
        return {"geom": geom, "objects": objects, "camera": cam,
                "lights": lights, "shade_ctx": c}

    states = [jax.device_put(state(i)) for i in range(max(n_frames, 2))]
    t0 = time.perf_counter()
    # Two warm frames: the second carries the first's temporal history,
    # which changes the state's structure (and compiles once more).
    for s in states[:2]:
        jax.block_until_ready(pipe.execute_jitted(rctx, s, fp))
    log(f"  [{name}] compile + two warm frames "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    outs = [pipe.execute_jitted(rctx, s, fp) for s in states[:n_frames]]
    jax.block_until_ready(outs)
    ms = (time.perf_counter() - t0) * 1000.0 / n_frames
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", float("nan")) / 2**30
    log(f"  [{name}] {ms:.2f} ms/frame over {n_frames} orbit frames; peak "
        f"device memory {peak:.2f} GiB")
    return [np.asarray(o["ldr"]) for o in outs], outs[0]


def phase_pipeline(scene_full, eye):
    """(d) PluggablePipeline forward+ preset."""
    geom, objects, lights, ctx = scene_full
    W, H = PIPE
    ldr_k, _ = _run_pipeline("pipeline forward+", geom, objects, lights, ctx,
                             eye, W, H, 3)
    ldr_r, _ = _run_pipeline("pipeline forward+ brute raster", geom,
                             objects, lights, ctx, eye, W, H, 3,
                             use_tiled_raster=False)
    for i, (a, b) in enumerate(zip(ldr_k, ldr_r)):
        check(a.shape == (H, W, 3) and a.any(), f"pipeline frame {i}: shape")
        image_parity(f"pipeline frame {i}", a, b)


def phase_highpoly(lights, ctx):
    """(e) ~1M triangles through the pipeline's raster pass."""
    from lsr_tpu.resources.assets import instanced_grid_scene, make_head_mesh

    g = HIGHPOLY_GRID
    geom, objects = instanced_grid_scene(make_head_mesh(), grid=g,
                                         spacing=2.4, seed=7,
                                         ground=1.4 * g)
    n_tris = int(geom.indices.shape[0])
    log(f"  [high-poly] {n_tris} triangles")
    W, H = PIPE
    eye = (30.0, 26.0, -52.0)
    ldr_k, out = _run_pipeline("high-poly forward+", geom, objects, lights,
                               ctx, eye, W, H, 2)
    rs = out["raster_stats"]
    log(f"  [high-poly] compact setup rows kept {int(rs['compact_n_direct'])}"
        f", after clip {int(rs['tri_after_clip'])}, overflow "
        f"{int(rs['compact_overflow'])}")
    check(int(rs["compact_overflow"]) == 0, "high-poly: compact overflow 0")
    ldr_r, _ = _run_pipeline("high-poly brute raster", geom, objects, lights,
                             ctx, eye, W, H, 1, use_tiled_raster=False)
    image_parity("high-poly frame 0", ldr_k[0], ldr_r[0])


def _lsb_parity(name, a, b, exact):
    """Bit-exact, or within 1 LSB (psum reorders the light sum)."""
    import numpy as np

    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    log(f"  [{name}] max |diff| {int(d.max())} LSB, pixels off "
        f"{float((d != 0).mean()) * 100:.4f}%")
    check(np.asarray(a).any(), f"{name}: non-empty frame")
    if exact:
        check(int(d.max()) == 0, f"{name}: bit-exact vs one card")
    else:
        check(int(d.max()) <= 1, f"{name}: within 1 LSB of one card")


def _shard_layout(name, out, n):
    """Each of the n cards holds its own slice of the output."""
    shards = out.addressable_shards
    devs = sorted({sh.device.id for sh in shards})
    log(f"  [{name}] shards: " + "; ".join(
        f"device {sh.device.id} rows {sh.index[-3]}" for sh in shards))
    check(len(devs) == n and len(shards) == n,
          f"{name}: output spread over {n} cards, one slice each")


def _timed_call(name, fn, *args, frames=1, reps=5):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    log(f"  [{name}] compile + first call {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1000.0 / reps
    log(f"  [{name}] {ms:.2f} ms per call of {frames} frame(s)")
    return out


def run_four():
    """sp, lp and pp mesh paths on 4 cards, each against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from lsr_tpu.parallel.sharding import (
        make_light_sharded_forward, make_mesh, make_mesh_lp, make_mesh_pp,
        make_pipelined_render, make_sharded_flagship, render_band)

    devs = jax.devices()[:4]
    check(len(devs) == 4, "four devices visible")
    geom, objects, lights, ctx, eye = bench.build_scene()
    W, H = CAM
    cam, ctx_c = bench.orbit_camera(ctx, eye, 0, W, H)
    sun = jnp.asarray([0.35, -0.75, 0.45], jnp.float32)

    log(f"== phase sp: sharded flagship dp=1 x sp=4 at {W}x{H}")

    def flagship(mesh):
        step = make_sharded_flagship(
            mesh, geom, objects, ctx_c, lights, W, H,
            shadow_size=SUN_SIZES[0], local_map=ATLAS[0],
            local_point=ATLAS[1])
        return lambda: step(cam.viewproj[None], cam.view[None], cam.proj,
                            cam.zn, cam.zf, sun)

    ref = _timed_call("sp one card", flagship(make_mesh(1, dp=1,
                                                        devices=devs[:1])))
    out = _timed_call("sp four cards", flagship(make_mesh(4, dp=1,
                                                          devices=devs)))
    _shard_layout("sp", out, 4)
    _lsb_parity("sp", out[0], ref[0], exact=True)

    log(f"== phase lp: light-sharded forward+ sp=1 x lp=4 at {W}x{H}")

    def lp_frame(mesh):
        # cap = every light: no tile overflows on either mesh (an overflowing
        # tile keeps a different subset of lights per shard).
        step, _ = make_light_sharded_forward(mesh, geom, objects, ctx_c,
                                             lights, W, H, cap=lights.count)
        return lambda: step(cam.viewproj, cam.view, cam.proj, cam.zn,
                            cam.zf)

    ref = _timed_call("lp one card", lp_frame(make_mesh_lp(
        1, sp=1, lp=1, devices=devs[:1])))
    out = _timed_call("lp four cards", lp_frame(make_mesh_lp(
        4, sp=1, lp=4, devices=devs)))
    _lsb_parity("lp", out, ref, exact=False)

    log(f"== phase pp: 2-stage pipelined stream on 2 cards at {W}x{H}")
    stream = make_pipelined_render(make_mesh_pp(2, devices=devs[:2]), geom,
                                   objects, ctx_c, W, H)
    cams = [bench.orbit_camera(ctx, eye, i, W, H)[0] for i in range(4)]
    vps = jnp.stack([c.viewproj for c in cams])
    out = np.asarray(_timed_call("pp two cards", stream, vps, cam.zn,
                                 cam.zf, frames=len(cams)))
    one = jax.jit(lambda vp: render_band(geom, objects, vp, cam.zn, cam.zf,
                                         ctx_c, W, H, H, 0))
    for i in range(1, len(cams)):
        _lsb_parity(f"pp frame {i}", out[i], one(cams[i - 1].viewproj),
                    exact=False)


def run_one_card():
    import bench

    geom, objects, lights, ctx, eye = bench.build_scene()
    cam, ctx_c = bench.orbit_camera(ctx, eye, 0, *CAM)
    t_all = time.perf_counter()
    for label, fn, args in (
        ("(b) kernels at real widths", phase_kernels,
         ((geom, objects, lights), cam, ctx_c)),
        (f"(c) flagship {CAM[0]}x{CAM[1]}", phase_flagship,
         ((geom, objects, lights, ctx), eye)),
        (f"(d) PluggablePipeline forward+ {PIPE[0]}x{PIPE[1]}",
         phase_pipeline,
         ((geom, objects, lights, ctx), eye)),
        ("(e) high-poly frame", phase_highpoly, (lights, ctx)),
    ):
        t0 = time.perf_counter()
        log(f"== phase {label}")
        fn(*args)
        log(f"== phase {label} passed in {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh paths and their "
                         "one-card references")
    args = ap.parse_args()

    import jax

    # (a) device: a GPU or nothing.
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from lsr_tpu.core.device import device_summary, enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_default_matmul_precision", "highest")
    summary = device_summary()
    log(f"== phase (a) device: {summary}")
    log(gpu_name_and_power())
    try:
        if args.four:
            run_four()
        else:
            run_one_card()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
