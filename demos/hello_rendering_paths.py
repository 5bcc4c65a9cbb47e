"""Flagship analog: DYNAMIC composition switching across the 5 render paths.

Parity target: HelloRenderingPaths (hello_rendering_paths.cpp — runtime
composition of render path x technique x post stack, with pipeline rebuild
counting). Each preset recipe is compiled+planned once (the VK-pipeline
rebuild analog: a jitted whole-plan program, cached per composition), then
the demo cycles compositions at runtime rendering frames through whichever
is active, reports per-composition frame times + rebuild counts, and writes
a contact sheet of one frame per path.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsr_tpu.core.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from lsr_tpu.core.frame import FrameParams, TechniqueMode
from lsr_tpu.io.png import save_canvas_png
from lsr_tpu.passes.standard_passes import make_standard_registry
from lsr_tpu.pipeline.executor import RenderContext
from lsr_tpu.pipeline.pipeline import PluggablePipeline
from lsr_tpu.pipeline.recipe import builtin_render_path_presets
from lsr_tpu.scene.scene import make_camera
from lsr_tpu.utils.host import fetch_image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from run_phases import _MODE_FOR, scene_state  # noqa: E402


def main():
    import jax

    w, h = 480, 270
    base_state = scene_state(w, h)
    reg = make_standard_registry()

    # "Rebuild" = compiling a composition's whole-plan program (the
    # reference counts VK pipeline rebuilds the same way).
    pipelines = {}
    rebuilds = 0
    from lsr_tpu.pipeline.recipe import ssao_composition_recipe

    for preset in builtin_render_path_presets() + [ssao_composition_recipe()]:
        import dataclasses

        recipe = dataclasses.replace(preset, post_stack=("fxaa",))
        fp = FrameParams(width=w, height=h)
        fp.technique.mode = TechniqueMode[_MODE_FOR[preset.name]]
        fp.technique.light_culling = preset.light_culling
        fp.enable_fxaa = True
        fp.enable_taa = False
        pipe = PluggablePipeline(preexisting_semantics=())
        rep = pipe.configure_from_recipe(recipe, reg)
        assert rep.ok, (preset.name, rep.errors)
        plan = pipe.build_plan(fp)
        assert plan.ok, (preset.name, plan.errors)
        pipelines[preset.name] = (pipe, fp, RenderContext())
        rebuilds += 1

    def frame(name, i):
        pipe, fp, rt = pipelines[name]
        a = 0.05 * i
        cam = make_camera(w, h, (0.6 + 0.3 * np.sin(a), 1.6, -4.5),
                          (0, 0, 0))
        state = dict(base_state)
        state["camera"] = cam
        return pipe.execute_jitted(rt, state, fp)["ldr"]

    # Runtime composition cycling (the flagship's main loop behavior).
    names = list(pipelines)
    shots = {}
    print(f"compositions: {names} (rebuilds={rebuilds})")
    for cycle in range(2):
        for name in names:
            t0 = time.perf_counter()
            out = jax.block_until_ready(frame(name, cycle * 7))
            first_ms = (time.perf_counter() - t0) * 1000
            t0 = time.perf_counter()
            for i in range(5):
                out = frame(name, cycle * 7 + i)
            jax.block_until_ready(out)
            ms = (time.perf_counter() - t0) / 5 * 1000
            tag = "compile+run" if cycle == 0 else "cached"
            print(f"cycle {cycle} {name:18s} first {first_ms:8.1f} ms "
                  f"({tag}), then {ms:6.1f} ms/frame", flush=True)
            shots[name] = fetch_image(out)

    # Contact sheet: the five paths side by side.
    sheet = np.concatenate([shots[n] for n in names], axis=1)
    out_dir = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "hello_rendering_paths.png")
    save_canvas_png(path, sheet)
    print(f"wrote {path} ({sheet.shape[1]}x{sheet.shape[0]})")


if __name__ == "__main__":
    main()
