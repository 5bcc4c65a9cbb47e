"""Config #5: full multi-pass frame — deferred G-buffer + IBL skybox +
motion blur / DoF / FXAA post chain, driven through the pluggable pipeline.

Parity target: HelloMultiPass + the composition presets of
hello_rendering_paths (tiled_deferred + 'full' post stack).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsr_tpu.core.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import jax.numpy as jnp

from lsr_tpu.core import math3d as m3
from lsr_tpu.core.frame import FrameParams, LightCullingMode, TechniqueMode
from lsr_tpu.io.obj import make_plane, make_uv_sphere
from lsr_tpu.io.png import save_canvas_png
from lsr_tpu.utils.host import fetch_image
from lsr_tpu.lighting.light_types import LightSetBuilder
from lsr_tpu.passes.standard_passes import make_standard_registry
from lsr_tpu.pipeline.executor import RenderContext
from lsr_tpu.pipeline.pipeline import PluggablePipeline
from lsr_tpu.pipeline.recipe import POST_STACK_PRESETS, RenderPathRecipe
from lsr_tpu.resources.ibl import (
    compute_irradiance_map,
    compute_prefiltered_specular,
)
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import checkerboard_texture, make_materials
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu.sky.sky_models import procedural_sky_cubemap
from lsr_tpu.resources.assets import make_head_mesh

SUN = (0.35, -0.7, 0.5)


def main():
    w, h = 800, 600
    monkey = make_head_mesh()
    b = SceneBuilder()
    # A moving monkey (prev_model differs -> motion vectors -> motion blur).
    cur = np.asarray(m3.translate([0.3, 0.3, 0.0]) @ m3.rotate_y(0.6))
    prev = np.asarray(m3.translate([-0.3, 0.3, 0.0]) @ m3.rotate_y(0.45))
    b.add(monkey, cur, material=0, prev_model=prev)
    b.add(monkey, np.asarray(m3.translate([-2.2, 0.3, 2.0]) @ m3.rotate_y(2.2)),
          material=2)
    b.add(make_uv_sphere(0.7), np.asarray(m3.translate([2.0, 0.0, 1.5])),
          material=3)
    b.add(make_plane(8.0, y=-0.9), material=1, casts_shadow=False)
    geom, objects = b.build()

    eye = (0.8, 1.6, -4.5)
    cam = make_camera(w, h, eye, (0, 0, 0.5))

    lb = LightSetBuilder()
    rng = np.random.default_rng(9)
    for _ in range(48):
        lb.point(tuple(rng.uniform([-4, 0.0, -3], [4, 2.2, 4]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.2, range=2.2)
    lights = lb.build()

    # IBL baked from the procedural sky.
    sky_cube = procedural_sky_cubemap(32, sun_dir_ws=jnp.asarray(SUN, jnp.float32))
    irr = compute_irradiance_map(sky_cube, out_size=8, samples=128)
    pref = tuple(compute_prefiltered_specular(sky_cube, out_size=16,
                                              samples=64, mips=4))

    mats = make_materials(
        base_color=[(0.85, 0.55, 0.35), (0.55, 0.56, 0.6), (0.4, 0.6, 0.85),
                    (0.95, 0.9, 0.6)],
        metallic=[0.1, 0.0, 0.3, 0.9],
        roughness=[0.4, 0.7, 0.35, 0.2],
        tex_id=[-1, 0, -1, -1],
    )
    ctx = make_shade_context(
        mats, light_dir_ws=SUN, light_color=(1.0, 0.96, 0.9),
        light_intensity=2.6, camera_pos=eye,
        textures=jnp.asarray(checkerboard_texture(128))[None],
        ibl=(irr, pref),
    )

    recipe = RenderPathRecipe(
        name="full_multipass", technique=TechniqueMode.TILED_DEFERRED,
        light_culling=LightCullingMode.TILED_DEPTH_RANGE, shadows=True,
        pass_chain=("sky", "gbuffer", "light_culling",
                    "deferred_lighting_tiled"),
        post_stack=POST_STACK_PRESETS["full"],
    )
    fp = FrameParams(width=w, height=h)
    fp.technique.mode = TechniqueMode.TILED_DEFERRED
    fp.technique.light_culling = LightCullingMode.TILED_DEPTH_RANGE
    fp.enable_motion_vectors = True
    fp.enable_motion_blur = True
    fp.enable_light_shafts = True
    fp.enable_dof = True
    fp.enable_bloom = True
    fp.enable_fxaa = True
    fp.enable_taa = False  # single still frame
    fp.pass_params.dof.focus_range = 0.05
    fp.pass_params.motion_blur.strength = 1.5

    reg = make_standard_registry()
    pipe = PluggablePipeline(preexisting_semantics=())
    report = pipe.configure_from_recipe(recipe, reg)
    assert report.ok, report.errors
    plan = pipe.build_plan(fp)
    assert plan.ok, plan.errors
    print("pass order:", [pipe.passes[i].pass_id for i in plan.order])

    state = {"geom": geom, "objects": objects, "camera": cam,
             "lights": lights, "shade_ctx": ctx}
    ctx_rt = RenderContext()
    state = pipe.execute(ctx_rt, state, fp)
    ldr = fetch_image(state["ldr"])
    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_full_pipeline.png")
    save_canvas_png(path, ldr)
    ms = {k: round(v, 1) for k, v in ctx_rt.debug.pass_ms.items()}
    print(f"wrote {path}; pass ms: {ms}")


if __name__ == "__main__":
    main()
