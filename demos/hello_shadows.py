"""Config #3: shadow-mapped multi-monkey scene with frustum+occlusion culling.

Parity target: hello_soft_shadow_culling_sw (exp-plumbing).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsr_tpu.core.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import jax.numpy as jnp

from lsr_tpu.core import math3d as m3
from lsr_tpu.core.frame import ShadowPassParams
from lsr_tpu.geometry.occlusion import run_occlusion_pass
from lsr_tpu.io.obj import make_plane
from lsr_tpu.io.png import save_canvas_png
from lsr_tpu.utils.host import fetch_image
from lsr_tpu.passes.shadow import make_sun_shadow
from lsr_tpu.passes.tonemap import tonemap_pass
from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import scene_setup
from lsr_tpu.raster.tiled import rasterize_direct
from lsr_tpu.scene.scene import SceneBuilder, cull_scene, make_camera
from lsr_tpu.shading.common import make_materials
from lsr_tpu.shading.models import (
    composite_over_background,
    make_shade_context,
    shade_blinn_phong,
)
from lsr_tpu.resources.assets import make_head_mesh

SUN = (0.35, -0.8, 0.45)


def main():
    w, h = 800, 600
    monkey = make_head_mesh()
    b = SceneBuilder()
    rng = np.random.default_rng(7)
    for i in range(6):
        x = (i % 3 - 1) * 2.2
        z = (i // 3) * 2.5 - 0.5
        rot = float(rng.uniform(0, 2 * np.pi))
        b.add(monkey, np.asarray(m3.translate([x, 0.0, z]) @ m3.rotate_y(rot)),
              material=i % 3)
    b.add(make_plane(8.0, y=-1.0), material=3, casts_shadow=False)
    geom, objects = b.build()

    eye = (0.5, 2.2, -6.0)
    cam = make_camera(w, h, eye, (0, 0, 0.5))

    # Culling: frustum + software occlusion.
    frustum = cull_scene(objects, cam.viewproj)
    import dataclasses
    vis = run_occlusion_pass(geom, objects, cam.viewproj, cam.zn, cam.zf, frustum)
    objects = dataclasses.replace(objects, visible=vis)

    shadow = make_sun_shadow(geom, objects, jnp.asarray(SUN, jnp.float32),
                             ShadowPassParams(map_size=2048, pcf_radius=2))

    mats = make_materials(
        base_color=[(0.85, 0.5, 0.3), (0.4, 0.65, 0.85), (0.6, 0.8, 0.45),
                    (0.55, 0.55, 0.58)],
        metallic=[0.05, 0.3, 0.0, 0.0],
        roughness=[0.4, 0.3, 0.7, 0.85],
    )
    ctx = make_shade_context(
        mats, light_dir_ws=SUN, light_color=(1.0, 0.96, 0.88),
        light_intensity=3.0, camera_pos=eye, shadow=shadow,
    )

    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h, obj_visible=objects.visible,
    )
    depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf,
                                     spatial_sort=True)
    gb = interpolate_gbuffer(setup, depth, tid)
    shaded = shade_blinn_phong(gb, ctx)
    bg = jnp.broadcast_to(jnp.asarray((0.05, 0.07, 0.12), jnp.float32), shaded.shape)
    ldr = tonemap_pass(composite_over_background(shaded, gb, bg))

    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_shadows.png")
    save_canvas_png(path, fetch_image(ldr))
    print(f"wrote {path} visible_objects={np.asarray(vis).tolist()}")


if __name__ == "__main__":
    main()
