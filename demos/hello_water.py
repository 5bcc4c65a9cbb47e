"""hello_water: monkey over a rippling planar-reflection water surface."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsr_tpu.core.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import dataclasses

import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_plane
from lsr_tpu.io.png import save_canvas_png
from lsr_tpu.utils.host import fetch_image
from lsr_tpu.passes.tonemap import tonemap_pass
from lsr_tpu.passes.water import mirrored_camera, shade_water
from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import CULL_FRONT, scene_setup
from lsr_tpu.raster.tiled import rasterize_direct
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import make_materials
from lsr_tpu.shading.models import (
    composite_over_background,
    make_shade_context,
    shade_blinn_phong,
)
from lsr_tpu.sky.sky_models import render_sky
from lsr_tpu.resources.assets import make_head_mesh

WATER_Y = -0.8
SUN = (0.35, -0.75, 0.5)


def render_view(geom, objects, ctx, viewproj, zn, zf, w, h, cull_mode=1,
                skip_obj=None):
    vis = objects.visible
    if skip_obj is not None:
        vis = vis & (jnp.arange(vis.shape[0]) != skip_obj)
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        viewproj, w, h, cull_mode=cull_mode, obj_visible=vis,
    )
    depth, tid, _ = rasterize_direct(setup, w, h, zn, zf)
    gb = interpolate_gbuffer(setup, depth, tid)
    shaded = shade_blinn_phong(gb, ctx)
    sky = render_sky(viewproj, w, h, sun_dir_ws=jnp.asarray(SUN, jnp.float32))
    return composite_over_background(shaded, gb, sky), gb


def main():
    w, h = 800, 600
    b = SceneBuilder()
    b.add(make_head_mesh(), np.asarray(m3.translate([0.0, 0.35, 0.0])
                                       @ m3.rotate_y(0.4)))
    water_id = b.add(make_plane(8.0, y=WATER_Y), material=1, casts_shadow=False)
    geom, objects = b.build()

    eye = (1.2, 1.2, -4.2)
    cam = make_camera(w, h, eye, (0, -0.1, 0))
    mats = make_materials(base_color=[(0.85, 0.55, 0.35), (0.1, 0.2, 0.25)],
                          roughness=[0.4, 0.1], metallic=[0.05, 0.0])
    ctx = make_shade_context(mats, light_dir_ws=SUN,
                             light_color=(1.0, 0.96, 0.9),
                             light_intensity=2.6, camera_pos=eye)

    # Reflection pass: mirrored camera, water plane excluded, inverted cull.
    refl_view = mirrored_camera(cam.view, WATER_Y)
    refl_vp = cam.proj @ refl_view
    refl_hdr, _ = render_view(geom, objects, ctx, refl_vp, cam.zn, cam.zf,
                              w, h, cull_mode=CULL_FRONT, skip_obj=water_id)
    # Main pass + water composite.
    main_hdr, gb = render_view(geom, objects, ctx, cam.viewproj, cam.zn,
                               cam.zf, w, h)
    hdr = shade_water(gb, refl_hdr, water_id, main_hdr,
                      jnp.asarray(eye, jnp.float32), time=1.0)
    from lsr_tpu.passes.post import fog_pass

    hdr = fog_pass(hdr, gb.depth01, fog_color=(0.55, 0.62, 0.7),
                   fog_density=0.5)
    ldr = tonemap_pass(hdr)
    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_water.png")
    save_canvas_png(path, fetch_image(ldr))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
