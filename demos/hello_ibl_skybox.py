"""IBL skybox from a FILE-LOADED cubemap (HelloIblSkybox parity).

Parity target: hello_ibl_skybox.cpp:1613-1618 (loads the water_scene 6-face
set) + resources/ibl.hpp precompute + cubemap_sky.hpp sampling.  The monkey
is lit by irradiance + prefiltered-specular maps baked FROM the loaded
cubemap; the background is the cubemap itself; an ENV_PROBE adds localized
image-based ambience near the floor.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsr_tpu.core.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_plane
from lsr_tpu.io.png import save_canvas_png
from lsr_tpu.lighting.light_types import LightSetBuilder
from lsr_tpu.passes.forward_plus import shade_forward_plus
from lsr_tpu.passes.tonemap import tonemap_pass
from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import scene_setup
from lsr_tpu.raster.tiled import rasterize_direct
from lsr_tpu.resources.ibl import (
    compute_irradiance_map,
    compute_prefiltered_specular,
)
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import make_materials
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu.sky.sky_models import render_sky
from lsr_tpu.utils.host import fetch_image
from lsr_tpu.resources.assets import make_head_mesh, skybox_faces


def main():
    w, h = 800, 600
    faces = jnp.asarray(skybox_faces(256))
    irr = compute_irradiance_map(faces, out_size=8, samples=128)
    pref = tuple(compute_prefiltered_specular(faces, out_size=32,
                                              samples=64, mips=4))

    sb = SceneBuilder()
    sb.add(make_head_mesh(), np.asarray(
        m3.translate([0.0, 0.3, 0.0]) @ m3.rotate_y(0.5)), material=0)
    sb.add(make_plane(6.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build()

    eye = (1.2, 1.0, -3.4)
    cam = make_camera(w, h, eye, (0, 0.1, 0))

    mats = make_materials(
        base_color=[(0.95, 0.93, 0.9), (0.4, 0.42, 0.45)],
        metallic=[0.9, 0.0],
        roughness=[0.15, 0.6],
    )
    lb = LightSetBuilder()
    lb.env_probe((0.0, -0.5, 0.0), color=(1.0, 1.0, 1.0), intensity=1.2,
                 range=3.0)
    lights = lb.build()

    ctx = make_shade_context(
        mats, light_dir_ws=(0.4, -0.7, 0.5), light_color=(1.0, 0.97, 0.9),
        light_intensity=1.4, camera_pos=eye, ibl=(irr, pref))

    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)

    sky = render_sky(cam.viewproj, w, h, kind="cubemap", cubemap=faces)
    hdr, _ = shade_forward_plus(
        gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=8, sun_model="pbr_mr", env_probes=True,
        background=(0, 0, 0))
    hdr = jnp.where(gb.covered[..., None], hdr, sky)
    ldr = jax.block_until_ready(tonemap_pass(hdr))

    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_ibl_skybox.png")
    save_canvas_png(path, fetch_image(ldr))
    print(f"wrote {path} covered={int(np.asarray(gb.covered).sum())}")


if __name__ == "__main__":
    main()
