"""Config #2 extended: textured + NORMAL-MAPPED monkey (multi-slot materials).

Parity target: MaterialData's 4 texture slots (resources/material.hpp:36-39)
and the texture-mapping pipeline demos (hello-3d-primitives family).  The
monkey carries a base-color texture + a tangent-space bump normal map + an
ORM map; the floor is checkered.
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
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import (
    bump_normal_texture,
    checkerboard_texture,
    make_materials,
)
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu.utils.host import fetch_image
from lsr_tpu.resources.assets import make_head_mesh


def main():
    w, h = 800, 600
    sb = SceneBuilder()
    sb.add(make_head_mesh(), np.asarray(
        m3.translate([0.0, 0.25, 0.0]) @ m3.rotate_y(0.4)), material=0)
    sb.add(make_plane(5.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build()

    eye = (0.8, 1.2, -3.2)
    cam = make_camera(w, h, eye, (0, 0, 0))

    # Texture array: [0] checker base, [1] bump normal map, [2] ORM.
    orm = np.full((128, 128, 3), [1.0, 0.8, 0.1], np.float32)
    yy = np.linspace(0, 4 * np.pi, 128, dtype=np.float32)
    orm[..., 1] = 0.4 + 0.35 * np.sin(yy)[None, :]  # roughness bands
    textures = np.stack([
        checkerboard_texture(128),
        bump_normal_texture(128, bumps=7, amplitude=1.0),
        orm,
    ])

    mats = make_materials(
        base_color=[(0.85, 0.6, 0.4), (0.55, 0.56, 0.6)],
        metallic=[0.5, 0.0],
        roughness=[0.9, 0.8],
        tex_id=[0, 0],
        normal_tex=[1, -1],
        orm_tex=[2, -1],
    )
    lb = LightSetBuilder()
    lb.point((1.5, 1.5, -1.5), color=(1.0, 0.8, 0.6), intensity=3.0,
             range=6.0)
    lb.point((-1.5, 1.0, -1.0), color=(0.5, 0.7, 1.0), intensity=2.0,
             range=5.0)
    lights = lb.build()
    ctx = make_shade_context(
        mats, light_dir_ws=(0.45, -0.7, 0.55), light_color=(1.0, 0.97, 0.92),
        light_intensity=2.2, camera_pos=eye, textures=jnp.asarray(textures))
    assert ctx.surface_maps

    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    hdr, _ = shade_forward_plus(
        gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=8, sun_model="pbr_mr")
    ldr = jax.block_until_ready(tonemap_pass(hdr))

    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_normal_mapping.png")
    save_canvas_png(path, fetch_image(ldr))
    print(f"wrote {path} covered={int(np.asarray(gb.covered).sum())}")


if __name__ == "__main__":
    main()
