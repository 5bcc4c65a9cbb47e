"""All six reference light types lighting one scene, with tiled culling.

Parity target: the hello_light_types_culling demo pair
(exp-plumbing/hello_light_types_culling_{sw,vk}.cpp) and the type
enumeration in lighting/light_types.hpp:24 (Directional, Point, Spot,
RectArea, TubeArea, EnvProbe).  The sun is the directional light; the
local types are binned by the tiled culler and shaded through the same
forward+ loop the flagship uses; the env probe adds localized ambient
(eval_env_probes).  Renders through BOTH rasterizer backends and
hash-compares the LDR images (the Phase-I backend-parity pattern).
"""

import hashlib
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
from lsr_tpu.raster.brute import rasterize_brute
from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import scene_setup
from lsr_tpu.raster.tiled import rasterize_direct
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import make_materials
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu.utils.host import fetch_image
from lsr_tpu.resources.assets import make_head_mesh


def build():
    monkey = make_head_mesh()
    sb = SceneBuilder()
    for i, x in enumerate((-2.4, -0.8, 0.8, 2.4)):
        sb.add(monkey, np.asarray(
            m3.translate([x, 0.0, 0.6]) @ m3.rotate_y(np.pi + 0.25 * i)),
            material=i % 2)
    sb.add(make_plane(9.0, y=-1.0), material=2, casts_shadow=False)
    geom, objects = sb.build()

    mats = make_materials(
        base_color=[(0.8, 0.55, 0.35), (0.55, 0.6, 0.8), (0.45, 0.47, 0.5)],
        metallic=[0.05, 0.3, 0.0],
        roughness=[0.45, 0.3, 0.85],
    )

    lb = LightSetBuilder()
    # One of each local type, spread across the monkeys.
    lb.point((-2.4, 1.4, -1.0), color=(0.2, 0.9, 0.3), intensity=5.0,
             range=4.0)
    lb.spot((-0.8, 2.4, -1.4), (0.0, -0.85, 0.55), color=(0.95, 0.3, 0.2),
            intensity=5.0, range=5.0, inner_angle=0.25, outer_angle=0.5)
    lb.rect_area((0.8, 1.6, -1.2), (0.0, -0.6, 0.8),
                 half_extents=(0.8, 0.45), color=(0.3, 0.5, 1.0),
                 intensity=5.0, range=4.5)
    lb.tube_area((2.4, 1.1, -1.2), axis=(1.0, 0.0, 0.2), half_length=0.9,
                 radius=0.08, color=(1.0, 0.8, 0.25), intensity=4.5,
                 range=3.2)
    lb.env_probe((0.0, 0.6, 0.6), color=(0.9, 0.6, 1.0), intensity=1.6,
                 range=2.2)
    lights = lb.build()

    eye = (0.2, 1.5, -5.2)
    ctx = make_shade_context(
        mats,
        light_dir_ws=(0.25, -0.7, 0.65),   # the DIRECTIONAL light (sun)
        light_color=(1.0, 0.97, 0.9),
        light_intensity=1.6,
        camera_pos=eye,
    )
    return geom, objects, lights, ctx, eye


def render(geom, objects, lights, ctx, eye, w, h, use_tiled):
    cam = make_camera(w, h, eye, (0.0, 0.2, 0.0), fov=np.pi / 3.1)
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    if use_tiled:
        depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf)
    else:
        depth, tid = rasterize_brute(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    hdr, stats = shade_forward_plus(
        gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=8, mode="tiled", sun_model="pbr_mr")
    return tonemap_pass(hdr), stats


def main():
    w, h = 640, 360
    geom, objects, lights, ctx, eye = build()

    imgs = {}
    for name, use_tiled in (("pallas_tiled", True), ("xla_brute", False)):
        ldr, stats = render(geom, objects, lights, ctx, eye, w, h, use_tiled)
        img = fetch_image(jax.block_until_ready(ldr))
        imgs[name] = img
        print(f"{name}: ldr_hash={hashlib.sha1(img.tobytes()).hexdigest()[:16]}"
              f" max_lights_per_tile={int(stats['max_lights_per_bin'])}")

    match = bool((imgs["pallas_tiled"] == imgs["xla_brute"]).all())
    print(f"backend parity: match={match}")

    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_light_types.png")
    save_canvas_png(path, imgs["pallas_tiled"])
    print(f"wrote {path}")
    assert match, "rasterizer backends disagree"


if __name__ == "__main__":
    main()
