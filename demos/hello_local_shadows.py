"""Local light shadows demo: 6 monkeys, 2 shadowed spots + 1 shadowed point.

Parity target: the flagship's local shadow atlas
(hello_rendering_paths.cpp:104-109, record_shadow_passes :6912) sampled in
the forward+ light loop (fp_stress_scene.frag:355-414).  Renders the same
composition through BOTH rasterizer backends (tiled Pallas kernel and the
XLA brute anchor) and hash-compares the LDR images — the Phase-I backend
parity pattern (hello_rendering_paths.cpp:389-414).
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
from lsr_tpu.lighting.local_shadows import (
    plan_shadow_casters,
    render_local_shadow_maps,
)
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
    b = SceneBuilder()
    for i in range(6):
        ang = i * np.pi / 3.0
        x, z = 2.4 * np.cos(ang), 2.4 * np.sin(ang)
        b.add(monkey, np.asarray(
            m3.translate([x, 0.2, z]) @ m3.rotate_y(-ang + np.pi / 2)),
            material=i % 3)
    b.add(make_plane(9.0, y=-1.0), material=3, casts_shadow=False)
    geom, objects = b.build()

    lb = LightSetBuilder()
    # Two shadowed spots aimed across the ring + one shadowed point inside it.
    lb.spot((3.5, 4.0, 0.0), (-0.6, -1.0, 0.0), color=(1.0, 0.85, 0.6),
            intensity=6.0, range=12.0, inner_angle=0.5, outer_angle=0.9)
    lb.spot((-3.5, 4.0, 0.0), (0.6, -1.0, 0.0), color=(0.6, 0.8, 1.0),
            intensity=6.0, range=12.0, inner_angle=0.5, outer_angle=0.9)
    lb.point((0.0, 0.8, 0.0), color=(0.9, 1.0, 0.8), intensity=4.0, range=7.0)
    # Unshadowed fill lights.
    rng = np.random.default_rng(5)
    for _ in range(24):
        lb.point(tuple(rng.uniform([-4, 0.2, -4], [4, 2.0, 4]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=0.8, range=2.0)
    lights = lb.build()

    mats = make_materials(
        base_color=[(0.85, 0.55, 0.35), (0.5, 0.65, 0.85), (0.7, 0.8, 0.5),
                    (0.55, 0.56, 0.6)],
        metallic=[0.1, 0.3, 0.0, 0.0],
        roughness=[0.45, 0.3, 0.7, 0.85],
    )
    eye = (5.5, 4.5, -6.5)
    ctx = make_shade_context(
        mats, light_dir_ws=(0.3, -0.8, 0.4), light_color=(1.0, 0.97, 0.9),
        light_intensity=0.6, camera_pos=eye)
    return geom, objects, lights, ctx, eye


def render(geom, objects, lights, ctx, eye, w, h, use_tiled):
    cam = make_camera(w, h, eye, (0, 0, 0), fov=np.pi / 3.0)
    # Budgeted caster selection (shadow_technique.hpp:43-49): picks the two
    # spots and the first point light.
    spot_ids, point_ids = plan_shadow_casters(lights, max_spot=8, max_point=2)
    sh = render_local_shadow_maps(
        geom, objects, lights, spot_ids=spot_ids, point_ids=point_ids,
        map_size=512, pcf_radius=1, use_tiled=use_tiled,
        # LSR_DEMO_SHADOW_FILTER=esm drives the prefiltered soft-map path
        # (PARITY.md deviation); default is the reference-exact PCF.
        filter_mode=os.environ.get("LSR_DEMO_SHADOW_FILTER", "pcf"),
        # LSR_DEMO_ATLAS=packed renders the atlas as one tall-framebuffer
        # launch per stack (bit-exact vs the lax.map loop, tested).
        atlas_packed=os.environ.get("LSR_DEMO_ATLAS", "map") == "packed")

    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    if use_tiled:
        depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf)
    else:
        depth, tid = rasterize_brute(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    hdr, _ = shade_forward_plus(
        gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=32, mode="tiled", sun_model="blinn_phong",
        local_shadows=sh)  # fused-kernel path (local shadows in-kernel)
    return tonemap_pass(hdr)


def main():
    w, h = 640, 480
    geom, objects, lights, ctx, eye = build()

    imgs = {}
    for name, use_tiled in (("pallas_tiled", True), ("xla_brute", False)):
        ldr = jax.block_until_ready(
            render(geom, objects, lights, ctx, eye, w, h, use_tiled))
        img = fetch_image(ldr)
        imgs[name] = img
        print(f"{name}: ldr_hash={hashlib.sha1(img.tobytes()).hexdigest()[:16]}")

    match = bool((imgs["pallas_tiled"] == imgs["xla_brute"]).all())
    print(f"backend parity: match={match}")

    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_local_shadows.png")
    save_canvas_png(path, imgs["pallas_tiled"])
    print(f"wrote {path}")
    if not match:
        diff = (imgs["pallas_tiled"].astype(int)
                - imgs["xla_brute"].astype(int))
        print(f"  max |diff| = {np.abs(diff).max()}, "
              f"pixels differing = {(diff != 0).any(-1).sum()}")


if __name__ == "__main__":
    main()
