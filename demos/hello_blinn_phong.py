"""Config #2: Blinn-Phong monkey — filled triangles, z-buffer, texture.

Parity target: the hello_pipeline_blinn_phong_shading demo family
(hello-3d-primitives) and make_blinn_phong_program (builtin_shaders.hpp:105).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_plane
from lsr_tpu.io.png import save_canvas_png
from lsr_tpu.utils.host import fetch_image
from lsr_tpu.render import concat_scene, render_forward, simple_camera
from lsr_tpu.shading.common import checkerboard_texture, make_materials
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu.resources.assets import make_head_mesh


def main():
    w, h = 800, 600
    monkey = make_head_mesh()
    floor = make_plane(4.0, y=-1.2)
    batch = {k: jnp.asarray(v) for k, v in concat_scene([monkey, floor]).items()}

    models = np.stack([np.asarray(m3.rotate_y(0.5)), np.eye(4, dtype=np.float32)])
    nmats = np.stack([
        np.asarray(m3.normal_matrix(m3.rotate_y(0.5))), np.eye(3, dtype=np.float32)
    ])
    eye = (0.8, 0.9, -3.2)
    vp, zn, zf = simple_camera(w, h, eye, (0, -0.2, 0))

    mats = make_materials(
        base_color=[(0.85, 0.55, 0.35), (0.6, 0.62, 0.65)],
        metallic=[0.05, 0.0],
        roughness=[0.4, 0.8],
        tex_id=[-1, 0],
    )
    ctx = make_shade_context(
        mats,
        light_dir_ws=(0.45, -0.7, 0.55),
        light_color=(1.0, 0.97, 0.92),
        light_intensity=2.8,
        camera_pos=eye,
        textures=jnp.asarray(checkerboard_texture(128))[None],
    )
    ldr, gb = render_forward(
        batch, jnp.asarray(models), jnp.asarray(nmats), vp, zn, zf, ctx,
        w, h, model_name="blinn_phong", background=(0.04, 0.06, 0.1),
    )
    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_blinn_phong.png")
    save_canvas_png(path, fetch_image(ldr))
    print(f"wrote {path} covered={int(np.asarray(gb.covered).sum())}")


if __name__ == "__main__":
    main()
