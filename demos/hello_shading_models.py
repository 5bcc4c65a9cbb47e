"""Shading-model contact sheet: the hello-3d-primitives pipeline family.

Parity targets: one panel per reference executable —
HelloPipelineFlat/Gouraud/Phong/BlinnPhong/Toon/Gooch/OrenNayar and
HelloPipelineNormalZbufferDebug (hello-3d-primitives/CMakeLists.txt;
shading math per builtin_shaders.hpp:105/154 and the per-demo fragment
lambdas).  Renders the monkey under every registered shading model plus
the normal/depth debug views as a 3x3 sheet.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsr_tpu.core.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.png import save_canvas_png
from lsr_tpu.render import concat_scene, render_forward, simple_camera
from lsr_tpu.shading.common import make_materials
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu.utils.host import fetch_image
from lsr_tpu.resources.assets import make_head_mesh


MODELS = (
    "flat", "gouraud", "phong",
    "blinn_phong", "toon", "gooch",
    "oren_nayar", "debug_normal", "debug_depth",
)


def main():
    w, h = 256, 256
    monkey = make_head_mesh()
    batch = {k: jnp.asarray(v) for k, v in concat_scene([monkey]).items()}
    models = jnp.asarray(np.asarray(m3.rotate_y(0.4))[None])
    nmats = jnp.asarray(np.asarray(m3.normal_matrix(m3.rotate_y(0.4)))[None])
    eye = (0.35, 0.25, -2.6)
    vp, zn, zf = simple_camera(w, h, eye, (0, 0, 0))

    mats = make_materials(
        base_color=[(0.8, 0.55, 0.35)], metallic=[0.05], roughness=[0.45],
    )
    ctx = make_shade_context(
        mats,
        light_dir_ws=(0.45, -0.7, 0.55),
        light_color=(1.0, 0.97, 0.92),
        light_intensity=2.6,
        camera_pos=eye,
    )

    rows, row = [], []
    for name in MODELS:
        ldr, _ = render_forward(
            batch, models, nmats, vp, zn, zf, ctx, w, h,
            model_name=name, background=(0.05, 0.06, 0.09),
        )
        row.append(ldr)
        print(f"{name}: done")
        if len(row) == 3:
            rows.append(jnp.concatenate(row, axis=1))
            row = []
    sheet = jnp.concatenate(rows, axis=0)

    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_shading_models.png")
    img = fetch_image(sheet)
    save_canvas_png(path, img)
    arr = np.asarray(img)
    # Panels must differ pairwise (each model shades differently).
    ph, pw = h, w
    panels = [arr[r * ph:(r + 1) * ph, c * pw:(c + 1) * pw]
              for r in range(3) for c in range(3)]
    dupes = sum(
        (panels[i] == panels[j]).all()
        for i in range(9) for j in range(i + 1, 9))
    print(f"wrote {path} (duplicate panels: {dupes})")
    assert dupes == 0, "distinct shading models produced identical panels"


if __name__ == "__main__":
    main()
