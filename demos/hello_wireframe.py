"""Config #1: wireframe Suzanne, headless PNG out (parity: hello_wireframe.cpp)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lsr_tpu.io.png import save_canvas_png
from lsr_tpu.utils.host import fetch_image
from lsr_tpu.raster.wireframe import render_wireframe
from lsr_tpu.resources.assets import make_head_mesh


def main():
    w = h = 600
    mesh = make_head_mesh()
    canvas = fetch_image(render_wireframe(mesh, w, h))
    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_wireframe.png")
    save_canvas_png(path, canvas)
    print(f"wrote {path}  ({(canvas.any(axis=-1)).sum()} lit pixels)")


if __name__ == "__main__":
    main()
