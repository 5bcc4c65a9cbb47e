"""2D pixel-primitive contact sheet: the hello-pixel-primitives family.

Parity targets (one panel per reference executable,
cpp-folders/src/hello-pixel-primitives/CMakeLists.txt): HelloPixel (pixel
grid), HelloLine (line star, shs_renderer.hpp:808 Bresenham semantics),
HelloTriangle (outline + filled), HelloCirclePoly (segmented circle),
HelloTexture (image blit + alpha blend over the canvas).  All panels render
headless through the legacy-lib analogs in lsr_tpu.raster.primitives2d /
lines and present as one PNG.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from lsr_tpu.core.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from lsr_tpu.io.png import save_canvas_png
from lsr_tpu.raster.lines import rasterize_lines
from lsr_tpu.raster.primitives2d import (
    alpha_blend,
    draw_circle_poly,
    draw_triangle_outline,
    fill_rect,
    fill_triangle_2d,
    image_blit,
)
from lsr_tpu.shading.common import checkerboard_texture
from lsr_tpu.utils.host import fetch_image

PANEL = 200


def panel_pixels():
    """HelloPixel: a dot grid lit one pixel at a time."""
    c = jnp.zeros((PANEL, PANEL, 3), jnp.uint8)
    ys, xs = np.mgrid[10:PANEL:16, 10:PANEL:16]
    for y, x in zip(ys.ravel().tolist(), xs.ravel().tolist()):
        c = fill_rect(c, x, y, 2, 2, (90 + (x * 79) % 166, 200, 120))
    return c


def panel_lines():
    """HelloLine: a star of lines from the panel center."""
    c = jnp.zeros((PANEL, PANEL, 3), jnp.uint8)
    n = 24
    ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    cx = cy = PANEL // 2
    p0 = np.tile([[cx, cy]], (n, 1)).astype(np.float32)
    p1 = np.stack([cx + 92 * np.cos(ang), cy + 92 * np.sin(ang)], -1)
    return rasterize_lines(
        c, jnp.asarray(p0), jnp.asarray(p1.astype(np.float32)),
        (240, 210, 90))


def panel_triangles():
    """HelloTriangle: outline + filled triangle."""
    c = jnp.zeros((PANEL, PANEL, 3), jnp.uint8)
    c = draw_triangle_outline(
        c, ((20.0, 30.0), (95.0, 170.0), (170.0, 60.0)), (90, 170, 250))
    c = fill_triangle_2d(
        c, ((60.0, 40.0), (180.0, 120.0), (110.0, 185.0)), (250, 120, 90))
    return c


def panel_circle():
    """HelloCirclePoly: segmented circles of decreasing tessellation."""
    c = jnp.zeros((PANEL, PANEL, 3), jnp.uint8)
    for r, seg, col in ((80, 48, (120, 220, 250)), (52, 12, (250, 220, 120)),
                        (26, 5, (220, 120, 250))):
        c = draw_circle_poly(c, PANEL // 2, PANEL // 2, r, seg, col)
    return c


def panel_texture():
    """HelloTexture: checkerboard blit + translucent overlay blend."""
    c = jnp.zeros((PANEL, PANEL, 3), jnp.uint8)
    tex = (np.asarray(checkerboard_texture(96))[..., :3] * 255).astype(
        np.uint8)
    c = image_blit(c, jnp.asarray(tex), 16, 16)
    c = image_blit(c, jnp.asarray(tex), 88, 88)
    overlay = jnp.zeros((PANEL, PANEL, 3), jnp.uint8)
    overlay = fill_rect(overlay, 40, 70, 120, 60, (255, 60, 30))
    return alpha_blend(c, overlay, 0.45)


def main():
    panels = [panel_pixels(), panel_lines(), panel_triangles(),
              panel_circle(), panel_texture()]
    pad = jnp.zeros((PANEL, PANEL, 3), jnp.uint8)
    panels.append(pad)
    grid = jnp.concatenate(
        [jnp.concatenate(panels[:3], axis=1),
         jnp.concatenate(panels[3:], axis=1)], axis=0)
    out = os.path.join(os.path.dirname(__file__), "..", "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "hello_pixel_primitives.png")
    img = fetch_image(grid)
    save_canvas_png(path, img)
    lit = int((np.asarray(img) > 0).any(-1).sum())
    print(f"wrote {path} (lit px: {lit})")
    assert lit > 5000, "contact sheet unexpectedly empty"


if __name__ == "__main__":
    main()
