"""Config-1 parity: JAX wireframe vs a direct numpy port of the reference demo."""

import numpy as np

from lsr_tpu.raster.wireframe import render_wireframe
from lsr_tpu.resources.assets import make_head_mesh

from tests.test_lines import bresenham_reference


def reference_wireframe(mesh, w, h):
    """Line-for-line numpy port of hello_wireframe.cpp:30-58 semantics."""
    canvas = np.zeros((h, w, 3), np.uint8)
    for tri in mesh.indices:
        prev = None
        for k in range(3):
            v = mesh.positions[tri[k]].astype(np.float64)
            if k > 0:
                x0 = int((prev[0] + 1.0) * w / 2.0)
                y0 = int((prev[1] + 1.0) * h / 2.0)
                x1 = int((v[0] + 1.0) * w / 2.0)
                y1 = int((v[1] + 1.0) * h / 2.0)
                if 0 < x0 < w and 0 < y0 < h and 0 < x1 < w and 0 < y1 < h:
                    for px, py in bresenham_reference(x0, y0, x1, y1):
                        if 0 <= px < w and 0 <= py < h:
                            canvas[py, px] = (0, 255, 0)
            prev = v
    return canvas


def test_wireframe_matches_reference_port():
    mesh = make_head_mesh()
    w = h = 128
    ours = np.asarray(render_wireframe(mesh, w, h))
    ref = reference_wireframe(mesh, w, h)
    assert ours.shape == ref.shape
    mismatches = (ours != ref).any(axis=-1).sum()
    assert mismatches == 0, f"{mismatches} mismatching pixels"
    assert (ref.any(axis=-1)).sum() > 500  # actually drew a monkey
