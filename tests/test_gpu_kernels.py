"""Compiled Triton kernels on the card (skipped on the CPU).

The CPU suite runs every kernel in Pallas interpret mode; these tests
compile them for the GPU, check that the program holds the Triton custom
call (nothing fell back to the interpreter) and compare with the plain XLA
references.  Run on the card with
`LSR_TEST_GPU=1 python -m pytest tests/ -m gpu -p no:xdist`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_plane
from lsr_tpu.lighting.light_types import LightSetBuilder
from lsr_tpu.passes.forward_plus import shade_forward_plus
from lsr_tpu.raster.brute import rasterize_brute
from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import scene_setup
from lsr_tpu.raster.tiled import rasterize_direct
from lsr_tpu.resources.assets import make_head_mesh
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import make_materials
from lsr_tpu.shading.models import make_shade_context

pytestmark = pytest.mark.gpu

TRITON_CALL = "__gpu$xla.gpu.triton"
W, H = 320, 192


def _scene():
    sb = SceneBuilder()
    sb.add(make_head_mesh(), np.asarray(m3.translate([0, 0.2, 0])))
    sb.add(make_plane(6.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build()
    cam = make_camera(W, H, (0.5, 1.5, -4.0), (0, 0, 0))
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, W, H)
    return cam, setup


def _compiled_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def test_raster_compiles_to_triton_and_matches_brute(gpu_device):
    cam, setup = _scene()

    def raster(s):
        return rasterize_direct(s, W, H, cam.zn, cam.zf,
                                spatial_sort=True)[:2]

    hlo = _compiled_text(raster, setup)
    assert TRITON_CALL in hlo and "lsr_raster" in hlo
    d_k, t_k = map(np.asarray, jax.jit(raster)(setup))
    d_r, t_r = map(np.asarray, rasterize_brute(setup, W, H, cam.zn, cam.zf))
    same = (t_k == t_r) & (t_r >= 0)
    assert (t_r >= 0).sum() > 1000
    assert np.abs(d_k - d_r)[same].max() <= 1e-6
    assert (t_k != t_r).mean() <= 1e-3


def test_shade_compiles_to_triton_and_matches_xla(gpu_device):
    cam, setup = _scene()
    d, t, _ = rasterize_direct(setup, W, H, cam.zn, cam.zf)
    mats = make_materials(base_color=[(0.8, 0.5, 0.3), (0.6, 0.6, 0.65)],
                          metallic=[0.3, 0.0], roughness=[0.4, 0.8])
    ctx = make_shade_context(mats, light_dir_ws=(0.3, -0.7, 0.5),
                             camera_pos=(0.5, 1.5, -4.0))
    gb = interpolate_gbuffer(setup, d, t, materials=ctx.materials)
    rng = np.random.default_rng(3)
    lb = LightSetBuilder()
    for i in range(32):
        p = tuple(rng.uniform([-3, 0, -3], [3, 2, 3]).tolist())
        if i % 2:
            lb.point(p, intensity=1.5, range=3.0)
        else:
            lb.spot(p, (0, -1, 0), intensity=2.0, range=4.0)
    lights = lb.build()

    def shade(g, use_kernel):
        return shade_forward_plus(g, ctx, lights, cam.view, cam.proj,
                                  cam.zn, cam.zf, W, H, cap=32,
                                  use_kernel=use_kernel)[0]

    hlo = _compiled_text(lambda g: shade(g, True), gb)
    assert TRITON_CALL in hlo and "lsr_shade" in hlo
    a = np.asarray(jax.jit(lambda g: shade(g, True))(gb))
    b = np.asarray(jax.jit(lambda g: shade(g, False))(gb))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5)
    assert jnp.isfinite(a).all()
