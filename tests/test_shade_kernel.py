"""The Triton local-light shade kernel (interpret mode here) against the
plain XLA forward+ path: tiled, depth-range and clustered light lists, both
sun models, local shadow planes, and the static light-set
specializations."""

import jax.numpy as jnp
import numpy as np
import pytest

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_plane
from lsr_tpu.lighting.light_types import LightSetBuilder
from lsr_tpu.lighting.shade_kernel import shade_local_lights
from lsr_tpu.passes.forward_plus import shade_forward_plus
from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import scene_setup
from lsr_tpu.raster.tiled import rasterize_direct
from lsr_tpu.resources.assets import make_head_mesh
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import make_materials
from lsr_tpu.shading.models import make_shade_context

W, H = 64, 48
EYE = (0.5, 1.5, -4.0)


def _lights(mixed, n=16, seed=5):
    rng = np.random.default_rng(seed)
    b = LightSetBuilder()
    for i in range(n):
        p = tuple(rng.uniform([-3, 0, -3], [3, 2, 3]).tolist())
        c = tuple(rng.uniform(0.3, 1.0, 3).tolist())
        if mixed and i % 4 == 1:
            b.rect_area(p, (0, -1, 0), color=c, intensity=1.5, range=4.0)
        elif mixed and i % 4 == 2:
            b.tube_area(p, axis=(1, 0, 0), color=c, intensity=1.5, range=4.0)
        elif i % 2 == 0:
            b.spot(p, (0, -1, 0), color=c, intensity=2.0, range=4.0,
                   inner_angle=0.4, outer_angle=0.8)
        else:
            b.point(p, color=c, intensity=1.5, range=3.0)
    return b.build()


@pytest.fixture(scope="module")
def scene():
    sb = SceneBuilder()
    sb.add(make_head_mesh(), np.asarray(m3.translate([0, 0.2, 0])))
    sb.add(make_plane(6.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build()
    cam = make_camera(W, H, EYE, (0, 0, 0))
    mats = make_materials(base_color=[(0.8, 0.5, 0.3), (0.6, 0.6, 0.65)],
                          metallic=[0.3, 0.0], roughness=[0.4, 0.8])
    ctx = make_shade_context(mats, light_dir_ws=(0.3, -0.7, 0.5),
                             camera_pos=EYE, light_intensity=1.5)
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, W, H)
    depth, tid, _ = rasterize_direct(setup, W, H, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    return geom, objects, cam, ctx, gb


def _both(scene, lights, **kw):
    _, _, cam, ctx, gb = scene
    out = []
    for use_kernel in (False, True):
        hdr, stats = shade_forward_plus(
            gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, W, H,
            tile_size=16, cap=32, use_kernel=use_kernel, **kw)
        out.append((np.asarray(hdr), stats))
    return out


@pytest.mark.parametrize("sun_model", ["pbr_mr", "blinn_phong"])
@pytest.mark.parametrize("mode", ["tiled", "tiled_depth_range", "clustered"])
def test_kernel_matches_xla_path(scene, mode, sun_model):
    (a, sa), (b, sb) = _both(scene, _lights(mixed=False), mode=mode,
                             slices=8, sun_model=sun_model)
    # Same light lists on both paths.
    assert int(sa["max_lights_per_bin"]) == int(sb["max_lights_per_bin"])
    assert a[np.asarray(scene[4].covered)].mean() > 0.02
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5)


def test_kernel_mixed_light_types_match_xla_path(scene):
    (a, _), (b, _) = _both(scene, _lights(mixed=True), mode="tiled")
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5)


def test_kernel_local_shadow_planes_match_xla_path(scene):
    from lsr_tpu.lighting.local_shadows import render_local_shadow_maps

    geom, objects = scene[0], scene[1]
    lb = LightSetBuilder()
    lb.spot((0.0, 3.0, 0.0), (0.0, -1.0, 0.0), intensity=6.0, range=8.0,
            inner_angle=0.6, outer_angle=1.1)
    lb.point((1.5, 1.2, -1.5), intensity=3.0, range=6.0)
    lb.point((-2.0, 0.5, -1.0), intensity=2.0, range=4.0)  # unshadowed
    lights = lb.build()
    sh = render_local_shadow_maps(geom, objects, lights, spot_ids=(0,),
                                  point_ids=(1,), map_size=64, pcf_radius=1)
    (a, _), (b, _) = _both(scene, lights, mode="tiled", local_shadows=sh)
    (u, _), _ = _both(scene, lights, mode="tiled")
    assert np.abs(a - u).max() > 1e-3  # the shadows do darken something
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("mixed", [False, True], ids=["spot_point", "mixed"])
def test_shade_kernel_light_kinds_specialization(scene, mixed):
    """Static light-type specialization must be BIT-exact: dropping math
    for types absent from light_kinds changes nothing."""
    _, _, cam, _, gb = scene
    lights = _lights(mixed)
    kinds = tuple(sorted(int(t) for t in np.unique(np.asarray(lights.type))))
    eye = jnp.asarray(EYE, jnp.float32)
    albedo = jnp.full((H, W, 3), 0.6, jnp.float32)

    def run(lk, unit_pow=False):
        lit, _ = shade_local_lights(
            gb.world_pos, gb.normal_ws, gb.covered, albedo, eye,
            lights, cam.view, cam.proj, W, H,
            tile_size=16, cap=32, light_kinds=lk,
            unit_atten_power=unit_pow)
        return np.asarray(lit)

    a = run(None)
    assert (a == run(kinds)).all()
    # Every builder light has atten_power 1: skipping the pow is exact to
    # rounding.
    np.testing.assert_allclose(run(kinds, unit_pow=True), a, rtol=1e-5,
                               atol=1e-6)
