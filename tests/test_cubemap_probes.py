"""Cubemap-from-files loading + ENV_PROBE evaluation."""

import jax.numpy as jnp
import numpy as np
import pytest

from lsr_tpu.lighting.light_runtime import eval_env_probes
from lsr_tpu.lighting.light_types import LIGHT_ENV_PROBE, LightSetBuilder
from lsr_tpu.resources.assets import write_skybox
from lsr_tpu.resources.cubemap import load_cubemap
from lsr_tpu.sky.sky_models import sample_cubemap


@pytest.fixture(scope="module")
def water_faces(tmp_path_factory):
    # The seeded water_scene skybox, written as PNG faces and loaded back.
    sky = write_skybox(str(tmp_path_factory.mktemp("water_scene")), size=256)
    return jnp.asarray(load_cubemap(sky, size=128))


def test_load_cubemap_shapes(water_faces):
    assert water_faces.shape == (6, 128, 128, 3)
    a = np.asarray(water_faces)
    assert a.min() >= 0.0 and a.max() <= 1.0
    # Faces differ (actual images, not broadcast junk).
    assert not np.allclose(a[0], a[1])


def test_cubemap_up_is_sky_down_is_water(water_faces):
    up = np.asarray(sample_cubemap(water_faces, jnp.asarray([[0.0, 1.0, 0.0]])))
    down = np.asarray(sample_cubemap(water_faces, jnp.asarray([[0.0, -1.0, 0.0]])))
    # The water_scene skybox: sky above (blue-dominant), water below.
    assert up[0, 2] > up[0, 0], f"up not blue-ish: {up}"
    assert up[0].sum() != pytest.approx(down[0].sum(), abs=1e-3)


def test_cubemap_seams_are_continuous(water_faces):
    """Sampling directions straddling every face seam must stay close —
    the loader's flip/orientation contract (cubemap_sky.hpp:97-111)."""
    rng = np.random.default_rng(3)
    eps = 2e-3
    # Seams between +X and +Z/-Z/+Y/-Y etc: walk directions near the 45deg
    # diagonals where the face switch happens.
    t = rng.uniform(-0.9, 0.9, 64).astype(np.float32)
    pairs = []
    for a in range(3):
        for b in range(3):
            if a == b:
                continue
            for sa in (1.0, -1.0):
                for sb in (1.0, -1.0):
                    d0 = np.zeros((64, 3), np.float32)
                    d0[:, a] = sa * (1.0 + eps)
                    d0[:, b] = sb
                    d0[:, 3 - a - b] = t
                    d1 = d0.copy()
                    d1[:, a] = sa * (1.0 - eps)
                    pairs.append((d0, d1))
    for d0, d1 in pairs:
        c0 = np.asarray(sample_cubemap(water_faces, jnp.asarray(d0)))
        c1 = np.asarray(sample_cubemap(water_faces, jnp.asarray(d1)))
        err = np.abs(c0 - c1).max(axis=-1)
        # Bilinear across a seam isn't exact, but must not jump (a flipped
        # face shows up as ~O(1) discontinuities on most samples).
        assert np.median(err) < 0.06, f"seam discontinuity: median {np.median(err)}"


def test_env_probe_localized_ambience():
    lb = LightSetBuilder()
    lb.point((10, 10, 10), intensity=1.0, range=1.0)  # unrelated light
    lb.env_probe((0.0, 0.0, 0.0), color=(2.0, 1.0, 0.5), intensity=1.5,
                 range=2.0)
    lights = lb.build()
    assert int(np.asarray(lights.type)[1]) == LIGHT_ENV_PROBE

    wp = jnp.asarray(
        [[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [5.0, 0.0, 0.0]]], jnp.float32)
    amb = jnp.ones((1, 3, 3), jnp.float32) * 0.2
    add = np.asarray(eval_env_probes(lights, wp, amb))
    # Center: full weight -> 0.2 * color * intensity.
    np.testing.assert_allclose(add[0, 0], 0.2 * np.asarray([2.0, 1.0, 0.5])
                               * 1.5, rtol=1e-5)
    # Halfway: smoothstep(0.5) = 0.5 factor.
    np.testing.assert_allclose(add[0, 1], add[0, 0] * 0.5, rtol=1e-5)
    # Outside range: zero.
    np.testing.assert_allclose(add[0, 2], 0.0, atol=1e-7)


def test_env_probe_in_forward_plus():
    import jax

    from lsr_tpu.core import math3d as m3
    from lsr_tpu.io.obj import make_plane
    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.scene.scene import SceneBuilder, make_camera
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    b = SceneBuilder()
    b.add(make_plane(6.0, y=0.0), material=0)
    geom, objects = b.build()
    w, h = 96, 64
    cam = make_camera(w, h, (0.0, 3.0, -4.0), (0, 0, 0))
    mats = make_materials(base_color=[(0.7, 0.7, 0.7)])
    ctx = make_shade_context(mats, light_dir_ws=(0.3, -1.0, 0.2),
                             light_intensity=0.5, camera_pos=(0.0, 3.0, -4.0))
    lb = LightSetBuilder()
    lb.env_probe((0.0, 0.2, 0.0), color=(4.0, 4.0, 4.0), intensity=2.0,
                 range=1.5)
    lights = lb.build()

    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    depth, tid = rasterize_brute(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)

    args = (gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h)
    hdr_off, _ = shade_forward_plus(*args, tile_size=16, cap=8)
    hdr_on, _ = shade_forward_plus(*args, tile_size=16, cap=8,
                                   env_probes=True)
    hdr_off = np.asarray(jax.block_until_ready(hdr_off))
    hdr_on = np.asarray(jax.block_until_ready(hdr_on))
    diff = (hdr_on - hdr_off).sum(-1)
    assert (diff >= -1e-5).all()           # additive only
    assert diff.max() > 0.01               # probe visibly brightens
    # Brightening is localized around the probe's screen region.
    lit_frac = (diff > 1e-4).mean()
    assert 0.0 < lit_frac < 0.6, f"probe not localized: {lit_frac}"
