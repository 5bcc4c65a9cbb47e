"""Normal mapping + multi-slot materials (MaterialData parity,
material.hpp:22-40: base_color_tex / normal_tex / orm_tex / emissive_tex)."""

import jax
import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_plane
from lsr_tpu.passes.forward_plus import shade_forward_plus
from lsr_tpu.raster.brute import rasterize_brute
from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import scene_setup
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import (
    apply_surface_maps,
    bump_normal_texture,
    checkerboard_texture,
    make_materials,
)
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu.resources.assets import make_head_mesh


def _frame(mats, textures, w=128, h=96):
    sb = SceneBuilder()
    sb.add(make_head_mesh(), np.asarray(m3.translate([0, 0.2, 0])))
    sb.add(make_plane(6.0, y=-1.0), material=1 % mats.base_color.shape[0],
           casts_shadow=False)
    geom, objects = sb.build()
    cam = make_camera(w, h, (0.5, 1.5, -4.0), (0, 0, 0))
    ctx = make_shade_context(
        mats, light_dir_ws=(0.3, -0.7, 0.5), camera_pos=(0.5, 1.5, -4.0),
        light_intensity=2.0,
        textures=None if textures is None else jnp.asarray(textures))
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    depth, tid = rasterize_brute(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    hdr, _ = shade_forward_plus(
        gb, ctx, _no_lights(), cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=8, sun_model="pbr_mr")
    return np.asarray(jax.block_until_ready(hdr)), gb, ctx


def _no_lights():
    from lsr_tpu.lighting.light_types import LightSetBuilder

    lb = LightSetBuilder()
    lb.point((0, 10, 0), intensity=0.0, range=0.1)
    return lb.build()


def _flat_normal_tex(size=32):
    return np.full((size, size, 3), [0.5, 0.5, 1.0], np.float32)


def test_flat_normal_map_is_identity():
    base = make_materials(base_color=[(0.8, 0.6, 0.4), (0.5, 0.5, 0.5)])
    img_none, _, _ = _frame(base, None)

    texs = np.stack([_flat_normal_tex()])
    mapped = make_materials(base_color=[(0.8, 0.6, 0.4), (0.5, 0.5, 0.5)],
                            normal_tex=[0, 0])
    img_flat, _, ctx = _frame(mapped, texs)
    assert ctx.surface_maps
    np.testing.assert_allclose(img_flat, img_none, atol=2e-3)


def test_bumpy_normal_map_changes_shading():
    texs = np.stack([bump_normal_texture(64, bumps=5)])
    base = make_materials(base_color=[(0.8, 0.6, 0.4), (0.5, 0.5, 0.5)])
    mapped = make_materials(base_color=[(0.8, 0.6, 0.4), (0.5, 0.5, 0.5)],
                            normal_tex=[0, 0])
    img_none, gb, _ = _frame(base, texs)
    img_bump, _, _ = _frame(mapped, texs)
    cov = np.asarray(gb.covered)
    diff = np.abs(img_bump - img_none).sum(-1)
    assert (diff[cov] > 0.01).mean() > 0.2, "bump map changed too few pixels"
    assert np.isfinite(img_bump).all()


def test_orm_and_emissive_slots_modulate():
    # ORM (R=ao, G=rough, B=metal) and an emissive map, applied directly.
    orm = np.full((8, 8, 3), [0.5, 0.25, 0.75], np.float32)
    em = np.full((8, 8, 3), [2.0, 0.5, 1.0], np.float32)
    texs = jnp.asarray(np.stack([orm, em]))
    uv = jnp.full((4, 4, 2), 0.5, jnp.float32)
    n = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (4, 4, 3))
    t = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (4, 4, 3))
    ids0 = jnp.zeros((4, 4), jnp.int32)
    none = jnp.full((4, 4), -1, jnp.int32)
    one_ = jnp.ones((4, 4, 1), jnp.float32)
    em_in = jnp.broadcast_to(jnp.asarray([1.0, 1.0, 1.0]), (4, 4, 3))

    n2, metal, rough, ao, emissive = apply_surface_maps(
        texs, None, uv, t, n, none, ids0, ids0 + 1,
        one_ * 0.8, one_ * 0.4, one_, em_in)
    np.testing.assert_allclose(np.asarray(n2), np.asarray(n), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ao), 0.5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(rough), 0.4 * 0.25, atol=1e-5)
    np.testing.assert_allclose(np.asarray(metal), 0.8 * 0.75, atol=1e-5)
    np.testing.assert_allclose(np.asarray(emissive)[0, 0], [2.0, 0.5, 1.0],
                               atol=1e-5)


def test_tangent_aligns_with_u_axis():
    """A z-facing quad with identity uv mapping must get tangent ~ +x."""
    from lsr_tpu.io.obj import MeshData

    pos = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.asarray([[0, 0, -1]], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    quad = MeshData(positions=pos, normals=nrm, uvs=uv, indices=idx)
    sb = SceneBuilder()
    sb.add(quad, np.eye(4, dtype=np.float32))
    geom, objects = sb.build()
    w = h = 32
    cam = make_camera(w, h, (0.5, 0.5, -2.0), (0.5, 0.5, 0.0))
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h, cull_mode=0)
    depth, tid = rasterize_brute(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid)
    cov = np.asarray(gb.covered)
    tan = np.asarray(gb.tangent)[cov]
    tan = tan / np.linalg.norm(tan, axis=-1, keepdims=True)
    np.testing.assert_allclose(tan, np.tile([[1.0, 0.0, 0.0]],
                                            (tan.shape[0], 1)), atol=1e-4)
