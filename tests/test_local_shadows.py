"""Local light shadows: spot maps + point cube faces (flagship parity).

Covers the capabilities of hello_rendering_paths.cpp:104-109 /
record_shadow_passes :6912 and the fp_stress_scene.frag:355-414
eval_local_shadow sampling semantics.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_cube, make_plane
from lsr_tpu.lighting.light_types import LightSetBuilder
from lsr_tpu.lighting.local_shadows import (
    SHADOW_POINT_CUBE,
    SHADOW_SPOT_2D,
    local_shadow_vis_stack,
    plan_shadow_casters,
    render_local_shadow_maps,
)
from lsr_tpu.scene.scene import SceneBuilder


def _occluder_scene():
    b = SceneBuilder()
    b.add(make_cube(0.8), np.asarray(m3.translate([0.0, 0.5, 0.0])))
    b.add(make_plane(6.0, y=-1.0), material=1, casts_shadow=False)
    return b.build()


def test_plan_respects_budgets():
    lb = LightSetBuilder()
    for i in range(6):
        lb.spot((i, 2, 0), (0, -1, 0))
    for i in range(4):
        lb.point((i, 1, 3))
    lb.rect_area((0, 1, -3), (0, 0, 1))
    lights = lb.build()
    spot_ids, point_ids = plan_shadow_casters(lights, max_spot=4, max_point=2)
    assert len(spot_ids) == 4 and len(point_ids) == 2
    # Area lights proxy into the spot budget in visit order (flagship :6472).
    spot_all, _ = plan_shadow_casters(lights, max_spot=8, max_point=2)
    assert 10 in spot_all


def test_spot_shadow_occludes_ground():
    geom, objects = _occluder_scene()
    lb = LightSetBuilder()
    lb.spot((0.0, 4.0, 0.0), (0.0, -1.0, 0.0), intensity=3.0, range=10.0,
            inner_angle=0.6, outer_angle=1.1)
    lights = lb.build()
    sh = render_local_shadow_maps(
        geom, objects, lights, spot_ids=(0,), point_ids=(),
        map_size=256, pcf_radius=1)
    assert sh.kinds == (SHADOW_SPOT_2D,)
    assert sh.n_slots == 1

    # Ground directly under the cube vs. ground off to the side (still in
    # the cone: radius at y=-1 is 5*tan(1.1) ~ 9.8).
    pts = jnp.asarray(
        [[[0.0, -1.0, 0.0], [2.5, -1.0, 2.5], [0.2, -1.0, -0.1]]],
        jnp.float32)
    nrm = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), pts.shape)
    vis = np.asarray(local_shadow_vis_stack(sh, pts, nrm))[0]
    assert vis.shape == (3, 2)           # K=1 shadowed + constant plane
    assert np.allclose(vis[:, 1], 1.0)   # unshadowed channel is 1.0
    assert vis[0, 0] < 0.5, f"under-cube not shadowed: {vis}"
    assert vis[1, 0] > 0.9, f"open ground wrongly shadowed: {vis}"
    assert vis[2, 0] < 0.5


def test_point_cube_shadow_selects_faces():
    # Occluder along +X of the light; the -X side must stay lit.
    b = SceneBuilder()
    b.add(make_cube(0.8), np.asarray(m3.translate([1.5, 1.0, 0.0])))
    geom, objects = b.build()
    lb = LightSetBuilder()
    lb.point((0.0, 1.0, 0.0), intensity=3.0, range=8.0)
    lights = lb.build()
    sh = render_local_shadow_maps(
        geom, objects, lights, spot_ids=(), point_ids=(0,),
        map_size=256, pcf_radius=1)
    assert sh.kinds == (SHADOW_POINT_CUBE,)
    assert sh.n_slots == 6

    pts = jnp.asarray(
        [[[4.0, 1.0, 0.0],      # behind the occluder (+X face)
          [-4.0, 1.0, 0.0],     # opposite side (-X face)
          [0.0, 1.0, 4.0]]],    # +Z, clear
        jnp.float32)
    nrm = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), pts.shape)
    vis = np.asarray(local_shadow_vis_stack(sh, pts, nrm))[0]
    assert vis[0, 0] < 0.5, f"+X not shadowed: {vis}"
    assert vis[1, 0] > 0.9, f"-X wrongly shadowed: {vis}"
    assert vis[2, 0] > 0.9, f"+Z wrongly shadowed: {vis}"
    # Out of range -> untouched.
    far = jnp.asarray([[[20.0, 1.0, 0.0]]], jnp.float32)
    nf = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), far.shape)
    vfar = np.asarray(local_shadow_vis_stack(sh, far, nf))[0]
    assert vfar[0, 0] == 1.0


def test_forward_plus_applies_local_shadows():
    """End-to-end: the lit frame darkens exactly where the occluder blocks
    the (only) spot light, and is untouched where it doesn't."""
    import jax

    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import make_camera
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    geom, objects = _occluder_scene()
    lb = LightSetBuilder()
    lb.spot((0.0, 4.0, 0.0), (0.0, -1.0, 0.0), intensity=6.0, range=10.0,
            inner_angle=0.6, outer_angle=1.1)
    lights = lb.build()
    sh = render_local_shadow_maps(
        geom, objects, lights, spot_ids=(0,), point_ids=(),
        map_size=256, pcf_radius=1)

    w, h = 160, 120
    cam = make_camera(w, h, (0.0, 5.0, -7.0), (0, 0, 0))
    mats = make_materials(base_color=[(0.8, 0.8, 0.8), (0.7, 0.7, 0.7)])
    ctx = make_shade_context(
        mats, light_dir_ws=(0.3, -1.0, 0.2), light_intensity=0.2,
        camera_pos=(0.0, 5.0, -7.0))

    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)

    def lit(shadows):
        hdr, _ = shade_forward_plus(
            gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
            tile_size=16, cap=8, mode="tiled", sun_model="blinn_phong",
            use_kernel=False, local_shadows=shadows)
        return hdr

    hdr_ns = np.asarray(jax.block_until_ready(lit(None)))
    hdr_sh = np.asarray(jax.block_until_ready(lit(sh)))

    # Shadowing only darkens; and it darkens a substantial patch.
    diff = (hdr_ns - hdr_sh).sum(-1)
    assert (diff >= -1e-4).all()
    assert (diff > 0.05).sum() > 50, f"no shadowed patch ({(diff>0.05).sum()})"

    # The disabled-shadow path with an all-unshadowed index is identical to
    # the no-stack path (onehot routes every light to the constant plane).
    sh_none = dataclasses.replace(
        sh, light_shadow_index=jnp.full_like(sh.light_shadow_index,
                                             sh.n_shadowed))
    hdr_id = np.asarray(jax.block_until_ready(lit(sh_none)))
    assert np.allclose(hdr_id, hdr_ns, atol=1e-5)


def test_local_shadows_kernel_matches_xla_path():
    """The fused kernel's per-light visibility-plane selection must agree
    with the XLA accumulation path (one-hot einsum) on a shadowed scene."""
    import jax

    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import make_camera
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    geom, objects = _occluder_scene()
    lb = LightSetBuilder()
    lb.spot((0.0, 4.0, 0.0), (0.0, -1.0, 0.0), intensity=6.0, range=10.0,
            inner_angle=0.6, outer_angle=1.1)
    lb.point((1.5, 1.2, 1.5), intensity=3.0, range=6.0)
    lights = lb.build()
    sh = render_local_shadow_maps(
        geom, objects, lights, spot_ids=(0,), point_ids=(1,),
        map_size=256, pcf_radius=1)

    w, h = 160, 128
    cam = make_camera(w, h, (0.0, 5.0, -7.0), (0, 0, 0))
    mats = make_materials(base_color=[(0.8, 0.8, 0.8), (0.7, 0.7, 0.7)])
    ctx = make_shade_context(
        mats, light_dir_ws=(0.3, -1.0, 0.2), light_intensity=0.2,
        camera_pos=(0.0, 5.0, -7.0))
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)

    def run(use_kernel):
        hdr, _ = shade_forward_plus(
            gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
            tile_size=16, cap=8, mode="tiled", sun_model="blinn_phong",
            use_kernel=use_kernel, local_shadows=sh)
        return np.asarray(jax.block_until_ready(hdr))

    a = run(False)
    b = run(True)
    d = np.abs(a - b)
    assert d.mean() < 5e-3, d.mean()
    assert (d.max(-1) > 0.05).mean() < 0.01
    # And shadows actually darken in the kernel path too.
    hdr_ns, _ = shade_forward_plus(
        gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=8, mode="tiled", sun_model="blinn_phong",
        use_kernel=True)
    diff = (np.asarray(hdr_ns) - b).sum(-1)
    assert (diff > 0.05).sum() > 50


def test_vis_crop_bit_exact():
    """vis_crop planes must match full-screen evaluation to 1 ULP (same
    math; XLA may reassociate reductions inside the lax.cond branches),
    both when the footprint fits the crop and when it falls back."""
    import jax

    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import make_camera

    geom, objects = _occluder_scene()
    lb = LightSetBuilder()
    # Tight spot (small footprint -> crop fits), wide spot (footprint
    # exceeds the crop -> lax.cond fallback), and a point light.
    lb.spot((0.5, 3.0, 0.5), (0.0, -1.0, 0.0), intensity=3.0, range=6.0,
            inner_angle=0.2, outer_angle=0.35)
    lb.spot((0.0, 4.0, 0.0), (0.0, -1.0, 0.0), intensity=3.0, range=10.0,
            inner_angle=0.6, outer_angle=1.1)
    lb.point((1.0, 1.2, -1.0), intensity=3.0, range=5.0)
    lights = lb.build()

    w, h = 192, 128
    cam = make_camera(w, h, (0.0, 4.0, -6.0), (0, 0, 0))
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid)
    nrm = gb.normal_ws / jnp.maximum(
        jnp.linalg.norm(gb.normal_ws, axis=-1, keepdims=True), 1e-8)

    def stack(crop):
        sh = render_local_shadow_maps(
            geom, objects, lights, spot_ids=(0, 1), point_ids=(2,),
            map_size=128, point_size=64, pcf_radius=1, vis_crop=crop)
        return np.asarray(jax.block_until_ready(
            local_shadow_vis_stack(sh, gb.world_pos, nrm)))

    full = stack(())
    cropped = stack((64, 128))
    np.testing.assert_allclose(cropped, full, atol=2e-7)
    # Cascade: level 0 catches the tight spot, level 1 the point, the wide
    # spot falls through to full-screen.  Same 1-ULP contract.
    cascade = stack(((32, 128), (64, 128)))
    np.testing.assert_allclose(cascade, full, atol=2e-7)
    # Sanity: the tight spot actually shadows something.
    assert (full[..., 0] < 0.99).any()


def test_vis_crop_scales_to_vis_grid():
    """At vis_scale > 1 the crop cascade re-denominates to the strided eval
    grid (ceil(size/sc) rounded up to whole blocks) — full-res-sized levels
    would cover sc^2 x the footprint area and defeat the crop.  The scaled planes must still match the
    uncropped vis_scale planes to 1 ULP."""
    import jax

    from lsr_tpu.lighting.local_shadows import _scaled_crop_sizes
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import make_camera

    # Unit contract: ceil-div then round up to (8, 128) tiles, deduped.
    assert _scaled_crop_sizes(((560, 640), (680, 960)), 2) == \
        ((280, 384), (344, 512))
    assert _scaled_crop_sizes(((560, 640),), 1) == ((560, 640),)
    assert _scaled_crop_sizes((), 2) == ()

    geom, objects = _occluder_scene()
    lb = LightSetBuilder()
    lb.spot((0.5, 3.0, 0.5), (0.0, -1.0, 0.0), intensity=3.0, range=6.0,
            inner_angle=0.2, outer_angle=0.35)
    lb.point((1.0, 1.2, -1.0), intensity=3.0, range=5.0)
    lights = lb.build()

    w, h = 256, 128
    cam = make_camera(w, h, (0.0, 4.0, -6.0), (0, 0, 0))
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid)
    nrm = gb.normal_ws / jnp.maximum(
        jnp.linalg.norm(gb.normal_ws, axis=-1, keepdims=True), 1e-8)

    def stack(crop):
        sh = render_local_shadow_maps(
            geom, objects, lights, spot_ids=(0,), point_ids=(1,),
            map_size=128, point_size=64, pcf_radius=1, vis_scale=2,
            vis_crop=crop)
        return np.asarray(jax.block_until_ready(
            local_shadow_vis_stack(sh, gb.world_pos, nrm)))

    full = stack(())
    # Full-res-denominated cascade (the bench config shape): on the 64x128
    # eval grid the scaled levels are (32, 128) and (48, 128).
    cascaded = stack(((64, 256), (96, 256)))
    np.testing.assert_allclose(cascaded, full, atol=2e-7)
    assert (full[..., 0] < 0.99).any()


def test_default_vis_crop_cascade_shape():
    """default_vis_crop: block-aligned levels (rows x8, columns x128
    unless capped at the screen edge), strictly below full screen, unique,
    ascending area, and the aspect-variant levels span each axis fully."""
    from lsr_tpu.lighting.local_shadows import default_vis_crop

    for (h, w) in ((1080, 1920), (720, 1280), (180, 320), (128, 128)):
        cascade = default_vis_crop(h, w)
        assert len(cascade) == len(set(cascade)) > 0
        areas = [ch * cw for ch, cw in cascade]
        assert areas == sorted(areas)
        for ch, cw in cascade:
            assert (ch <= h) and (cw <= w) and not (ch >= h and cw >= w)
            assert ch % 8 == 0 or ch == h
            assert cw % 128 == 0 or cw == w
    # At flagship-class resolutions the two aspect variants must exist so
    # near-camera lights that are screen-wide on ONE axis avoid the full
    # grid.
    for (h, w) in ((1080, 1920), (720, 1280)):
        cascade = default_vis_crop(h, w)
        assert any(cw >= w and ch < h for ch, cw in cascade)
        assert any(ch >= h and cw < w for ch, cw in cascade)


def test_caster_enabled_skips_planes_exactly():
    """caster_enabled gating: disabled lights read as the all-ones plane;
    enabled lights produce bit-identical planes to the ungated path."""
    geom, objects = _occluder_scene()
    lb = LightSetBuilder()
    lb.spot((0.0, 4.0, 0.0), (0.0, -1.0, 0.0), intensity=3.0, range=10.0,
            inner_angle=0.6, outer_angle=1.1)
    lb.spot((1.0, 4.0, 1.0), (0.0, -1.0, 0.0), intensity=3.0, range=10.0,
            inner_angle=0.5, outer_angle=0.9)
    lb.point((0.0, 1.5, 0.0), intensity=3.0, range=8.0)
    lights = lb.build()

    ys, xs = jnp.meshgrid(jnp.linspace(-3, 3, 32),
                          jnp.linspace(-3, 3, 256), indexing="ij")
    wp = jnp.stack([xs, jnp.full_like(xs, -1.0), ys], axis=-1)
    nm = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), wp.shape)

    for crop in ((), ((16, 128),)):
        sh_full = render_local_shadow_maps(
            geom, objects, lights, spot_ids=(0, 1), point_ids=(2,),
            map_size=128, point_size=64, pcf_radius=1, vis_crop=crop)
        en = jnp.asarray([True, False, True])
        sh_gated = render_local_shadow_maps(
            geom, objects, lights, spot_ids=(0, 1), point_ids=(2,),
            map_size=128, point_size=64, pcf_radius=1, vis_crop=crop,
            caster_enabled=en)
        vis_full = np.asarray(local_shadow_vis_stack(sh_full, wp, nm))
        vis_gated = np.asarray(local_shadow_vis_stack(sh_gated, wp, nm))
        # Enabled planes match to 1 ULP (the lax.cond wrap lets XLA
        # reassociate fused reductions — the documented _cropped_plane
        # tolerance); the disabled plane is exactly 1.
        np.testing.assert_allclose(vis_gated[..., 0], vis_full[..., 0],
                                   atol=2e-7, rtol=0)
        np.testing.assert_allclose(vis_gated[..., 2], vis_full[..., 2],
                                   atol=2e-7, rtol=0)
        assert np.all(vis_gated[..., 1] == 1.0), "disabled plane must be 1"
        # Some pixel is actually shadowed by light 1 in the full path, so
        # the gate is doing real work.
        assert np.any(vis_full[..., 1] < 1.0)


def test_caster_enabled_image_exact():
    """End-to-end: culling an off-frustum shadowed light (slot raster +
    plane skipped) leaves the shaded frame bit-identical."""
    from lsr_tpu.lighting.light_culling import cull_lights_camera
    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import make_camera
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    geom, objects = _occluder_scene()
    lb = LightSetBuilder()
    lb.spot((0.0, 4.0, 0.0), (0.0, -1.0, 0.0), intensity=6.0, range=10.0,
            inner_angle=0.6, outer_angle=1.1)
    # Far off-frustum spot: must be culled and contribute nothing.
    lb.spot((200.0, 4.0, 200.0), (0.0, -1.0, 0.0), intensity=6.0,
            range=10.0, inner_angle=0.6, outer_angle=1.1)
    lights = lb.build()

    w, h = 160, 120
    cam = make_camera(w, h, (0.0, 5.0, -7.0), (0, 0, 0))
    mats = make_materials(base_color=[(0.8, 0.8, 0.8), (0.7, 0.7, 0.7)])
    ctx = make_shade_context(
        mats, light_dir_ws=(0.3, -1.0, 0.2), light_intensity=0.2,
        camera_pos=(0.0, 5.0, -7.0))

    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)

    lmask = np.asarray(cull_lights_camera(lights, cam.viewproj))
    assert bool(lmask[0]) and not bool(lmask[1])

    sh_full = render_local_shadow_maps(
        geom, objects, lights, spot_ids=(0, 1), point_ids=(),
        map_size=128, pcf_radius=1)
    hdr_full, _ = shade_forward_plus(
        gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=8, local_shadows=sh_full)

    lights_c = dataclasses.replace(
        lights, enabled=lights.enabled & jnp.asarray(lmask))
    sh_gated = render_local_shadow_maps(
        geom, objects, lights_c, spot_ids=(0, 1), point_ids=(),
        map_size=128, pcf_radius=1,
        caster_enabled=lights_c.enabled[jnp.asarray([0, 1])])
    hdr_gated, _ = shade_forward_plus(
        gb, ctx, lights_c, cam.view, cam.proj, cam.zn, cam.zf, w, h,
        tile_size=16, cap=8, local_shadows=sh_gated)
    np.testing.assert_allclose(np.asarray(hdr_gated),
                               np.asarray(hdr_full), atol=1e-5, rtol=1e-6)


def test_atlas_packed_matches_map():
    """The packed atlas raster (one vmapped setup + one tall-framebuffer
    launch per stack) must produce bit-identical tap tables to the lax.map
    slot loop — incl. ESM prefiltered tables and caster_enabled gating
    (culled slots render all-far either way)."""
    geom, objects = _occluder_scene()
    lb = LightSetBuilder()
    lb.spot((0.0, 4.0, 0.0), (0.0, -1.0, 0.0), intensity=3.0, range=10.0,
            inner_angle=0.6, outer_angle=1.1)
    lb.spot((2.0, 4.0, 1.0), (0.0, -1.0, 0.0), intensity=3.0, range=9.0,
            inner_angle=0.5, outer_angle=1.0)
    lb.point((0.5, 1.5, 0.5), intensity=3.0, range=8.0)
    lights = lb.build()

    for kw in (dict(filter_mode="pcf"), dict(filter_mode="esm"),
               dict(filter_mode="esm",
                    caster_enabled=jnp.asarray([True, False, True]))):
        sh_map = render_local_shadow_maps(
            geom, objects, lights, spot_ids=(0, 1), point_ids=(2,),
            map_size=128, point_size=64, pcf_radius=1, **kw)
        for strategy in (True, "hybrid"):
            sh_packed = render_local_shadow_maps(
                geom, objects, lights, spot_ids=(0, 1), point_ids=(2,),
                map_size=128, point_size=64, pcf_radius=1,
                atlas_packed=strategy, **kw)
            np.testing.assert_array_equal(
                np.asarray(sh_map.spot_taps),
                np.asarray(sh_packed.spot_taps),
                err_msg=f"spot taps differ for {kw} ({strategy})")
            np.testing.assert_array_equal(
                np.asarray(sh_map.point_taps),
                np.asarray(sh_packed.point_taps),
                err_msg=f"point taps differ for {kw} ({strategy})")
