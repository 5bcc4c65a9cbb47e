"""Forward+ / clustered-forward lighting passes.

The equivalent of pass_adapters' pbr_forward_plus /
pbr_forward_clustered (pipeline/pass_adapters.hpp): sun + IBL shading from
the G-buffer, plus binned local-light accumulation (tiled or clustered),
composited over the background.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lsr_tpu.lighting.light_culling import (
    cull_lights_clustered,
    cull_lights_tiled,
    tile_depth_ranges_from_buffer,
    view_depth_to_cluster_slice,
)
from lsr_tpu.lighting.light_runtime import accumulate_local_lights
from lsr_tpu.shading.common import sample_texture_bilinear
from lsr_tpu.shading.models import SHADING_MODELS, composite_over_background


def _sun_visibility(ctx, world_pos, n, sun_vis_scale: int):
    """(H, W) sun shadow visibility, 1 where N.L <= 0 (the reference only
    samples lit pixels).  sun_vis_scale > 1 evaluates it on a strided grid
    and resizes bilinearly — the sun analog of LocalShadowMaps.vis_scale
    (scale 2 quarters the visibility gathers; pair with the ESM prefilter,
    whose penumbrae are low-frequency)."""
    from lsr_tpu.lighting.shadow_sample import shadow_visibility_dir
    from lsr_tpu.shading.models import _norm

    l_dir = _norm(-ctx.light_dir_ws)
    ndl = jnp.maximum(jnp.sum(n * l_dir[None, None], -1), 0.0)
    if sun_vis_scale > 1:
        sc = int(sun_vis_scale)
        vis_s = shadow_visibility_dir(
            ctx.shadow, world_pos[::sc, ::sc], ndl[::sc, ::sc])
        vis = jax.image.resize(vis_s, ndl.shape, "bilinear")
    else:
        vis = shadow_visibility_dir(ctx.shadow, world_pos, ndl)
    return jnp.where(ndl > 0.0, vis, 1.0)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile_size", "cap", "chunk",
                     "mode", "slices", "sun_model", "use_kernel",
                     "env_probes", "sun_vis_scale"),
)
def shade_forward_plus(
    gb,
    ctx,
    lights,
    view,
    proj,
    zn,
    zf,
    width: int,
    height: int,
    tile_size: int = 16,
    cap: int = 128,
    chunk: int = 8,
    mode: str = "tiled",  # "tiled" | "tiled_depth_range" | "clustered"
    slices: int = 16,
    sun_model: str = "pbr_mr",
    background=(0.04, 0.06, 0.1),
    use_kernel: bool = True,
    local_shadows=None,
    env_probes: bool = False,
    sun_vis_scale: int = 1,
):
    """Full lit HDR frame from a G-buffer + light set.

    local_shadows: optional lighting.local_shadows.LocalShadowMaps — applies
    spot/point/area-proxy shadow maps inside the local light loop
    (eval_local_shadow semantics, fp_stress_scene.frag:355-414).
    The sun, ambient/IBL and emissive terms are the shading model's
    (SHADING_MODELS[sun_model]); the binned local lights are accumulated by
    the Triton kernel (lighting/shade_kernel.py) with use_kernel=True, or
    by the plain XLA path with False.
    Returns (hdr (H,W,3), light_stats dict).
    """
    from lsr_tpu.shading.common import gather_materials
    from lsr_tpu.shading.models import _norm

    # Surface maps: perturb the G-buffer normal in place AND thread the
    # mapped ORM/emissive through ctx.mat_override so the sun model and the
    # local-light combine see the same surfaces (pass_adapters' shading
    # reads all four texture slots).
    if ctx.surface_maps:
        import dataclasses as _dc

        from lsr_tpu.shading.common import (
            apply_surface_maps, gather_material_texture_slots)

        base0, metal0, rough0, ao0, em0, tex0 = gather_materials(
            ctx.materials, gb.obj_id, mat_rec=getattr(gb, "mat", None))
        ntex, otex, etex = gather_material_texture_slots(
            ctx.materials, gb.obj_id, mat_rec=getattr(gb, "mat", None))
        n_mapped, metal_m, rough_m, ao_m, em_m = apply_surface_maps(
            ctx.textures, ctx.texture_quads, gb.uv, gb.tangent,
            _norm(gb.normal_ws), ntex, otex, etex,
            metal0, rough0, ao0, em0)
        albedo_m = base0
        if ctx.textures is not None:
            albedo_m = albedo_m * sample_texture_bilinear(
                ctx.textures, tex0, gb.uv, quads=ctx.texture_quads)
        gb = _dc.replace(gb, normal_ws=n_mapped)
        ctx = _dc.replace(ctx, mat_override=(
            jnp.maximum(albedo_m, 0.0), metal_m, rough_m, ao_m, em_m))

    # Sun + ambient/IBL via the built-in single-light models.
    if ctx.shadow is not None and sun_vis_scale > 1:
        import dataclasses as _dc

        ctx = _dc.replace(ctx, sun_vis=_sun_visibility(
            ctx, gb.world_pos, _norm(gb.normal_ws), sun_vis_scale))
    base = SHADING_MODELS[sun_model](gb, ctx)

    if ctx.mat_override is not None:
        albedo = ctx.mat_override[0]
    else:
        mat_base, _, _, _, _, tex_id = gather_materials(
            ctx.materials, gb.obj_id, mat_rec=getattr(gb, "mat", None))
        albedo = mat_base
        if ctx.textures is not None:
            albedo = albedo * sample_texture_bilinear(
                ctx.textures, tex_id, gb.uv, quads=ctx.texture_quads
            )
    albedo = jnp.maximum(albedo, 0.0)

    vis_stack = shadow_index = None
    if local_shadows is not None:
        from lsr_tpu.lighting.local_shadows import local_shadow_vis_stack

        vis_stack = local_shadow_vis_stack(
            local_shadows, gb.world_pos, gb.normal_ws)
        shadow_index = local_shadows.light_shadow_index

    tdr = None
    if mode == "tiled_depth_range":
        tdr = tile_depth_ranges_from_buffer(
            gb.depth01, zn, zf, width, height, tile_size)
    cluster = None
    if mode == "clustered":
        view_z = zn + gb.depth01 * (zf - zn)
        cluster = view_depth_to_cluster_slice(view_z, zn, zf, slices)

    if use_kernel:
        from lsr_tpu.lighting.shade_kernel import shade_local_lights

        # When the light set is concrete at trace time (bench / demo
        # closures; pipeline state is traced), the kernel specializes on it:
        # it skips the attenuation pow when every atten_power is 1, and
        # drops the math of light types the scene does not contain.
        unit_pow = False
        kinds = None
        if not isinstance(lights.type, jax.core.Tracer):
            kinds = tuple(sorted(int(t) for t in
                                 np.unique(np.asarray(lights.type))))
        if not isinstance(lights.atten_power, jax.core.Tracer):
            apn = np.asarray(lights.atten_power)
            unit_pow = bool(apn.size) and bool((apn == 1.0).all())
        local, bin_stats = shade_local_lights(
            gb.world_pos, gb.normal_ws, gb.covered, albedo,
            ctx.camera_pos, lights, view, proj, width, height,
            tile_size=tile_size, cap=cap, tile_depth_range=tdr,
            local_vis_stack=vis_stack, light_shadow_index=shadow_index,
            cluster_slice_plane=cluster,
            slices=slices if mode == "clustered" else 0,
            zn=zn, zf=zf, unit_atten_power=unit_pow, light_kinds=kinds,
        )
    else:
        if mode == "clustered":
            lists, _, bin_stats = cull_lights_clustered(
                lights, view, proj, zn, zf, width, height,
                tile_size=tile_size, cap=cap, slices=slices,
            )
        else:
            lists, _, bin_stats = cull_lights_tiled(
                lights, view, proj, width, height,
                tile_size=tile_size, cap=cap, tile_depth_range=tdr,
            )
        diff, spec = accumulate_local_lights(
            gb.world_pos, gb.normal_ws, ctx.camera_pos, lights, lists,
            width, height, tile_size=tile_size, chunk=chunk,
            cluster_of_pixel=cluster,
            slices=slices if mode == "clustered" else 1,
            shadow_vis_stack=vis_stack, light_shadow_index=shadow_index,
        )
        local = albedo * diff + spec

    hdr = base + local
    if env_probes:
        from lsr_tpu.lighting.light_runtime import eval_env_probes
        from lsr_tpu.shading.models import _ambient

        vv = _norm(ctx.camera_pos[None, None, :] - gb.world_pos)
        if ctx.mat_override is not None:
            _, metal_a, rough_a, ao_a, _ = ctx.mat_override
        else:
            _, metal_a, rough_a, ao_a, _, _ = gather_materials(
                ctx.materials, gb.obj_id, mat_rec=getattr(gb, "mat", None))
        amb_base = _ambient(ctx, _norm(gb.normal_ws), vv, albedo,
                            metal_a, rough_a, ao_a)
        probe = eval_env_probes(lights, gb.world_pos, amb_base)
        hdr = hdr + jnp.where(gb.covered[..., None], probe, 0.0)
    bg = jnp.broadcast_to(jnp.asarray(background, jnp.float32), hdr.shape)
    hdr = composite_over_background(hdr, gb, bg)
    return hdr, {"max_lights_per_bin": bin_stats["max_count"],
                 "overflow_bins": bin_stats["overflow_bins"]}
