"""Standard render passes: the reference's 17 pass adapters as real passes.

Wires the compute building blocks (raster kernels, light binning, shading,
post stack) into the pluggable pipeline (pipeline/pass_adapters.hpp:356-1409
analog).  Frame state is a dict of named device values; scene inputs are
provided under "geom"/"objects"/"lights"/"shade_ctx"/"camera".

Pass ids and contracts follow pass_id.hpp / pass_contract_registry.hpp so the
recipe compiler + planner validate real chains.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from lsr_tpu.core.frame import FrameParams, LightCullingMode, TechniqueMode
from lsr_tpu.pipeline.contracts import STANDARD_CONTRACTS
from lsr_tpu.pipeline.registry import PassDescriptor, PassFactoryRegistry
from lsr_tpu.pipeline.render_pass import RenderPass


def _raster(state, fp: FrameParams, depth_only: bool = False):
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct

    geom = state["geom"]
    objects = state["objects"]
    cam = state["camera"]

    # Reuse an earlier raster in the SAME plan (a depth_prepass): the
    # visibility buffer is complete, so the color pass only interpolates —
    # the reference's prepass-z + color-pass structure without paying the
    # raster twice.
    if ("depth" in state and "tid" in state and "setup" in state
            and not depth_only):
        setup = state["setup"]
        out = dict(state)
        gb = interpolate_gbuffer(setup, state["depth"], state["tid"],
                                 materials=state["shade_ctx"].materials)
        out["gbuffer"] = gb
        if fp.enable_motion_vectors:
            from lsr_tpu.passes.post import motion_vectors_pass

            out["velocity"] = motion_vectors_pass(
                gb, objects, cam.viewproj, cam.prev_viewproj,
                fp.width, fp.height,
            )
        else:
            out["velocity"] = jnp.zeros((fp.height, fp.width, 2), jnp.float32)
        return out
    # Camera raster uses the culled view mask when a scene_cull pass ran
    # (shadow passes keep objects.visible — off-screen casters still cast).
    view_mask = state.get("view_mask", objects.visible)
    cstats = None
    if geom.indices.shape[0] > fp.compact_setup_threshold:
        from lsr_tpu.raster.setup import scene_setup_compact

        setup, cstats = scene_setup_compact(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            cam.viewproj, fp.width, fp.height,
            cull_mode=fp.cull_mode, obj_visible=view_mask,
            cap_fraction=fp.compact_cap_fraction,
        )
    else:
        setup = scene_setup(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            cam.viewproj, fp.width, fp.height,
            cull_mode=fp.cull_mode, obj_visible=view_mask,
        )
    # One tiled raster serves every triangle count; use_tiled_raster=False
    # selects the pure-XLA brute anchor (the Phase-I parity backend).
    if not fp.use_tiled_raster:
        from lsr_tpu.raster.brute import rasterize_brute

        depth, tid = rasterize_brute(setup, fp.width, fp.height, cam.zn,
                                     cam.zf)
    else:
        depth, tid, _ = rasterize_direct(
            setup, fp.width, fp.height, cam.zn, cam.zf, spatial_sort=True)
    out = dict(state)
    out["setup"] = setup
    out["depth"] = depth
    out["tid"] = tid
    # RasterizerStats analog (rasterizer.hpp:48): input / post-clip counts
    # (device scalars; int() them at the observability edge).
    out["raster_stats"] = {
        "tri_input": geom.indices.shape[0],
        "tri_after_clip": jnp.sum(setup.valid),
        **({"compact_overflow": cstats.overflow,
            "compact_n_direct": cstats.n_direct}
           if cstats is not None else {}),
    }
    if not depth_only:
        gb = interpolate_gbuffer(setup, depth, tid,
                                 materials=state["shade_ctx"].materials)
        out["gbuffer"] = gb
        if fp.enable_motion_vectors:
            from lsr_tpu.passes.post import motion_vectors_pass

            out["velocity"] = motion_vectors_pass(
                gb, objects, cam.viewproj, cam.prev_viewproj,
                fp.width, fp.height,
            )
        else:
            out["velocity"] = jnp.zeros((fp.height, fp.width, 2), jnp.float32)
    return out


def _background(state, fp):
    if "sky" in state:
        return state["sky"]
    return jnp.broadcast_to(
        jnp.asarray(fp.background, jnp.float32), (fp.height, fp.width, 3)
    )


def _sun_shade(state, fp):
    from lsr_tpu.shading.models import SHADING_MODELS, composite_over_background

    gb = state["gbuffer"]
    ctx = state["shade_ctx"]
    if fp.debug_view.value != "none":
        model = f"debug_{fp.debug_view.value}"
    else:
        model = fp.shading_model
    if state.get("shadow_ctx") is not None and fp.enable_shadows:
        ctx = dataclasses.replace(ctx, shadow=state["shadow_ctx"])
    shaded = SHADING_MODELS[model](gb, ctx)
    return composite_over_background(shaded, gb, _background(state, fp))


class SceneCullPass(RenderPass):
    """Per-frame scene + light culling (the flagship's draw_frame cull step,
    hello_rendering_paths.cpp:8360 / culling_runtime.hpp:111-150):

    - frustum-cull object world AABBs against the camera,
    - optionally refine with HiZ occlusion against a low-res occluder depth
      proxy (320x180 default, hello_rendering_paths.cpp:94-97),
    - apply VisibilityHistory hysteresis (persistent 'vis_history' state) so
      conservative flicker doesn't pop,
    - optionally cull LIGHTS the same way (frustum + occlusion on their
      bounding spheres) by masking lights.enabled.

    Writes 'view_mask' — consumed by camera raster passes only.  Shadow
    passes keep objects.visible: casters outside the camera frustum still
    cast (the reference keeps separate scene/shadow element sets).
    """

    def __init__(self):
        super().__init__("scene_cull",
                         reads=("geom", "objects", "camera"),
                         writes=("view_mask", "lights", "vis_history"),
                         contract=STANDARD_CONTRACTS["scene_cull"])

    def execute_resolved(self, ctx, state, fp, request):
        from lsr_tpu.geometry.occlusion import (
            occlusion_cull_aabbs, render_occluder_depth)
        from lsr_tpu.geometry.volumes import (
            frustum_cull_objects, update_visibility_history)
        from lsr_tpu.scene.scene import object_world_aabbs

        p = fp.pass_params.culling
        out = dict(state)
        objects = state["objects"]
        cam = state["camera"]
        vis = objects.visible
        wmin, wmax = object_world_aabbs(objects)
        if p.frustum:
            vis = vis & frustum_cull_objects(cam.viewproj, wmin, wmax)
        occ_depth = None
        if p.occlusion:
            occ_depth = render_occluder_depth(
                state["geom"], objects, cam.viewproj, cam.zn, cam.zf,
                p.occ_width, p.occ_height, occluder_mask=vis)
            vis = vis & occlusion_cull_aabbs(
                occ_depth, cam.viewproj, wmin, wmax, cam.zn, cam.zf)

        hist = state.get("vis_history")
        if hist is None:
            # Init at hold_frames: an object never seen is NOT "recently
            # visible" (update_visibility_history contract, volumes.py).
            hist = jnp.full(vis.shape, p.hold_frames, jnp.int32)
        new_hist, effective = update_visibility_history(
            hist, vis, hold_frames=p.hold_frames)
        out["vis_history"] = new_hist
        out["view_mask"] = effective & objects.visible

        if p.cull_lights and "lights" in state:
            # Sphere-vs-frustum + HiZ occlusion on the light range spheres
            # (the reference tests light culling shapes the same way,
            # light_culling_runtime.hpp:266 frustum prefilter).
            from lsr_tpu.lighting.light_culling import cull_lights_camera

            lights = state["lights"]
            lmask = cull_lights_camera(
                lights, cam.viewproj,
                occ_depth=occ_depth if p.occlusion else None,
                zn=cam.zn, zf=cam.zf)
            out["lights"] = dataclasses.replace(
                lights, enabled=lights.enabled & lmask)
        return out


class LocalShadowsPass(RenderPass):
    """Local shadow atlas render (record_shadow_passes analog,
    hello_rendering_paths.cpp:104-109 + :6912): budgeted spot maps + point
    cube faces, rendered per frame into depth stacks the lighting passes
    sample via per-light visibility planes."""

    def __init__(self):
        super().__init__("local_shadows",
                         reads=("geom", "objects", "lights"),
                         writes=("local_shadow_maps",),
                         contract=STANDARD_CONTRACTS["local_shadows"])

    def execute_resolved(self, ctx, state, fp, request):
        from lsr_tpu.lighting.local_shadows import render_local_shadow_maps

        p = fp.pass_params.local_shadow
        out = dict(state)
        if not (fp.enable_shadows and p.enabled
                and (p.spot_ids or p.point_ids)):
            out["local_shadow_maps"] = None
            return out
        # Camera-culled lights (scene_cull runs before this pass and
        # rewrites lights.enabled) contribute nowhere — skip their slot
        # rasters and plane gathers (image-exact; local_shadows.py).
        lights = state["lights"]
        ids = list(p.spot_ids) + list(p.point_ids)
        caster_en = lights.enabled[jnp.asarray(ids)] if ids else None
        out["local_shadow_maps"] = render_local_shadow_maps(
            state["geom"], state["objects"], lights,
            spot_ids=tuple(p.spot_ids), point_ids=tuple(p.point_ids),
            map_size=p.map_size, point_size=p.point_size,
            pcf_radius=p.pcf_radius, bias_const=p.bias_const,
            bias_slope=p.bias_slope, vis_scale=p.vis_scale,
            vis_crop=tuple(p.vis_crop), caster_enabled=caster_en,
            filter_mode=p.filter_mode,
        )
        return out


class SkyPass(RenderPass):
    def __init__(self):
        super().__init__("sky", reads=("camera",), writes=("sky",),
                         contract=STANDARD_CONTRACTS["sky"])

    def execute_resolved(self, ctx, state, fp, request):
        from lsr_tpu.sky.sky_models import render_sky

        cam = state["camera"]
        sctx = state["shade_ctx"]
        out = dict(state)
        out["sky"] = render_sky(cam.viewproj, fp.width, fp.height,
                                kind="procedural",
                                sun_dir_ws=sctx.light_dir_ws)
        return out


class ShadowMapPass(RenderPass):
    def __init__(self):
        super().__init__("shadow_map", reads=("geom", "objects"),
                         writes=("shadow_ctx",),
                         contract=STANDARD_CONTRACTS["shadow_map"])

    def execute_resolved(self, ctx, state, fp, request):
        from lsr_tpu.passes.shadow import make_sun_shadow

        out = dict(state)
        if not fp.enable_shadows:
            out["shadow_ctx"] = None
            return out
        sctx = state["shade_ctx"]
        out["shadow_ctx"] = make_sun_shadow(
            state["geom"], state["objects"], sctx.light_dir_ws,
            fp.pass_params.shadow,
        )
        return out


class DepthPrepass(RenderPass):
    def __init__(self):
        super().__init__("depth_prepass", reads=("geom", "objects", "camera"),
                         writes=("depth", "tid", "setup"),
                         contract=STANDARD_CONTRACTS["depth_prepass"])

    def execute_resolved(self, ctx, state, fp, request):
        return _raster(state, fp, depth_only=True)


class GBufferPass(RenderPass):
    def __init__(self):
        super().__init__("gbuffer", reads=("geom", "objects", "camera"),
                         writes=("gbuffer", "depth", "tid", "velocity", "setup"),
                         contract=STANDARD_CONTRACTS["gbuffer"])

    def execute_resolved(self, ctx, state, fp, request):
        return _raster(state, fp)


class LightCullingPass(RenderPass):
    def __init__(self):
        super().__init__("light_culling",
                         reads=("lights", "camera"),
                         writes=("light_grid",),
                         contract=STANDARD_CONTRACTS["light_culling"])

    def execute_resolved(self, ctx, state, fp, request):
        from lsr_tpu.lighting.light_culling import (
            cull_lights_tiled,
            tile_depth_ranges_from_buffer,
        )

        cam = state["camera"]
        t = fp.technique
        tdr = None
        if (t.light_culling == LightCullingMode.TILED_DEPTH_RANGE
                and state.get("depth") is not None):
            tdr = tile_depth_ranges_from_buffer(
                state["depth"], cam.zn, cam.zf, fp.width, fp.height,
                t.tile_size,
            )
        lists, counts, bin_stats = cull_lights_tiled(
            state["lights"], cam.view, cam.proj, fp.width, fp.height,
            tile_size=t.tile_size, cap=t.max_lights_per_tile,
            tile_depth_range=tdr,
        )
        out = dict(state)
        out["light_grid"] = {"lists": lists, "counts": counts,
                             "max_count": bin_stats["max_count"],
                             "overflow_bins": bin_stats["overflow_bins"],
                             "slices": 1}
        return out


class ClusterBuildPass(RenderPass):
    """Computes cluster geometry (slice bounds); assignment happens next."""

    def __init__(self):
        super().__init__("cluster_build", reads=("camera",),
                         writes=("cluster_geom",),
                         contract=STANDARD_CONTRACTS["cluster_build"])

    def execute_resolved(self, ctx, state, fp, request):
        from lsr_tpu.lighting.light_culling import cluster_slice_bounds

        cam = state["camera"]
        out = dict(state)
        out["cluster_geom"] = {
            "bounds": cluster_slice_bounds(cam.zn, cam.zf,
                                           fp.technique.cluster_slices),
            "slices": fp.technique.cluster_slices,
        }
        return out


class ClusterLightAssignPass(RenderPass):
    def __init__(self):
        super().__init__("cluster_light_assign",
                         reads=("lights", "camera", "cluster_geom"),
                         writes=("light_grid",),
                         contract=STANDARD_CONTRACTS["cluster_light_assign"])

    def execute_resolved(self, ctx, state, fp, request):
        from lsr_tpu.lighting.light_culling import cull_lights_clustered

        cam = state["camera"]
        t = fp.technique
        lists, counts, bin_stats = cull_lights_clustered(
            state["lights"], cam.view, cam.proj, cam.zn, cam.zf,
            fp.width, fp.height, tile_size=t.tile_size,
            cap=t.max_lights_per_tile, slices=t.cluster_slices,
        )
        out = dict(state)
        out["light_grid"] = {"lists": lists, "counts": counts,
                             "max_count": bin_stats["max_count"],
                             "overflow_bins": bin_stats["overflow_bins"],
                             "slices": t.cluster_slices}
        return out


class SsaoPass(RenderPass):
    """Depth-only AO after the depth prepass (the reference's classic path
    registers ssao_forward as a custom pass the same way,
    demo_forward_classic_renderpath.cpp:113-114); works in every technique
    mode since only scene depth is consumed."""

    def __init__(self):
        # Declared read is "tid" (written ONLY by depth_prepass/gbuffer):
        # the depth buffer it samples is the same raster product, but
        # "depth" is ALSO re-declared by the lighting passes, and a
        # depth-read edge from them would cycle against their ssao_mask
        # read.  tid orders ssao strictly after the prepass raster.
        super().__init__("ssao", reads=("tid",),
                         writes=("ssao_mask",),
                         contract=STANDARD_CONTRACTS["ssao"])

    def execute_resolved(self, ctx, state, fp, request):
        from lsr_tpu.passes.ssao import ssao_depth_pass

        cam = state["camera"]
        out = dict(state)
        out["ssao_mask"] = ssao_depth_pass(
            state["depth"], state["tid"] >= 0, cam.zn, cam.zf)
        return out


def _local_lights(state, fp):
    from lsr_tpu.lighting.light_culling import view_depth_to_cluster_slice
    from lsr_tpu.lighting.light_runtime import accumulate_local_lights

    gb = state["gbuffer"]
    cam = state["camera"]
    sctx = state["shade_ctx"]
    grid = state["light_grid"]
    t = fp.technique
    cluster = None
    if grid["slices"] > 1:
        view_z = cam.zn + gb.depth01 * (cam.zf - cam.zn)
        cluster = view_depth_to_cluster_slice(view_z, cam.zn, cam.zf,
                                              grid["slices"])
    vis_stack = shadow_index = None
    if state.get("local_shadow_maps") is not None:
        from lsr_tpu.lighting.local_shadows import local_shadow_vis_stack
        from lsr_tpu.shading.models import _norm

        sh = state["local_shadow_maps"]
        vis_stack = local_shadow_vis_stack(
            sh, gb.world_pos, _norm(gb.normal_ws))
        shadow_index = sh.light_shadow_index
    diff, spec = accumulate_local_lights(
        gb.world_pos, gb.normal_ws, sctx.camera_pos, state["lights"],
        grid["lists"], fp.width, fp.height, tile_size=t.tile_size,
        cluster_of_pixel=cluster, slices=grid["slices"],
        shadow_vis_stack=vis_stack, light_shadow_index=shadow_index,
    )
    from lsr_tpu.shading.common import gather_materials, sample_texture_bilinear

    mat_base, _, _, _, _, tex_id = gather_materials(
        sctx.materials, gb.obj_id, mat_rec=getattr(gb, "mat", None))
    albedo = mat_base
    if sctx.textures is not None:
        albedo = albedo * sample_texture_bilinear(
            sctx.textures, tex_id, gb.uv, quads=sctx.texture_quads
        )
    local = jnp.maximum(albedo, 0.0) * diff + spec
    return jnp.where(gb.covered[..., None], local, 0.0)


class _LightingBase(RenderPass):
    """Shared sun+ambient (+optional binned local lights, ssao) lighting."""

    use_local_lights = False

    def _fused_kernel_ok(self, state, fp):
        """The fused Pallas shade kernel covers the common hot case: sun +
        binned local lights with the pbr/blinn models, no debug view and
        no SSAO modulation.  Everything else keeps the general XLA path."""
        return (
            self.use_local_lights
            and fp.debug_view.value == "none"
            and fp.shading_model in ("pbr_mr", "blinn_phong")
            and state.get("ssao_mask") is None
        )

    def execute_resolved(self, ctx, state, fp, request):
        if self._fused_kernel_ok(state, fp):
            from lsr_tpu.core.frame import LightCullingMode, TechniqueMode
            from lsr_tpu.passes.forward_plus import shade_forward_plus

            gb = state["gbuffer"]
            sctx = state["shade_ctx"]
            if state.get("shadow_ctx") is not None and fp.enable_shadows:
                sctx = dataclasses.replace(sctx, shadow=state["shadow_ctx"])
            cam = state["camera"]
            t = fp.technique
            clustered = (t.mode == TechniqueMode.CLUSTERED_FORWARD
                         or t.light_culling == LightCullingMode.CLUSTERED)
            mode = "clustered" if clustered else (
                "tiled_depth_range"
                if t.light_culling == LightCullingMode.TILED_DEPTH_RANGE
                else "tiled")
            bg = _background(state, fp)
            hdr, _ = shade_forward_plus(
                gb, sctx, state["lights"], cam.view, cam.proj, cam.zn,
                cam.zf, fp.width, fp.height, tile_size=t.tile_size,
                cap=t.max_lights_per_tile, mode=mode,
                slices=t.cluster_slices, sun_model=fp.shading_model,
                use_kernel=True,
                local_shadows=state.get("local_shadow_maps"),
                sun_vis_scale=fp.pass_params.shadow.sun_vis_scale)
            # shade_forward_plus composites a constant background; swap in
            # the frame's actual background plane (sky pass output etc.).
            hdr = jnp.where(gb.covered[..., None], hdr, bg)
            out = dict(state)
            out["hdr"] = hdr
            return out

        hdr = _sun_shade(state, fp)
        if self.use_local_lights:
            if state.get("light_grid") is None:
                # No culling pass in the chain (plain forward/deferred):
                # bin internally — observably identical to the reference's
                # per-pixel all-lights loop (culling is conservative).
                state = LightCullingPass().execute_resolved(
                    ctx, state, fp, request)
            hdr = hdr + _local_lights(state, fp)
        if state.get("ssao_mask") is not None:
            gb = state["gbuffer"]
            ao = state["ssao_mask"][..., None]
            hdr = jnp.where(gb.covered[..., None], hdr * ao, hdr)
        out = dict(state)
        out["hdr"] = hdr
        return out


class ForwardPass(_LightingBase):
    # The reference's classic forward path shades ALL local lights per
    # pixel (demo_forward_classic_renderpath fragment loop); conservative
    # binning reproduces that exactly.
    use_local_lights = True

    def __init__(self):
        # optional ssao_mask: orders an ssao pass BEFORE lighting when one
        # is in the chain (the classic+ssao composition) without gating the
        # plain chains that have no ssao producer.
        super().__init__("pbr_forward",
                         reads=("geom", "objects", "camera", "shade_ctx"),
                         writes=("hdr", "gbuffer", "depth", "velocity"),
                         contract=STANDARD_CONTRACTS["pbr_forward"],
                         optional_reads=("ssao_mask",))

    def execute_resolved(self, ctx, state, fp, request):
        state = _raster(state, fp)
        return super().execute_resolved(ctx, state, fp, request)


class ForwardPlusPass(_LightingBase):
    use_local_lights = True

    def __init__(self):
        super().__init__("pbr_forward_plus",
                         reads=("geom", "objects", "camera", "shade_ctx",
                                "light_grid"),
                         writes=("hdr", "gbuffer", "depth", "velocity"),
                         contract=STANDARD_CONTRACTS["pbr_forward_plus"])

    def execute_resolved(self, ctx, state, fp, request):
        state = _raster(state, fp)
        return super().execute_resolved(ctx, state, fp, request)


class ForwardClusteredPass(ForwardPlusPass):
    def __init__(self):
        _LightingBase.__init__(
            self, "pbr_forward_clustered",
            reads=("geom", "objects", "camera", "shade_ctx", "light_grid"),
            writes=("hdr", "gbuffer", "depth", "velocity"),
            contract=STANDARD_CONTRACTS["pbr_forward_clustered"])


class DeferredLightingPass(_LightingBase):
    use_local_lights = True

    def __init__(self, pass_id="deferred_lighting"):
        super().__init__(pass_id,
                         reads=("gbuffer", "shade_ctx", "camera"),
                         writes=("hdr",),
                         contract=STANDARD_CONTRACTS[pass_id])

    def execute_resolved(self, ctx, state, fp, request):
        if state.get("light_grid") is None:
            # Plain deferred: bin internally (observably identical to a
            # per-pixel all-lights loop, light volumes are an optimization).
            state = LightCullingPass().execute_resolved(ctx, state, fp, request)
        return super().execute_resolved(ctx, state, fp, request)


class DeferredLightingTiledPass(DeferredLightingPass):
    def __init__(self):
        super().__init__("deferred_lighting_tiled")
        self._io = dataclasses.replace(
            self._io, reads=self._io.reads + ("light_grid",)
        )


class TonemapPass(RenderPass):
    def __init__(self):
        super().__init__("tonemap", reads=("hdr",), writes=("ldr",),
                         contract=STANDARD_CONTRACTS["tonemap"])

    def execute_resolved(self, ctx, state, fp, request):
        from lsr_tpu.passes.tonemap import tonemap_pass

        out = dict(state)
        out["ldr"] = tonemap_pass(
            state["hdr"], exposure=fp.pass_params.tonemap.exposure,
            gamma=fp.pass_params.tonemap.gamma,
        )
        return out


class FxaaPass(RenderPass):
    def __init__(self):
        super().__init__("fxaa", reads=("ldr",), writes=("ldr",),
                         contract=STANDARD_CONTRACTS["fxaa"])

    def execute_resolved(self, ctx, state, fp, request):
        from lsr_tpu.passes.post import fxaa_pass

        out = dict(state)
        if fp.enable_fxaa:
            out["ldr"] = fxaa_pass(state["ldr"])
        return out


class MotionBlurPass(RenderPass):
    def __init__(self):
        super().__init__("motion_blur", reads=("hdr", "velocity", "depth"),
                         writes=("hdr",),
                         contract=STANDARD_CONTRACTS["motion_blur"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if not fp.enable_motion_blur:
            return out
        from lsr_tpu.passes.post import motion_blur_pass

        p = fp.pass_params.motion_blur
        # Runs directly on the HDR buffer (pass_motion_blur.hpp:40 operates
        # on RT_ColorHDR) — no LDR quantization mid-chain.
        out["hdr"] = motion_blur_pass(
            state["hdr"], state["depth"], state["velocity"],
            jnp.float32(fp.dt), samples=p.samples, strength=p.strength,
            depth_reject=p.depth_reject,
        )
        return out


class LightShaftsPass(RenderPass):
    def __init__(self):
        super().__init__("light_shafts", reads=("hdr", "depth"),
                         writes=("hdr",),
                         contract=STANDARD_CONTRACTS["light_shafts"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if not fp.enable_light_shafts:
            return out
        from lsr_tpu.passes.post import light_shafts_pass

        cam = state["camera"]
        sctx = state["shade_ctx"]
        p = fp.pass_params.light_shafts
        # HDR in, HDR out (pass_light_shafts.hpp:44 runs on RT_ColorHDR).
        out["hdr"] = light_shafts_pass(
            state["hdr"], state["depth"], sctx.camera_pos,
            sctx.light_dir_ws, cam.viewproj, steps=p.steps,
            density=p.density, weight=p.weight, decay=p.decay,
        )
        return out


class DepthOfFieldPass(RenderPass):
    def __init__(self):
        super().__init__("depth_of_field", reads=("hdr", "depth"),
                         writes=("hdr",),
                         contract=STANDARD_CONTRACTS["depth_of_field"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if not fp.enable_dof:
            return out
        from lsr_tpu.passes.post import depth_of_field_pass

        p = fp.pass_params.dof
        out["hdr"] = depth_of_field_pass(
            state["hdr"], state["depth"], focus_depth=p.focus_depth,
            focus_range=p.focus_range, blur_radius=p.blur_radius,
        )
        return out


class BloomPass(RenderPass):
    def __init__(self):
        super().__init__("bloom", reads=("hdr",), writes=("hdr",),
                         contract=STANDARD_CONTRACTS["bloom"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if not fp.enable_bloom:
            return out
        from lsr_tpu.passes.post import bloom_pass

        p = fp.pass_params.bloom
        out["hdr"] = bloom_pass(state["hdr"], threshold=p.threshold,
                                intensity=p.intensity,
                                blur_radius=p.blur_passes + 1)
        return out


class TaaPass(RenderPass):
    """Temporal AA; history lives in frame state under 'history_color'
    (a persistent semantic — carried across frames by the pipeline), so the
    pass stays pure and whole-plan jit works."""

    def __init__(self):
        super().__init__("taa", reads=("hdr", "velocity"), writes=("hdr",),
                         contract=STANDARD_CONTRACTS["taa"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if not fp.enable_taa:
            return out
        from lsr_tpu.passes.post import taa_pass

        hist = state.get("history_color")
        if hist is None:
            hist = state["hdr"]
        resolved, new_hist = taa_pass(
            state["hdr"], hist, state["velocity"],
            blend=fp.pass_params.taa.blend,
        )
        out["hdr"] = resolved
        out["history_color"] = new_hist
        return out


def make_standard_registry() -> PassFactoryRegistry:
    reg = PassFactoryRegistry()
    fp_modes = TechniqueMode.FORWARD_PLUS | TechniqueMode.TILED_DEFERRED
    reg.register("sky", SkyPass)
    reg.register("scene_cull", SceneCullPass)
    reg.register("shadow_map", ShadowMapPass)
    reg.register("local_shadows", LocalShadowsPass)
    reg.register("depth_prepass", DepthPrepass)
    reg.register("gbuffer", GBufferPass,
                 PassDescriptor(modes=TechniqueMode.DEFERRED
                                | TechniqueMode.TILED_DEFERRED))
    reg.register("light_culling", LightCullingPass,
                 PassDescriptor(modes=fp_modes))
    reg.register("cluster_build", ClusterBuildPass,
                 PassDescriptor(modes=TechniqueMode.CLUSTERED_FORWARD))
    reg.register("cluster_light_assign", ClusterLightAssignPass,
                 PassDescriptor(modes=TechniqueMode.CLUSTERED_FORWARD))
    reg.register("ssao", SsaoPass)
    reg.register("pbr_forward", ForwardPass,
                 PassDescriptor(modes=TechniqueMode.FORWARD))
    reg.register("pbr_forward_plus", ForwardPlusPass,
                 PassDescriptor(modes=TechniqueMode.FORWARD_PLUS))
    reg.register("pbr_forward_clustered", ForwardClusteredPass,
                 PassDescriptor(modes=TechniqueMode.CLUSTERED_FORWARD))
    reg.register("deferred_lighting", DeferredLightingPass,
                 PassDescriptor(modes=TechniqueMode.DEFERRED))
    reg.register("deferred_lighting_tiled", DeferredLightingTiledPass,
                 PassDescriptor(modes=TechniqueMode.TILED_DEFERRED))
    reg.register("tonemap", TonemapPass)
    reg.register("fxaa", FxaaPass)
    reg.register("motion_blur", MotionBlurPass)
    reg.register("light_shafts", LightShaftsPass)
    reg.register("depth_of_field", DepthOfFieldPass)
    reg.register("bloom", BloomPass)
    reg.register("taa", TaaPass)
    return reg
