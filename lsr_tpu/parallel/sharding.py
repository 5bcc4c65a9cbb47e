"""Multi-chip scaling: device meshes + sharded render steps.

The reference is single-process (SURVEY.md §2.3); its scaling axes are screen
tiles and job workers.  Across devices the natural axes are:

- **dp** (data parallel): independent frames/cameras/views per device — the
  renderer analog of batch parallelism (e.g. cubemap faces, stereo eyes,
  multi-camera capture rigs),
- **sp** (screen-space parallel): horizontal framebuffer bands per device —
  geometry is replicated, every device rasterizes only its band (the
  rasterizer's y_offset/full_height path), and the image is the concatenation
  of bands over the mesh axis.  No cross-band halo is needed because triangle
  coverage is computed per pixel from replicated setup (the z-buffer is
  band-local by construction).

Both compose: mesh ("dp", "sp").
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import scene_setup
from lsr_tpu.passes.tonemap import tonemap_pass
from lsr_tpu.shading.models import SHADING_MODELS, composite_over_background


def make_mesh(n_devices: int, dp: int | None = None, devices=None) -> Mesh:
    """Build a ("dp", "sp") mesh over the first n devices."""
    if devices is None:
        devices = jax.devices()[:n_devices]
    if dp is None:
        dp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    sp = n_devices // dp
    if len(devices) < dp * sp:
        raise ValueError(
            f"make_mesh needs {dp * sp} devices (dp={dp} x sp={sp}) but only "
            f"{len(devices)} are visible. For CI/dryrun, force virtual CPU "
            "devices BEFORE importing jax: XLA_FLAGS="
            f"--xla_force_host_platform_device_count={dp * sp} "
            "JAX_PLATFORMS=cpu (see lsr_tpu/parallel/dryrun.py)."
        )
    arr = np.asarray(devices[: dp * sp]).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def _band_window(band_h: int, tile_size: int) -> int:
    """Light-tile rows of the window a row band shades.

    A band of whole light tiles shades exactly its rows.  A band that is
    not (1080 rows in 4 bands of 270 with 16-px tiles) shades the
    tile-aligned window around it and keeps its own rows, so every pixel
    sees the same tile list as in the unsharded frame."""
    extra = tile_size - 1 if band_h % tile_size else 0
    return -(-(band_h + extra) // tile_size)


def _window_lists(lists, tiles_x: int, ty0, n_rows: int):
    """Rows [ty0, ty0 + n_rows) of a (tiles, cap) tile-list table; rows past
    the frame are empty (-1)."""
    rows = lists.reshape(-1, tiles_x, lists.shape[-1])
    rows = jnp.concatenate(
        [rows, jnp.full((n_rows,) + rows.shape[1:], -1, rows.dtype)])
    win = jax.lax.dynamic_slice_in_dim(rows, ty0, n_rows, axis=0)
    return win.reshape(n_rows * tiles_x, -1)


def render_band(geom, objects, viewproj, zn, zf, shade_ctx,
                width, height, band_h, y_offset,
                model_name="blinn_phong", background=(0.04, 0.06, 0.1),
                cap=512, use_tiled=True):
    """Render global rows [y_offset, y_offset+band_h) of a (height, width)
    frame.  Pure function, callable inside shard_map."""
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        viewproj, width, height, obj_visible=objects.visible,
    )
    if use_tiled:
        from lsr_tpu.raster.tiled import rasterize_direct

        depth, tid, _ = rasterize_direct(
            setup, width, band_h, zn, zf,
            y_offset=y_offset, full_height=height,
        )
    else:
        from lsr_tpu.raster.brute import rasterize_brute
        # The brute path has no band support; raster full then slice.
        d_full, t_full = rasterize_brute(setup, width, height, zn, zf)
        depth = jax.lax.dynamic_slice_in_dim(d_full, y_offset, band_h, 0)
        tid = jax.lax.dynamic_slice_in_dim(t_full, y_offset, band_h, 0)
    gb = interpolate_gbuffer(setup, depth, tid, y_offset=y_offset)
    shaded = SHADING_MODELS[model_name](gb, shade_ctx)
    bg = jnp.broadcast_to(jnp.asarray(background, jnp.float32), shaded.shape)
    hdr = composite_over_background(shaded, gb, bg)
    return tonemap_pass(hdr)


def make_sharded_flagship(mesh: Mesh, geom, objects, shade_ctx, lights,
                          width: int, height: int, shadow_size: int = 256,
                          tile_size: int = 16, model_name: str = "pbr_mr",
                          local_map: int = 128, local_point: int = 64,
                          with_local: bool = True, with_cull: bool = True):
    """Full flagship frame (per-frame cull + sun shadow + local shadow
    atlas + forward+ + tonemap + FXAA) sharded over a ("dp", "sp") mesh —
    the multi-chip composition of the whole reference-complete pipeline
    (hello_rendering_paths.cpp:8360 frame structure):

    - The 2048^2-class sun shadow map is itself rendered in sp ROW BANDS and
      assembled with ONE `lax.all_gather` over the "sp" axis, because
      every band's PCF sampling needs the full map.
    - The LOCAL SHADOW ATLAS (8 spot + 2 point x 6 faces,
      hello_rendering_paths.cpp:104-109) shards its SLOTS over "sp": each
      rank depth-renders + packs its slice of the slot stack, and one
      `lax.all_gather` per stack assembles the tap tables everywhere —
      model parallelism for the shadow workload.
    - Per-frame scene culling (frustum + software occlusion at proxy
      resolution, :94-97) runs replicated per dp camera — the proxy
      raster is ~2% of the frame, so replication beats an extra gather.
    - Screen rows shard over "sp" (band raster + interp + shadow visibility
      + local visibility planes + binned light accumulation on band-sliced
      tile lists); cameras shard over "dp".
    - FXAA exchanges 1-row halos with `lax.ppermute` between band
      neighbors, so the sharded post-process is BIT-EXACT vs single device
      (frame borders clamp exactly like the unsharded pass).

    Input: viewprojs (B,4,4), views (B,4,4), proj (4,4), zn, zf,
    sun_dir (3,).  Output: (B, height, width, 3) u8 sharded (dp, sp).
    """
    import dataclasses as _dc

    from jax import lax

    from lsr_tpu.camera.light_camera import build_dir_light_camera
    from lsr_tpu.geometry.occlusion import (
        occlusion_cull_aabbs, render_occluder_depth)
    from lsr_tpu.geometry.volumes import frustum_cull_objects
    from lsr_tpu.lighting.light_culling import cull_lights_tiled
    from lsr_tpu.lighting.light_runtime import accumulate_local_lights
    from lsr_tpu.lighting.local_shadows import (
        _TAP_STRIDE, LocalShadowMaps, _render_slot_stack,
        local_shadow_vis_stack, plan_shadow_casters, plan_slot_stacks,
        shadow_index_for_lights)
    from lsr_tpu.lighting.shadow_sample import make_shadow_context
    from lsr_tpu.passes.post import fxaa_pass
    from lsr_tpu.raster.setup import CULL_NONE, DEPTH_NDC01
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import object_world_aabbs, shadow_caster_aabb
    from lsr_tpu.shading.common import gather_materials
    from lsr_tpu.shading.models import (
        SHADING_MODELS, composite_over_background, _norm)

    sp = mesh.shape["sp"]
    assert height % sp == 0, "height must split into sp bands"
    assert shadow_size % sp == 0
    band_h = height // sp
    sm_band_h = shadow_size // sp
    tiles_x = -(-width // tile_size)
    win_tiles = _band_window(band_h, tile_size)
    win_h = win_tiles * tile_size

    spot_ids, point_ids = (plan_shadow_casters(lights) if with_local
                           else ((), ()))

    def step(viewprojs, views, proj, zn, zf, sun_dir):
        def shard_fn(vp_local, view_local):
            sp_idx = jax.lax.axis_index("sp")

            # --- local shadow atlas: SLOTS shard over "sp" ---------------
            local_sh = None
            if with_local and (spot_ids or point_ids):
                (kinds, base_slots, c_pos, c_rng, strengths,
                 spot_vp, point_vp) = plan_slot_stacks(
                    lights, spot_ids, point_ids)
                caster_mask = objects.casts_shadow & objects.visible

                def sharded_taps(vp_stack, size):
                    n = vp_stack.shape[0]
                    if n == 0:
                        return None
                    per = -(-n // sp)
                    pad = per * sp - n
                    vp_pad = jnp.concatenate(
                        [vp_stack,
                         jnp.zeros((pad, 4, 4), jnp.float32)]) \
                        if pad else vp_stack
                    vp_loc = lax.dynamic_slice_in_dim(
                        vp_pad, sp_idx * per, per, 0)
                    taps_loc = _render_slot_stack(
                        geom, objects, vp_loc, size, caster_mask,
                        True, 2)               # (per*na2, win^2)
                    taps = lax.all_gather(taps_loc, "sp", axis=0,
                                          tiled=True)
                    na2 = (-(-size // _TAP_STRIDE)) ** 2
                    return taps[: n * na2]

                local_sh = LocalShadowMaps(
                    spot_taps=sharded_taps(spot_vp, local_map),
                    point_taps=sharded_taps(point_vp, local_point),
                    spot_viewproj=spot_vp.reshape(-1, 16),
                    point_viewproj=point_vp.reshape(-1, 16),
                    caster_pos=jnp.stack(c_pos),
                    caster_range=jnp.stack(c_rng),
                    light_shadow_index=shadow_index_for_lights(
                        lights, spot_ids, point_ids),
                    strength=jnp.asarray(strengths, jnp.float32),
                    bias_const=jnp.float32(2e-3),
                    bias_slope=jnp.float32(6e-3),
                    spot_size=local_map, point_size=local_point,
                    # Reference flagship samples locals at the sun's pcf
                    # radius 2 (hello_rendering_paths.cpp:6397/:6650).
                    pcf_radius=2, kinds=tuple(kinds),
                    base_slots=tuple(base_slots),
                )

            # --- sun shadow map: band raster + all_gather ----------------
            smin, smax = shadow_caster_aabb(objects)
            _, _, light_vp = build_dir_light_camera(
                smin, smax, sun_dir, shadow_size)
            caster_mask = objects.casts_shadow & objects.visible
            # Depth-only setup, matching passes/shadow.render_shadow_map's
            # path exactly (the sharded sun map must stay bit-identical to
            # the single-chip flagship's — tests/test_sharding.py).
            from lsr_tpu.raster.setup import scene_setup_depth

            sm_setup = scene_setup_depth(
                geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
                objects.model, light_vp, shadow_size, shadow_size,
                cull_mode=CULL_NONE, obj_visible=caster_mask)
            sm_band, _, _ = rasterize_direct(
                sm_setup, shadow_size, sm_band_h, jnp.float32(0.0),
                jnp.float32(1.0), depth_mode=DEPTH_NDC01, track_ids=False,
                y_offset=sp_idx * sm_band_h, full_height=shadow_size,
                spatial_sort=True)
            sm_full = lax.all_gather(
                sm_band, "sp", axis=0, tiled=True)       # (S, S) everywhere
            shadow_ctx = make_shadow_context(sm_full, light_vp,
                                             pcf_radius=2)
            ctx_sh = _dc.replace(shade_ctx, shadow=shadow_ctx)

            def one(vp, view):
                y0 = sp_idx * band_h
                ty0 = y0 // tile_size          # the band's shading window
                wy0 = ty0 * tile_size
                # Per-frame scene cull (frustum + proxy occlusion,
                # hello_rendering_paths.cpp:94-97), replicated per camera.
                view_mask = objects.visible
                if with_cull:
                    wmin, wmax = object_world_aabbs(objects)
                    view_mask = view_mask & frustum_cull_objects(
                        vp, wmin, wmax)
                    occ = render_occluder_depth(
                        geom, objects, vp, zn, zf,
                        max(tile_size, width // 4),
                        max(tile_size, height // 4),
                        occluder_mask=view_mask)
                    view_mask = view_mask & occlusion_cull_aabbs(
                        occ, vp, wmin, wmax, zn, zf)
                setup = scene_setup(
                    geom.positions, geom.normals, geom.uvs, geom.indices,
                    geom.vtx_obj, geom.tri_obj, objects.model,
                    objects.normal_mat, vp, width, height,
                    obj_visible=view_mask)
                depth, tid, _ = rasterize_direct(
                    setup, width, win_h, zn, zf,
                    y_offset=wy0, full_height=height)
                gb = interpolate_gbuffer(setup, depth, tid, y_offset=wy0,
                                         materials=ctx_sh.materials)

                # Sun + ambient on the band (shadow visibility included via
                # ctx.shadow inside the shading model).
                base = SHADING_MODELS[model_name](gb, ctx_sh)

                # Full-frame tile lists (replicated compute), window rows
                # sliced — identical culling to the unsharded frame.
                lists, counts, _ = cull_lights_tiled(
                    lights, view, proj, width, height, tile_size=tile_size,
                    cap=64)
                band_lists = _window_lists(lists, tiles_x, ty0, win_tiles)
                vis_stack = None
                shadow_idx = None
                if local_sh is not None:
                    # Per-band local visibility planes from the gathered
                    # atlas tables (exact: pointwise + gather math on the
                    # band's own rows).
                    vis_stack = local_shadow_vis_stack(
                        local_sh, gb.world_pos, _norm(gb.normal_ws))
                    shadow_idx = local_sh.light_shadow_index
                diff, spec = accumulate_local_lights(
                    gb.world_pos, gb.normal_ws, ctx_sh.camera_pos, lights,
                    band_lists, width, win_h, tile_size=tile_size,
                    shadow_vis_stack=vis_stack,
                    light_shadow_index=shadow_idx)
                albedo, _, _, _, _, _ = gather_materials(
                    ctx_sh.materials, gb.obj_id, mat_rec=gb.mat)
                hdr = base + jnp.maximum(albedo, 0.0) * diff + spec
                bg = jnp.broadcast_to(
                    jnp.asarray((0.04, 0.06, 0.1), jnp.float32), hdr.shape)
                hdr = composite_over_background(hdr, gb, bg)
                ldr = jax.lax.dynamic_slice_in_dim(
                    tonemap_pass(hdr), y0 - wy0, band_h, 0)

                # FXAA with 1-row ppermute halos (bit-exact vs unsharded).
                up = lax.ppermute(ldr[-1:], "sp",
                                  [(i, i + 1) for i in range(sp - 1)])
                down = lax.ppermute(ldr[:1], "sp",
                                    [(i + 1, i) for i in range(sp - 1)])
                top = jnp.where(sp_idx == 0, ldr[:1], up)
                bottom = jnp.where(sp_idx == sp - 1, ldr[-1:], down)
                padded = jnp.concatenate([top, ldr, bottom], axis=0)
                return fxaa_pass(padded)[1:-1]

            return jax.vmap(one)(vp_local, view_local)

        out = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P("dp"), P("dp")),
            out_specs=P("dp", "sp"),
            check_vma=False,
        )(viewprojs, views)
        return out

    in_sharding = (NamedSharding(mesh, P("dp")), NamedSharding(mesh, P("dp")),
                   None, None, None, None)
    out_sharding = NamedSharding(mesh, P("dp", "sp"))
    return jax.jit(step, in_shardings=in_sharding,
                   out_shardings=out_sharding)


def make_sharded_render(mesh: Mesh, geom, objects, shade_ctx,
                        width: int, height: int,
                        model_name: str = "blinn_phong", cap: int = 512):
    """Build a jitted multi-chip render step.

    Input: viewprojs (B, 4, 4) with B = dp size (one camera per dp slice);
    zn/zf scalars.  Output: (B, height, width, 3) u8, sharded (dp, sp) —
    each device computes its (camera, band) cell.
    """
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    assert height % sp == 0, "height must divide by sp bands"
    band_h = height // sp

    def step(viewprojs, zn, zf):
        def shard_fn(vp_local):
            # vp_local: (B/dp, 4, 4); one camera per dp slice here (B==dp).
            sp_idx = jax.lax.axis_index("sp")
            y0 = sp_idx * band_h

            def one(vp):
                return render_band(
                    geom, objects, vp, zn, zf, shade_ctx,
                    width, height, band_h, y0,
                    model_name=model_name, cap=cap,
                )

            return jax.vmap(one)(vp_local)

        out = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("dp"),),
            out_specs=P("dp", "sp"),
            check_vma=False,
        )(viewprojs)
        return out

    in_sharding = (NamedSharding(mesh, P("dp")), None, None)
    out_sharding = NamedSharding(mesh, P("dp", "sp"))
    return jax.jit(step, in_shardings=in_sharding, out_shardings=out_sharding)


def make_mesh_lp(n_devices: int, sp: int | None = None,
                 lp: int | None = None, devices=None) -> Mesh:
    """Build a ("sp", "lp") mesh: framebuffer row bands x light shards.

    The lp axis is the renderer's analog of tensor/expert parallelism:
    each shard owns L/lp of the light set and the partial light
    accumulation reduces with one psum (SURVEY.md section 2.3
    multi-chip row)."""
    if devices is None:
        devices = jax.devices()[:n_devices]
    if lp is None:
        lp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    if sp is None:
        sp = n_devices // lp
    if len(devices) < sp * lp:
        raise ValueError(
            f"make_mesh_lp needs {sp * lp} devices (sp={sp} x lp={lp}) but "
            f"only {len(devices)} are visible.")
    arr = np.asarray(devices[: sp * lp]).reshape(sp, lp)
    return Mesh(arr, axis_names=("sp", "lp"))


def make_light_sharded_forward(mesh: Mesh, geom, objects, shade_ctx, lights,
                               width: int, height: int,
                               tile_size: int = 16, cap: int = 128,
                               sun_model: str = "blinn_phong",
                               background=(0.04, 0.06, 0.1)):
    """Forward+ frame with LIGHTS sharded over the "lp" mesh axis.

    Each (sp, lp) device rasterizes its row band (replicated geometry),
    bins and accumulates only its L/lp light slice, then the partial
    (diffuse, specular) sums reduce with `lax.psum` over "lp" — the
    light-set analog of tensor-parallel partial-sum reduction.  The sun +
    ambient term is computed identically on every lp shard (cheap and
    keeps the psum to the two local-light planes).

    Equal to the unsharded frame up to float reassociation of the light
    sum (psum reorders the per-light adds): NOT bit-exact, validated to
    atol ~1e-5 in tests/dryrun.  Overflow semantics: each shard's per-tile
    cap applies to its own slice, so a frame that overflows unsharded bins
    may KEEP more lights sharded (caps sized for no overflow see no
    difference).

    Input: viewproj (4,4), view (4,4), proj (4,4), zn, zf.
    Output: (height, width, 3) u8, row bands sharded over "sp".
    """
    from jax import lax

    from lsr_tpu.lighting.light_culling import cull_lights_tiled
    from lsr_tpu.lighting.light_runtime import accumulate_local_lights
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.shading.common import gather_materials

    sp = mesh.shape["sp"]
    lp = mesh.shape["lp"]
    n_lights = int(lights.type.shape[0])
    assert height % sp == 0, "height must split into sp bands"
    if n_lights % lp:
        # Pad to a multiple of lp with DISABLED lights (binned away).
        pad = lp - n_lights % lp
        lights = jax.tree_util.tree_map(
            lambda x: jnp.concatenate(
                [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)]), lights)
        lights = dataclasses.replace(
            lights, enabled=lights.enabled.at[n_lights:].set(False),
            range=lights.range.at[n_lights:].set(1e-3))
    band_h = height // sp
    tiles_x = -(-width // tile_size)
    win_tiles = _band_window(band_h, tile_size)
    win_h = win_tiles * tile_size

    def step(viewproj, view, proj, zn, zf):
        def shard_fn(lights_local):
            sp_idx = jax.lax.axis_index("sp")
            y0 = sp_idx * band_h
            ty0 = y0 // tile_size              # the band's shading window
            wy0 = ty0 * tile_size

            setup = scene_setup(
                geom.positions, geom.normals, geom.uvs, geom.indices,
                geom.vtx_obj, geom.tri_obj, objects.model,
                objects.normal_mat, viewproj, width, height,
                obj_visible=objects.visible)
            depth, tid, _ = rasterize_direct(
                setup, width, win_h, zn, zf,
                y_offset=wy0, full_height=height)
            gb = interpolate_gbuffer(setup, depth, tid, y_offset=wy0,
                                     materials=shade_ctx.materials)

            # Sun + ambient: identical on every lp shard (no reduction).
            base = SHADING_MODELS[sun_model](gb, shade_ctx)

            # Local lights: bin MY slice over the full tile grid (same
            # culling math as unsharded), slice my window's rows,
            # accumulate, then one psum over "lp" merges the partial sums.
            lists, counts, _ = cull_lights_tiled(
                lights_local, view, proj, width, height,
                tile_size=tile_size, cap=cap)
            band_lists = _window_lists(lists, tiles_x, ty0, win_tiles)
            diff, spec = accumulate_local_lights(
                gb.world_pos, gb.normal_ws, shade_ctx.camera_pos,
                lights_local, band_lists, width, win_h,
                tile_size=tile_size)
            diff, spec = lax.psum((diff, spec), "lp")

            albedo, _, _, _, _, _ = gather_materials(
                shade_ctx.materials, gb.obj_id, mat_rec=gb.mat)
            hdr = base + jnp.maximum(albedo, 0.0) * diff + spec
            bg = jnp.broadcast_to(
                jnp.asarray(background, jnp.float32), hdr.shape)
            hdr = composite_over_background(hdr, gb, bg)
            return jax.lax.dynamic_slice_in_dim(
                tonemap_pass(hdr), y0 - wy0, band_h, 0)

        out = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("lp"),),
            out_specs=P("sp"),
            check_vma=False,
        )(lights)
        return out

    lights_sharding = jax.tree_util.tree_map(
        lambda _: NamedSharding(mesh, P("lp")), lights)
    return jax.jit(step), lights_sharding


def make_mesh_pp(n_devices: int = 2, devices=None) -> Mesh:
    """A 1-axis ("pp",) mesh for pipeline parallelism (2 stages)."""
    if devices is None:
        devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"make_mesh_pp needs {n_devices} devices")
    return Mesh(np.asarray(devices[:n_devices]), axis_names=("pp",))


def make_pipelined_render(mesh: Mesh, geom, objects, shade_ctx,
                          width: int, height: int,
                          model_name: str = "blinn_phong",
                          background=(0.04, 0.06, 0.1)):
    """PIPELINE-parallel frame stream over a 2-device ("pp",) mesh.

    The pass chain splits into two stages — stage 0: geometry setup +
    raster + G-buffer interp; stage 1: shading + composite + tonemap —
    with the inter-stage G-buffer handed from device 0 to device 1 by one
    `lax.ppermute` per step.  A `lax.scan` over the camera stream
    keeps both stages busy on consecutive frames: while device 1 shades
    frame i-1, device 0 rasterizes frame i.  This is the renderer analog
    of GPipe-style pipeline parallelism (SURVEY.md section 2.3 multi-chip
    row), complementing dp/sp (data/screen) and lp (light partial sums).

    Each device branches on its `lax.axis_index` (divergent work under
    SPMD: cond lowers to a real branch per device), so per step each chip
    executes only its own stage.  Output frame i equals the single-device
    render of camera i-1 BIT-EXACTLY (same stage math, only the handoff
    moves the buffers); the first output of a stream is the fill bubble
    (stage 1 shades the zero-initialized carry) and must be discarded.

    Input: viewprojs (N, 4, 4) camera stream; zn, zf scalars.
    Output: (N, height, width, 3) u8 — row i = rendered camera i-1.
    """
    import dataclasses as _dc

    from jax import lax

    from lsr_tpu.raster.tiled import rasterize_direct

    assert mesh.shape["pp"] == 2, "2-stage pipeline: pp axis must be 2"

    def stage0(vp, zn, zf):
        setup = scene_setup(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            vp, width, height, obj_visible=objects.visible)
        depth, tid, _ = rasterize_direct(setup, width, height, zn, zf)
        return interpolate_gbuffer(setup, depth, tid)

    def stage1(gb):
        shaded = SHADING_MODELS[model_name](gb, shade_ctx)
        bg = jnp.broadcast_to(jnp.asarray(background, jnp.float32),
                              shaded.shape)
        hdr = composite_over_background(shaded, gb, bg)
        return tonemap_pass(hdr)

    def gb_zeros():
        z2 = jnp.zeros((height, width), jnp.float32)
        z3 = jnp.zeros((height, width, 3), jnp.float32)
        from lsr_tpu.raster.interp import GBuffer

        return GBuffer(
            world_pos=z3, normal_ws=z3, uv=z3[..., :2], depth01=z2,
            obj_id=jnp.full((height, width), -1, jnp.int32),
            covered=jnp.zeros((height, width), bool), bary=z3,
            face_normal=z3,
            tri_id=jnp.full((height, width), -1, jnp.int32),
            tangent=z3)

    def step_stream(viewprojs, zn, zf):
        def shard_fn(vps_local):
            idx = lax.axis_index("pp")

            def one_step(carry_gb, vp):
                # Stage by device: dev 0 rasterizes the NEW frame, dev 1
                # shades the carried one.  Both return full-size values so
                # the cond branches match; the unused half is dead work
                # the scheduler never sees live (each device takes one
                # branch at runtime).
                new_gb = jax.lax.cond(
                    idx == 0,
                    lambda: stage0(vp, zn, zf),
                    lambda: carry_gb)
                ldr = jax.lax.cond(
                    idx == 1,
                    lambda: stage1(carry_gb),
                    lambda: jnp.zeros((height, width, 3), jnp.uint8))
                # Hand the fresh G-buffer 0 -> 1 for the next step.
                sent = jax.tree_util.tree_map(
                    lambda x: lax.ppermute(x[None], "pp", [(0, 1)])[0],
                    new_gb)
                return sent, ldr

            _, ldrs = jax.lax.scan(one_step, gb_zeros(), vps_local[0])
            return ldrs[None]

        out = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(None),),
            out_specs=P("pp"),
            check_vma=False,
        )(viewprojs[None])
        # Device 1 holds the shaded frames; device 0's lane is zeros.
        return out[1]

    return jax.jit(step_stream, static_argnums=())
