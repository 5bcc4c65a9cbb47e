"""Local light shadows: spot maps + point cube faces + area proxies.

The equivalent of the flagship's local shadow atlas
(hello_rendering_paths.cpp:104-109 — up to 8 spot maps @1024^2 and 2 point
lights x 6 cube faces @512^2 (shadow_technique.hpp:36-40 quality params) —
recorded by record_shadow_passes :6912) and the forward+ shader's
`eval_local_shadow` (shaders/vulkan/fp_stress_scene.frag:355-414), with
budgets/techniques per shadow_technique.hpp:18-119 (SpotMap2D / PointCube /
AreaProxySpotMap2D, ShadowCasterBudget, ShadowQualityParams).

Design (not a port):

- Spot (and area-proxy) maps form one depth stack (n_spot, S1, S1); point
  cube faces form a second stack (n_point*6, S2, S2), both rendered
  depth-only with the existing DEPTH_NDC01 raster path via a `lax.map`
  over stacked view-projections — one compiled slot program per stack.
  Casters are frustum-culled per slot against the slot's own frustum
  (record_shadow_passes culls casters per light in the reference).
- Sampling computes a per-pixel visibility PLANE per shadowed light
  (a (H, W, K+1) stack; channel K is the constant 1.0 "unshadowed" plane).
  Cube-face selection is per-pixel: the face index chooses the slot, and the
  projection uses that slot's own view-projection fetched with a row gather,
  so the sample stays consistent with however the raster mapped NDC to
  texels (no hand-derived face-UV table to get wrong; the reference's GLSL
  face-UV path at fp_stress_scene.frag:302 is equivalent by construction).
- The light loop then applies visibility with a one-hot (K+1)-wide matmul
  per binned light (see lighting/light_runtime.accumulate_local_lights)
  instead of a per-(pixel, light) gather.
- PCF uses the packed-tap wide-gather path (see shadow_sample.py): the
  whole (2r+1)^2 window is one take_rows() gather from a flat tap table
  covering the stack.
- vis_scale > 1 evaluates the visibility planes on a strided pixel grid and
  bilinearly upsamples — a perf knob for large framebuffers (each plane is
  a full-screen gather whose cost grows with its row count).  vis_scale=1
  is the exact per-pixel reference semantics (PARITY.md documents the knob).

Deviation from the reference, by intent: the reference's GLSL point-light
depth test compares the NORMALIZED direction's major component (<= 1.0)
against a view-space reference depth in world units
(fp_stress_scene.frag:393-410), which underestimates occlusion beyond
~1 unit.  We instead project into the selected face's frustum and compare
NDC01 depths exactly like the spot path — correct at every distance.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.core.gather import take_rows
from lsr_tpu.lighting.light_types import (
    LIGHT_POINT,
    LIGHT_RECT_AREA,
    LIGHT_SPOT,
    LIGHT_TUBE_AREA,
    LightsSoA,
)
from lsr_tpu.lighting.shadow_sample import pack_shadow_taps

# shadow_technique.hpp:18-25
SHADOW_NONE = 0
SHADOW_SPOT_2D = 2          # SpotMap2D (also AreaProxySpotMap2D)
SHADOW_POINT_CUBE = 3

_SHADOW_NEAR = 0.05          # kShadowNearZ, hello_rendering_paths.cpp:100
_LOCAL_STRENGTH = 0.72       # spot strength, hello_rendering_paths.cpp:6398

# Cube face forward/up table (make_point_shadow_face_view_proj :6824).
_FACE_DIRS = np.asarray(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    np.float32,
)
_FACE_UPS = np.asarray(
    [[0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [0, -1, 0], [0, -1, 0]],
    np.float32,
)

# Anchor stride of the packed atlas windows.  6 (not 8) so the window is
# (6+2r)^2 = 64 lanes at r=1: a narrower record per gathered row.
_TAP_STRIDE = 6


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["spot_taps", "point_taps", "spot_viewproj", "point_viewproj",
                 "caster_pos", "caster_range", "light_shadow_index",
                 "strength", "bias_const", "bias_slope", "caster_enabled"],
    meta_fields=["spot_size", "point_size", "pcf_radius", "kinds",
                 "base_slots", "vis_scale", "vis_crop", "filter_mode",
                 "esm_c"],
)
@dataclasses.dataclass(frozen=True)
class LocalShadowMaps:
    """The rendered local-shadow stacks + per-light sampling metadata.

    K = number of shadowed lights; visibility stacks carry K+1 channels
    (channel K is the constant "no shadow" plane every other light indexes).
    base_slots[k] indexes into the light's own stack: spot index for
    SPOT_2D lights, first face row (6*p) for POINT_CUBE lights.
    """
    spot_taps: jnp.ndarray | None   # (n_spot*A1^2, win1^2) packed windows
    point_taps: jnp.ndarray | None  # (n_point*6*A2^2, win2^2)
    spot_viewproj: jnp.ndarray      # (n_spot, 16) row-major flattened
    point_viewproj: jnp.ndarray     # (n_point*6, 16)
    caster_pos: jnp.ndarray        # (K, 3) light position per shadowed light
    caster_range: jnp.ndarray      # (K,)
    light_shadow_index: jnp.ndarray  # (L,) i32: k for shadowed, K otherwise
    strength: jnp.ndarray          # (K,)
    bias_const: jnp.ndarray        # scalar
    bias_slope: jnp.ndarray        # scalar
    caster_enabled: jnp.ndarray | None = None  # (K,) bool: light survived
                                   # the per-frame camera cull.  A culled
                                   # light contributes nowhere, so its slot
                                   # raster and plane gathers are skipped
                                   # (plane = 1.0); final images are exact.
    spot_size: int = 1024
    point_size: int = 512
    pcf_radius: int = 1
    kinds: tuple = ()              # per shadowed light: SHADOW_SPOT_2D | CUBE
    base_slots: tuple = ()         # per shadowed light: base in its stack
    vis_scale: int = 1
    vis_crop: tuple = ()           # static crop cascade for plane eval:
                                   # (ch, cw) or ((ch0,cw0),(ch1,cw1),...)
                                   # smallest-first; () = full-screen
                                   # (exact either way)
    filter_mode: str = "pcf"       # "pcf" (reference-exact window gather)
                                   # | "esm" (prefiltered soft map, one
                                   # 1-lane fetch per pixel; PARITY.md)
    esm_c: float = 80.0

    @property
    def n_shadowed(self) -> int:
        return len(self.kinds)

    @property
    def n_slots(self) -> int:
        return int(self.spot_viewproj.shape[0] +
                   self.point_viewproj.shape[0])


def default_vis_crop(height: int, width: int) -> tuple:
    """A four-level crop cascade rounded to whole blocks (multiples of 8
    rows and 128 columns), ascending area.

    Levels 0/1 cover the flagship orbit's measured footprints (spot bboxes
    up to 652x897 at 1080p, point range-spheres 535x558; level 1 catches
    them with zero full-screen fallbacks, level 0 is half that area for
    point lights and near-axis spot frames).  Levels 2/3 are ASPECT
    variants — (3/4 h, full w) and (full h, 3/4 w) — for lights close to
    the camera whose footprint is screen-wide on one axis only (the Phase F
    scene's overhead spots: 0.3-0.9 screen fractions, measured to overflow
    a (5/8, 1/2) ladder on every light).  A footprint that misses every
    level pays the full grid, which is the honest cost for lights that
    genuinely cover the screen.  A too-small SINGLE window is worse than
    none (measured: (256,512) alone slower than full-screen at 1080p) —
    the cascade's misses land on the next level instead."""
    def rh(f):  # height rounded up to a multiple of 8, capped
        return min(height, -(-int(height * f) // 8) * 8)

    def rw(f):
        return min(width, -(-int(width * f) // 128) * 128)

    levels = [
        (rh(33 / 64), rw(1 / 3)),
        (rh(5 / 8), rw(1 / 2)),
        (rh(3 / 4), width),
        (height, rw(3 / 4)),
    ]
    out, seen = [], set()
    for lv in levels:
        if lv not in seen and not (lv[0] >= height and lv[1] >= width):
            seen.add(lv)
            out.append(lv)
    return tuple(out)


def plan_shadow_casters(lights: LightsSoA, max_spot: int = 8,
                        max_point: int = 2, include_area_proxies: bool = True):
    """Pick which lights get shadow maps (host-side, static result).

    Mirrors the flagship's budgeted selection (hello_rendering_paths.cpp:
    6390-6646: spots and area proxies share the spot-map budget in visit
    order; points draw from their own budget).  Returns (spot_ids,
    point_ids) as tuples of python ints — static under jit.
    """
    types = np.asarray(lights.type)
    enabled = np.asarray(lights.enabled)
    spot_ids, point_ids = [], []
    for i in range(types.shape[0]):
        if not enabled[i]:
            continue
        t = int(types[i])
        if t == LIGHT_SPOT or (
            include_area_proxies and t in (LIGHT_RECT_AREA, LIGHT_TUBE_AREA)
        ):
            if len(spot_ids) < max_spot:
                spot_ids.append(i)
        elif t == LIGHT_POINT and len(point_ids) < max_point:
            point_ids.append(i)
    return tuple(spot_ids), tuple(point_ids)


def _spot_viewproj(pos, direction, outer_angle, rng):
    """build_local_shadow_vp semantics (hello_rendering_paths.cpp:6846-6860):
    lookAtLH down the light direction, perspective fov = clamp(2*outer,
    25deg, 150deg), square aspect, far = max(range, near + 0.2)."""
    d = m3.normalize(direction)
    up = jnp.where(jnp.abs(d[1]) > 0.95,
                   jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                   jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    view = m3.look_at_lh(pos, pos + d, up)
    fov = jnp.clip(2.0 * outer_angle, np.deg2rad(25.0), np.deg2rad(150.0))
    far = jnp.maximum(rng, _SHADOW_NEAR + 0.2)
    proj = m3.perspective_lh_no(fov, 1.0, _SHADOW_NEAR, far)
    return proj @ view


def _point_face_viewprojs(pos, rng):
    """make_point_shadow_face_view_proj (:6824): 6 x (90deg, square)."""
    far = jnp.maximum(rng, _SHADOW_NEAR + 0.2)
    proj = m3.perspective_lh_no(np.deg2rad(90.0), 1.0, _SHADOW_NEAR, far)
    vps = []
    for f in range(6):
        view = m3.look_at_lh(pos, pos + jnp.asarray(_FACE_DIRS[f]),
                             jnp.asarray(_FACE_UPS[f]))
        vps.append(proj @ view)
    return vps


def _stack_slot_setups(ts, slot_h: int):
    """Merge vmapped per-slot TriSetups (leading slot dim) into ONE tall-
    framebuffer setup: slot s occupies global rows [s*slot_h, (s+1)*slot_h).

    Only BBOXES shift to global rows (they route triangles to the right
    raster tiles); coefficients stay slot-local and the kernel evaluates
    pixel rows band-locally (rasterize_direct band_h=slot_h), which keeps
    the bc arithmetic bit-identical to a standalone per-slot raster.  Safe
    without a scissor when slot_h is a multiple of the raster tile height:
    a tile never spans two slots, and slot-clamped bboxes keep each
    triangle's supers inside its own slot's tile rows."""
    from lsr_tpu.raster.setup import TriSetup
    from lsr_tpu.raster.tiled import _SUPER

    s, n = ts.coef.shape[0], ts.coef.shape[1]
    ioff = (jnp.arange(s, dtype=jnp.int32) * slot_h)[:, None]
    bbox = ts.bbox.at[:, :, 1].add(ioff).at[:, :, 3].add(ioff)
    # Pad each slot's range to a whole number of raster supers so no
    # super/chunk mixes triangles of two slots (a mixed chunk would be
    # walked by both slots' tiles and, with band-local row evaluation,
    # bleed one slot's coverage into the other).
    pad = (-n) % _SUPER

    def flat(x, fill=0):
        if pad:
            widths = [(0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 2)
            x = jnp.pad(x, widths, constant_values=fill)
        return x.reshape((s * (n + pad),) + x.shape[2:])

    return TriSetup(coef=flat(ts.coef), iw=flat(ts.iw), ziw=flat(ts.ziw),
                    bbox=flat(bbox), valid=flat(ts.valid, False),
                    obj_id=flat(ts.obj_id), wp=flat(ts.wp), nw=flat(ts.nw),
                    uv=flat(ts.uv))


def _render_slot_stack(geom, objects, vp_stack, size, caster_mask,
                       use_tiled, pcf_radius, slot_enabled=None,
                       filter_mode="pcf", esm_c=80.0, slot_far=None,
                       packed=False):
    """Depth-render every slot of one stack and pack its tap table.

    Strategies, picked by `packed` (False | True | "hybrid"):

    - packed=False (the default): one lax.map over slots runs setup +
      depth raster per slot.  With caster_enabled it wraps every slot in
      lax.cond.
    - packed=True: ONE batched depth-only setup over all slots
      (scene_setup_slots_depth), merged into a tall framebuffer by
      _stack_slot_setups, then ONE rasterize_direct launch with band-local
      rows (band_h=size).  Bit-exact vs the map path.
    - packed="hybrid": the batched setup (culled slots lane-masked, no
      lax.cond anywhere) + a lax.map of per-slot raster launches.

    Which is fastest on the GPU has not been measured.

    slot_enabled: optional (n,) bool — slots whose light was culled by the
    camera this frame render as all-far depth (their planes are skipped
    anyway; see LocalShadowMaps.caster_enabled).  The batched strategies
    mask those slots' setup lanes invalid instead of lax.cond-skipping the
    raster (the far clear value is the same all-far result)."""
    from lsr_tpu.geometry.volumes import frustum_cull_objects
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.setup import CULL_NONE, DEPTH_NDC01
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import object_world_aabbs

    one = jnp.float32(1.0)
    wmin, wmax = object_world_aabbs(objects)

    def render_slot_vp(vp):
        # Per-slot caster culling (the reference culls casters per light,
        # record_shadow_passes :6912): casters outside a slot's frustum
        # produce no valid setup lanes, so its kernel skips them.
        # Depth-only setup: a shadow slot never reads normals/uvs, and the
        # lane-FMA clip order is shared with scene_setup_slots_depth so the
        # packed strategy below stays BIT-identical to this one.
        from lsr_tpu.raster.setup import scene_setup_depth

        sm = caster_mask & frustum_cull_objects(vp, wmin, wmax)
        setup = scene_setup_depth(
            geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
            objects.model, vp, size, size,
            cull_mode=CULL_NONE, obj_visible=sm,
        )
        if use_tiled:
            d, _, _ = rasterize_direct(
                setup, size, size, jnp.float32(0.0), one,
                depth_mode=DEPTH_NDC01, track_ids=False, spatial_sort=True,
            )
        else:
            d, _ = rasterize_brute(
                setup, size, size, jnp.float32(0.0), one,
                depth_mode=DEPTH_NDC01,
            )
        return d

    if packed and use_tiled:
        import dataclasses as _dc

        from lsr_tpu.raster.setup import scene_setup_slots_depth

        n = vp_stack.shape[0]
        # ONE batched depth-only multi-view setup: world transform + corner
        # gather run once, per-slot clip is broadcast lane FMAs over the
        # shared world corners (no per-slot row gather), and no normal/uv
        # work at all — NOT vmap(scene_setup), which S-folds the per-vertex
        # transform gather and lowers the clip to padded batched matmuls.
        sm = caster_mask[None] & jax.vmap(
            lambda vp: frustum_cull_objects(vp, wmin, wmax))(vp_stack)
        ts = scene_setup_slots_depth(
            geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
            objects.model, vp_stack, size, cull_mode=CULL_NONE,
            obj_visible_slots=sm)
        if slot_enabled is not None:
            ts = _dc.replace(ts, valid=ts.valid & slot_enabled[:, None])
        if packed == "hybrid":
            # Per-slot raster launches over the shared batched setup.
            def rs(st1):
                d1, _, _ = rasterize_direct(
                    st1, size, size, jnp.float32(0.0), one,
                    depth_mode=DEPTH_NDC01, track_ids=False,
                    spatial_sort=True)
                return d1
            depth = jax.lax.map(rs, ts)
        else:
            st = _stack_slot_setups(ts, size)
            d, _, _ = rasterize_direct(
                st, size, n * size, jnp.float32(0.0), one,
                depth_mode=DEPTH_NDC01, track_ids=False,
                tile_h=min(32, size), tile_w=min(32, size), band_h=size)
            depth = d.reshape(n, size, size)
    elif slot_enabled is None:
        depth = jax.lax.map(render_slot_vp, vp_stack)   # (n, S, S)
    else:
        def render_slot(args):
            vp, en = args
            return jax.lax.cond(
                en, render_slot_vp,
                lambda _: jnp.ones((size, size), jnp.float32), vp)

        depth = jax.lax.map(render_slot, (vp_stack, slot_enabled))
    from lsr_tpu.lighting import shadow_sample as _ss

    if filter_mode == "esm":
        # One packed soft table per stack: slot s occupies rows
        # [s*S*S/2, (s+1)*S*S/2).  The (2r+1)^2 box is baked in by the
        # prefilter; sampling is one 1-lane fetch per (pixel, light).
        # Perspective slots filter LINEARIZED depth (see _linearize01);
        # the far clear value 1.0 maps to lin01 = 1.0 either way.
        fars = (jnp.full((depth.shape[0],), 1.0, jnp.float32)
                if slot_far is None else jnp.asarray(slot_far, jnp.float32))

        def soft_one(d, f):
            if slot_far is not None:
                d = _linearize01(d, jnp.float32(_SHADOW_NEAR), f)
            return _ss.pack_soft_u16(_ss.prefilter_esm(d, pcf_radius,
                                                       esm_c))

        return jax.vmap(soft_one)(depth, fars).reshape(-1)
    pack = (_ss.pack_shadow_taps_u16 if _ss.TAPS_U16 else pack_shadow_taps)
    taps = jax.vmap(lambda d: pack(d, pcf_radius, _TAP_STRIDE))(depth)
    return taps.reshape(depth.shape[0] * taps.shape[1], -1)


def plan_slot_stacks(lights: LightsSoA, spot_ids: tuple, point_ids: tuple):
    """Trace-level slot metadata shared by the single-chip builder and the
    sp-sharded atlas (parallel/sharding.py): returns (kinds, base_slots,
    caster_pos (K,3), caster_range (K,), strengths [K], spot_vp (S,4,4),
    point_vp (P*6,4,4))."""
    kinds, base_slots, caster_pos, caster_range, strengths = \
        [], [], [], [], []
    spot_vps, point_vps = [], []
    for sid in spot_ids:
        spot_vps.append(_spot_viewproj(
            lights.position[sid], lights.direction[sid],
            lights.outer_angle[sid], lights.range[sid]))
        kinds.append(SHADOW_SPOT_2D)
        base_slots.append(len(spot_vps) - 1)
        caster_pos.append(lights.position[sid])
        caster_range.append(lights.range[sid])
        strengths.append(_LOCAL_STRENGTH)
    for pid in point_ids:
        kinds.append(SHADOW_POINT_CUBE)
        base_slots.append(len(point_vps))
        point_vps.extend(_point_face_viewprojs(lights.position[pid],
                                               lights.range[pid]))
        caster_pos.append(lights.position[pid])
        caster_range.append(lights.range[pid])
        strengths.append(_LOCAL_STRENGTH)
    spot_vp = (jnp.stack(spot_vps) if spot_vps
               else jnp.zeros((0, 4, 4), jnp.float32))
    point_vp = (jnp.stack(point_vps) if point_vps
                else jnp.zeros((0, 4, 4), jnp.float32))
    return (kinds, base_slots, caster_pos, caster_range, strengths,
            spot_vp, point_vp)


def shadow_index_for_lights(lights: LightsSoA, spot_ids, point_ids):
    """(L,) i32: visibility-stack channel per light; K = unshadowed."""
    k_total = len(spot_ids) + len(point_ids)
    idx = np.full(lights.count, k_total, np.int32)
    for k, sid in enumerate(list(spot_ids) + list(point_ids)):
        idx[sid] = k
    return jnp.asarray(idx)


@partial(
    jax.jit,
    static_argnames=("spot_ids", "point_ids", "map_size", "point_size",
                     "pcf_radius", "cap", "use_tiled", "vis_scale",
                     "vis_crop", "filter_mode", "esm_c", "atlas_packed"),
)
def render_local_shadow_maps(
    geom,
    objects,
    lights: LightsSoA,
    spot_ids: tuple,
    point_ids: tuple,
    map_size: int = 1024,
    point_size: int | None = None,
    pcf_radius: int = 1,
    bias_const: float = 2e-3,
    bias_slope: float = 6e-3,
    cap: int = 2048,
    use_tiled: bool = True,
    vis_scale: int = 1,
    vis_crop: tuple = (),
    caster_enabled=None,
    filter_mode: str = "pcf",
    esm_c: float = 80.0,
    atlas_packed: bool = False,
) -> LocalShadowMaps:
    """Render every budgeted local shadow slot and pack the sampling tables.

    The depth-only raster (record_shadow_passes :6912 analog) runs as ONE
    compiled slot program per stack swept over stacked view-projections
    with lax.map.  map_size is the spot/area-proxy resolution
    (local_resolution, shadow_technique.hpp:37); point_size the cube-face
    resolution (point_resolution :38; defaults to map_size).

    caster_enabled: optional (K,) bool (spot-then-point id order) — pass
    the per-frame camera cull result for the shadowed lights (the flagship
    culls its light set every frame, hello_rendering_paths.cpp:94-97).  A
    culled light contributes to no pixel, so its slot raster and its
    visibility-plane gathers are skipped; final images are unchanged.
    """
    if point_size is None:
        point_size = map_size

    (kinds, base_slots, caster_pos, caster_range, strengths,
     spot_vp, point_vp) = plan_slot_stacks(lights, spot_ids, point_ids)

    caster_mask = objects.casts_shadow & objects.visible
    n_spot = spot_vp.shape[0]
    spot_en = point_en = None
    if caster_enabled is not None:
        caster_enabled = jnp.asarray(caster_enabled).astype(bool)
        spot_en = caster_enabled[:n_spot]
        point_en = jnp.repeat(caster_enabled[n_spot:], 6)

    # Per-slot far planes (= the light camera far, _spot_viewproj /
    # _point_face_viewprojs): ESM filters linearized depth.
    slot_fars = jnp.maximum(jnp.stack(caster_range),
                            _SHADOW_NEAR + 0.2) if kinds else None
    spot_taps = None
    if spot_vp.shape[0]:
        spot_taps = _render_slot_stack(
            geom, objects, spot_vp, map_size, caster_mask, use_tiled,
            pcf_radius, slot_enabled=spot_en, filter_mode=filter_mode,
            esm_c=esm_c, slot_far=slot_fars[:n_spot],
            packed=atlas_packed)
    point_taps = None
    if point_vp.shape[0]:
        point_taps = _render_slot_stack(
            geom, objects, point_vp, point_size, caster_mask, use_tiled,
            pcf_radius, slot_enabled=point_en, filter_mode=filter_mode,
            esm_c=esm_c, slot_far=jnp.repeat(slot_fars[n_spot:], 6),
            packed=atlas_packed)

    # Per-light index into the visibility stack: K for "unshadowed".
    idx = shadow_index_for_lights(lights, spot_ids, point_ids)

    return LocalShadowMaps(
        spot_taps=spot_taps,
        point_taps=point_taps,
        spot_viewproj=spot_vp.reshape(-1, 16),
        point_viewproj=point_vp.reshape(-1, 16),
        caster_pos=jnp.stack(caster_pos),
        caster_range=jnp.stack(caster_range),
        light_shadow_index=idx,
        strength=jnp.asarray(strengths, jnp.float32),
        bias_const=jnp.float32(bias_const),
        bias_slope=jnp.float32(bias_slope),
        caster_enabled=caster_enabled,
        spot_size=map_size,
        point_size=point_size,
        pcf_radius=pcf_radius,
        kinds=tuple(kinds),
        base_slots=tuple(base_slots),
        vis_scale=vis_scale,
        vis_crop=_crop_sizes(vis_crop),
        filter_mode=filter_mode,
        esm_c=float(esm_c),
    )


def _project_rows(vp_rows, wp):
    """Project (..., 3) world points by per-pixel (..., 16) row-major VPs."""
    x, y, z = wp[..., 0], wp[..., 1], wp[..., 2]

    def row(c):
        return (vp_rows[..., c] * x + vp_rows[..., c + 1] * y
                + vp_rows[..., c + 2] * z + vp_rows[..., c + 3])

    return row(0), row(4), row(8), row(12)


def _pcf_from_rows(taps, rows, rx, ry, z_test, radius: int):
    """PCF window fetch + static lane mask selecting each pixel's exact
    (2r+1)^2 window.

    rows/rx/ry/z_test: (K, Hs, Ws); returns lit fraction (K, Hs, Ws).
    A gather's row rate falls as its table grows, so callers pass PER-SLOT
    table slices with slot-local rows, not the shared atlas table."""
    win = _TAP_STRIDE + 2 * radius
    window = take_rows(taps, rows)                  # (K, Hs, Ws, win^2)
    lane = jnp.arange(win * win, dtype=jnp.int32)
    li, lj = lane // win, lane % win
    rxl = rx[..., None]
    ryl = ry[..., None]
    m = ((li >= ryl) & (li <= ryl + 2 * radius)
         & (lj >= rxl) & (lj <= rxl + 2 * radius)).astype(jnp.float32)
    from lsr_tpu.lighting.shadow_sample import count_lit

    lit = count_lit(window, z_test, m)
    return lit / float((2 * radius + 1) ** 2)


def _uvz_to_rows(u, v, z01, pw, w_ok, in_reach, size: int, slot_rows):
    """Shared projection→anchor-row math.  slot_rows: (K,...) broadcastable
    first-anchor-row index per plane (slot * n_anchor^2)."""
    in_map = (
        w_ok & in_reach & (pw > 0.0)
        & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
        & (z01 > 0.0) & (z01 < 1.0)
    )
    cx = jnp.clip(jnp.round(u * (size - 1)), 0, size - 1).astype(jnp.int32)
    cy = jnp.clip(jnp.round(v * (size - 1)), 0, size - 1).astype(jnp.int32)
    stride = _TAP_STRIDE
    n_anchor = -(-size // stride)
    ax_i = cx // stride
    ay_i = cy // stride
    rx = cx - ax_i * stride
    ry = cy - ay_i * stride
    rows = slot_rows + ay_i * n_anchor + ax_i
    return rows, rx, ry, in_map


def _linearize01(z01, zn, zf):
    """Perspective NDC01 depth -> linear [0,1] view depth.

    perspective_lh_no gives z01 = zf*(z - zn)/((zf - zn)*z); inverting and
    normalizing, lin01 = zn*z01 / (zf - z01*(zf - zn)).  ESM must filter in
    LINEAR depth: NDC01 compresses the far field so hard that a 2-meter
    occluder-receiver gap shrinks to ~0.006 z01 units (measured in
    tests/test_esm_shadows.py's first failure), inside the exp falloff
    width 4/c — the estimator would light-bleed everywhere.  The sun map is
    orthographic (already linear) and skips this."""
    return zn * z01 / (zf - z01 * (zf - zn))


def _uvz_to_texel(u, v, z01, pw, w_ok, in_reach, size: int):
    """ESM variant of _uvz_to_rows: flat row-major texel index (slot-local)
    at the PCF anchor texel plus the in_map mask."""
    in_map = (
        w_ok & in_reach & (pw > 0.0)
        & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
        & (z01 > 0.0) & (z01 < 1.0)
    )
    cx = jnp.clip(jnp.round(u * (size - 1)), 0, size - 1).astype(jnp.int32)
    cy = jnp.clip(jnp.round(v * (size - 1)), 0, size - 1).astype(jnp.int32)
    return cy * size + cx, in_map


def _esm_vis(tab, idx, in_map, z_test, strength, esm_c):
    """Soft-map fetch + ESM estimator + strength mix (one 1-lane gather
    row per pixel; see shadow_sample.prefilter_esm for the filter math)."""
    from lsr_tpu.lighting.shadow_sample import esm_visibility, fetch_soft

    soft = fetch_soft(tab, jnp.where(in_map, idx, 0))
    lit = esm_visibility(soft, z_test, esm_c)
    vis = 1.0 + (lit - 1.0) * jnp.clip(strength, 0.0, 1.0)
    return jnp.where(in_map, vis, 1.0)


def _bias_ndl(sh, pos, world_pos, normal):
    """(K,H,W) slope-scaled bias + rel vectors for caster positions pos."""
    rel = world_pos[None] - pos[:, None, None, :]          # (K, H, W, 3)
    rel_len = jnp.linalg.norm(rel, axis=-1)
    l_dir = -rel / jnp.maximum(rel_len, 1e-8)[..., None]
    ndl = jnp.maximum(jnp.sum(normal[None] * l_dir, -1), 0.0)
    bias = sh.bias_const + sh.bias_slope * (1.0 - jnp.clip(ndl, 0.0, 1.0))
    return rel, rel_len, bias


def _crop_sizes(vis_crop) -> tuple:
    """Normalize a vis_crop spec to a cascade: () -> (); flat (ch, cw) ->
    ((ch, cw),); a tuple of (ch, cw) pairs passes through (smallest
    first)."""
    if not vis_crop:
        return ()
    if isinstance(vis_crop[0], (tuple, list)):
        return tuple(tuple(int(v) for v in s) for s in vis_crop)
    return (tuple(int(v) for v in vis_crop),)


def _crop_bounds(mask):
    """Footprint bbox of mask (y0, y1, x0, x1) and whether it is non-empty.
    An empty mask "fits" any crop (the plane is all-ones, which is the
    correct result)."""
    h, w = mask.shape
    rows = jnp.any(mask, axis=1)
    cols = jnp.any(mask, axis=0)
    y0 = jnp.argmax(rows).astype(jnp.int32)
    y1 = (h - 1) - jnp.argmax(rows[::-1]).astype(jnp.int32)
    x0 = jnp.argmax(cols).astype(jnp.int32)
    x1 = (w - 1) - jnp.argmax(cols[::-1]).astype(jnp.int32)
    return y0, y1, x0, x1, jnp.any(rows)


def _cropped_plane(eval_fn, mask, world_pos, normal, *sizes, enabled=None):
    """Evaluate a shadow plane on the smallest of the static crop sizes
    that covers the light's pixel footprint this frame (nested lax.cond;
    full-grid fallback when none fits).

    Exact to 1 ULP: mask is the light's in-influence pixel set (or a
    conservative superset); outside it the plane is 1.0 by definition, and
    in-crop pixels run the identical math as the full path (XLA may
    reassociate fused reductions inside the cond branches, hence ULP not
    bit).  Spots cover 2-12%% of screen in the flagship scene, and gather
    cost is per-row — cropping is the difference between 2M and 0.5M
    rows/plane; the cascade recovers the extra 2x for lights whose
    footprint this frame fits a smaller window (a too-small SINGLE window
    is worse than none: every miss pays the full grid).

    An EMPTY footprint short-circuits to the all-ones plane without any
    gather (exact: no pixel is in_map).  `enabled` (scalar bool, optional)
    forces the same short-circuit for camera-culled lights — their plane
    is never consumed (the light is dropped from every bin), so the
    constant plane leaves final images unchanged."""
    h, w = mask.shape
    sizes = [(min(ch, h), min(cw, w)) for ch, cw in sizes]
    # Drop full-size/duplicate levels; keep ascending-area order.
    seen = set()
    lv = []
    for s in sizes:
        if s in seen or (s[0] >= h and s[1] >= w):
            continue
        seen.add(s)
        lv.append(s)
    y0, y1, x0, x1, nonempty = _crop_bounds(mask)
    run = nonempty if enabled is None else (nonempty & enabled)
    if not lv:
        return jax.lax.cond(
            run, lambda _: eval_fn(world_pos, normal),
            lambda _: jnp.ones((h, w), jnp.float32), 0)

    def level(i):
        if i == len(lv):
            return lambda _: eval_fn(world_pos, normal)
        ch, cw = lv[i]
        fits = (y1 - y0 + 1 <= ch) & (x1 - x0 + 1 <= cw)
        y0c = jnp.clip(y0, 0, max(h - ch, 0))
        x0c = jnp.clip(x0, 0, max(w - cw, 0))

        def crop_branch(_):
            wpc = jax.lax.dynamic_slice(world_pos, (y0c, x0c, 0),
                                        (ch, cw, 3))
            nmc = jax.lax.dynamic_slice(normal, (y0c, x0c, 0), (ch, cw, 3))
            return jax.lax.dynamic_update_slice(
                jnp.ones((h, w), jnp.float32), eval_fn(wpc, nmc),
                (y0c, x0c))

        return lambda _: jax.lax.cond(fits, crop_branch, level(i + 1), 0)

    return jax.lax.cond(
        run, level(0), lambda _: jnp.ones((h, w), jnp.float32), 0)


def _spot_in_map(sh: LocalShadowMaps, k: int, world_pos):
    """The exact in_map mask of spot plane k (no gathers): pixels whose
    projection lands inside the light frustum."""
    base = int(sh.base_slots[k])
    vp = sh.spot_viewproj[base]
    px, py, pz, pw = _project_rows(vp[None, None, :], world_pos)
    w_ok = jnp.abs(pw) >= 1e-8
    w_safe = jnp.where(w_ok, pw, 1.0)
    u = (px / w_safe) * 0.5 + 0.5
    v = (py / w_safe) * 0.5 + 0.5
    z01 = (pz / w_safe) * 0.5 + 0.5
    return (w_ok & (pw > 0.0)
            & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
            & (z01 > 0.0) & (z01 < 1.0))


def _spot_plane_one(sh: LocalShadowMaps, k: int, world_pos, normal):
    """One SPOT_2D visibility plane on an arbitrary (H', W') pixel grid."""
    base = int(sh.base_slots[k])
    pos = sh.caster_pos[k][None]                           # (1, 3)
    vp = sh.spot_viewproj[base]
    rel, rel_len, bias = _bias_ndl(sh, pos, world_pos, normal)

    px, py, pz, pw = _project_rows(vp[None, None, :], world_pos)
    w_ok = jnp.abs(pw) >= 1e-8
    w_safe = jnp.where(w_ok, pw, 1.0)
    u = (px / w_safe) * 0.5 + 0.5
    v = (py / w_safe) * 0.5 + 0.5
    z01 = (pz / w_safe) * 0.5 + 0.5
    s = sh.spot_size
    in_reach = jnp.ones(pw.shape, bool)
    from lsr_tpu.lighting.shadow_sample import TAPS_BARRIER

    if sh.filter_mode == "esm":
        # Per-slot soft-table slice (S*S/2 packed rows per slot), one
        # 1-lane fetch per pixel at the anchor texel.
        half = (s * s) // 2
        tab = jax.lax.dynamic_slice_in_dim(sh.spot_taps, base * half,
                                           half, 0)
        if TAPS_BARRIER:
            tab = jax.lax.optimization_barrier(tab)
        idx, in_map = _uvz_to_texel(u, v, z01, pw, w_ok, in_reach, s)
        far = jnp.maximum(sh.caster_range[k], _SHADOW_NEAR + 0.2)
        z_lin = _linearize01(z01, jnp.float32(_SHADOW_NEAR), far)
        return _esm_vis(tab, idx, in_map, z_lin - bias[0],
                        sh.strength[k], sh.esm_c)
    n_anchor = -(-s // _TAP_STRIDE)
    na2 = n_anchor * n_anchor
    # SLOT-LOCAL rows + a per-slot table slice: the gather row rate is
    # table-size-bound (see _pcf_from_rows), and clamping out-of-cone
    # pixels to local row 0 keeps the working set inside the slot.
    rows, rx, ry, in_map = _uvz_to_rows(
        u, v, z01, pw, w_ok, in_reach, s, jnp.int32(0))
    rows = jnp.where(in_map, rows, 0)
    tab = jax.lax.dynamic_slice_in_dim(sh.spot_taps, base * na2, na2, 0)
    if TAPS_BARRIER:
        # Materialize the slot's table slice contiguously: the gather row
        # rate is TABLE-size-bound, and a slice fused into the gather
        # reads the whole stack (the sun path applies the same barrier in
        # make_shadow_context).
        tab = jax.lax.optimization_barrier(tab)
    lit = _pcf_from_rows(tab, rows, rx, ry, z01 - bias[0], sh.pcf_radius)
    strength = jnp.clip(sh.strength[k], 0.0, 1.0)
    vis = 1.0 + (lit - 1.0) * strength
    return jnp.where(in_map, vis, 1.0)


def _spot_planes(sh: LocalShadowMaps, ks, world_pos, normal,
                 crop_sizes=None):
    """All SPOT_2D planes: (len(ks), H, W).

    With sh.vis_crop set, each plane evaluates on a static-size crop around
    the light's exact screen footprint (gather rows are the cost; spots
    cover a small screen fraction) — bit-identical to the full-grid path.
    crop_sizes overrides the cascade (already normalized, e.g. scaled to a
    vis_scale-strided grid by _vis_planes_list)."""
    if crop_sizes is None:
        crop_sizes = _crop_sizes(sh.vis_crop)
    planes = []
    for k in ks:
        fn = lambda wp, nm, k=k: _spot_plane_one(sh, k, wp, nm)
        en = (None if sh.caster_enabled is None
              else sh.caster_enabled[k])
        if crop_sizes:
            mask = _spot_in_map(sh, k, world_pos)
            planes.append(_cropped_plane(fn, mask, world_pos, normal,
                                         *crop_sizes,
                                         enabled=en))
        elif en is not None:
            planes.append(jax.lax.cond(
                en, lambda _, fn=fn: fn(world_pos, normal),
                lambda _: jnp.ones(world_pos.shape[:-1], jnp.float32), 0))
        else:
            planes.append(fn(world_pos, normal))
    return jnp.stack(planes)


def _point_in_reach(sh: LocalShadowMaps, k: int, world_pos):
    """Conservative influence mask of point light k: inside its range
    sphere (no gathers)."""
    rel = world_pos - sh.caster_pos[k]
    rel_len = jnp.linalg.norm(rel, axis=-1)
    return (rel_len > 1e-4) & (rel_len < sh.caster_range[k])


def _point_plane_one(sh: LocalShadowMaps, k: int, world_pos, normal):
    """One POINT_CUBE visibility plane on an arbitrary (H', W') grid.

    Face = major axis of rel (point_shadow_face_uv :302 semantics); the
    face slot's own VP is fetched with a one-hot (6-wide) contraction
    instead of a per-pixel row gather — so the sample stays
    consistent with however the raster mapped NDC to texels."""
    base = int(sh.base_slots[k])
    pos = sh.caster_pos[k][None]
    rng = sh.caster_range[k]
    rel, rel_len, bias = _bias_ndl(sh, pos, world_pos, normal)
    rel, rel_len, bias = rel[0], rel_len[0], bias[0]       # (H, W, ...)

    ax, ay, az = (jnp.abs(rel[..., 0]), jnp.abs(rel[..., 1]),
                  jnp.abs(rel[..., 2]))
    face_x = jnp.where(rel[..., 0] >= 0, 0, 1)
    face_y = jnp.where(rel[..., 1] >= 0, 2, 3)
    face_z = jnp.where(rel[..., 2] >= 0, 4, 5)
    face = jnp.where(
        (ax >= ay) & (ax >= az), face_x,
        jnp.where(ay >= az, face_y, face_z),
    )                                                      # (H, W)
    # Per-pixel VP via one-hot contraction over this light's 6 face VPs.
    vps = jax.lax.dynamic_slice_in_dim(sh.point_viewproj, base, 6, 0)
    onehot = (face[..., None]
              == jnp.arange(6, dtype=jnp.int32)).astype(jnp.float32)
    vp_rows = jnp.einsum("hwf,fc->hwc", onehot, vps, precision=jax.lax.Precision.HIGHEST)

    px, py, pz, pw = _project_rows(vp_rows, world_pos)
    w_ok = jnp.abs(pw) >= 1e-8
    w_safe = jnp.where(w_ok, pw, 1.0)
    u = (px / w_safe) * 0.5 + 0.5
    v = (py / w_safe) * 0.5 + 0.5
    z01 = (pz / w_safe) * 0.5 + 0.5
    s = sh.point_size
    in_reach = (rel_len > 1e-4) & (rel_len < rng)
    from lsr_tpu.lighting.shadow_sample import TAPS_BARRIER

    if sh.filter_mode == "esm":
        # Light-local soft slice (6 faces x S*S/2 packed rows); the face
        # index offsets into the slice, one 1-lane fetch per pixel.
        half = (s * s) // 2
        tab = jax.lax.dynamic_slice_in_dim(sh.point_taps, base * half,
                                           6 * half, 0)
        if TAPS_BARRIER:
            tab = jax.lax.optimization_barrier(tab)
        idx, in_map = _uvz_to_texel(u, v, z01, pw, w_ok, in_reach, s)
        idx = face * (s * s) + idx
        far = jnp.maximum(rng, _SHADOW_NEAR + 0.2)
        z_lin = _linearize01(z01, jnp.float32(_SHADOW_NEAR), far)
        return _esm_vis(tab, idx, in_map, z_lin - bias,
                        sh.strength[k], sh.esm_c)
    n_anchor = -(-s // _TAP_STRIDE)
    na2 = n_anchor * n_anchor
    # LIGHT-LOCAL rows (face picks the sub-slot) + this light's 6-face
    # table slice: keeps the gather's working set small (_pcf_from_rows).
    rows, rx, ry, in_map = _uvz_to_rows(u, v, z01, pw, w_ok, in_reach, s,
                                        face * na2)
    rows = jnp.where(in_map, rows, 0)
    tab = jax.lax.dynamic_slice_in_dim(sh.point_taps, base * na2, 6 * na2, 0)
    if TAPS_BARRIER:
        # See _spot_plane_one: keep the gather's table the 6-face slice,
        # not a fused view of the whole point stack.
        tab = jax.lax.optimization_barrier(tab)
    lit = _pcf_from_rows(tab, rows, rx, ry, z01 - bias, sh.pcf_radius)
    strength = jnp.clip(sh.strength[k], 0.0, 1.0)
    vis = 1.0 + (lit - 1.0) * strength
    return jnp.where(in_map, vis, 1.0)


def _point_planes(sh: LocalShadowMaps, ks, world_pos, normal,
                  crop_sizes=None):
    """All POINT_CUBE planes: (len(ks), H, W); vis_crop as in
    _spot_planes (the range sphere bounds the footprint; the flagship
    orbit's point footprints are smaller than its spots', so one shared
    window covers both kinds)."""
    if crop_sizes is None:
        crop_sizes = _crop_sizes(sh.vis_crop)
    planes = []
    for k in ks:
        fn = lambda wp, nm, k=k: _point_plane_one(sh, k, wp, nm)
        en = (None if sh.caster_enabled is None
              else sh.caster_enabled[k])
        if crop_sizes:
            mask = _point_in_reach(sh, k, world_pos)
            planes.append(_cropped_plane(fn, mask, world_pos, normal,
                                         *crop_sizes,
                                         enabled=en))
        elif en is not None:
            planes.append(jax.lax.cond(
                en, lambda _, fn=fn: fn(world_pos, normal),
                lambda _: jnp.ones(world_pos.shape[:-1], jnp.float32), 0))
        else:
            planes.append(fn(world_pos, normal))
    return jnp.stack(planes)


def local_shadow_vis_stack(sh: LocalShadowMaps, world_pos, normal):
    """Per-pixel visibility for each shadowed light: (H, W, K+1).

    Channel k < K mirrors eval_local_shadow (fp_stress_scene.frag:355):
    project into the light frustum (cube lights select the face per pixel
    first), PCF-compare biased NDC01 depth, then mix(1, vis, strength).
    Channel K is constant 1.0 so unshadowed lights can index it.

    All planes of a stack evaluate through ONE batched gather (per-plane
    gathers cost K table scans and K dispatches for the same row count).

    When sh.vis_scale > 1, planes are evaluated on a vis_scale-strided
    pixel grid and bilinearly upsampled (perf knob; PARITY.md).
    """
    planes = _vis_planes_list(sh, world_pos, normal)
    stack = jnp.stack(planes, axis=-1)
    sc = max(1, int(sh.vis_scale))
    if sc > 1:
        stack = jax.image.resize(
            stack, world_pos.shape[:-1] + (stack.shape[-1],), "bilinear")
    return stack


def _scaled_crop_sizes(vis_crop, sc: int) -> tuple:
    """Crop cascade re-denominated for a vis_scale-strided grid.

    vis_crop levels are sized in FULL-res pixels (default_vis_crop takes
    the framebuffer dims); the planes evaluate on the (H/sc, W/sc) grid, so
    unscaled levels cover sc^2 x the intended footprint area — at sc=2 the
    whole 4-level cascade collapses to one near-full-grid window.  Each
    level shrinks by sc, re-rounded to whole blocks (8 rows, 128 columns).
    Exact either way: _cropped_plane fit-checks against the actual
    footprint on the eval grid and falls through to the next level."""
    sizes = _crop_sizes(vis_crop)
    if sc <= 1 or not sizes:
        return sizes
    def up(v, m):  # ceil(v / sc) rounded up to a multiple of m
        q = -(-v // sc)
        return -(-q // m) * m

    out, seen = [], set()
    for ch, cw in sizes:
        lv = (up(ch, 8), up(cw, 128))
        if lv not in seen:
            seen.add(lv)
            out.append(lv)
    return tuple(out)


def _vis_planes_list(sh: LocalShadowMaps, world_pos, normal):
    """Shared body of the vis-stack builders: K+1 (H', W') planes at the
    vis_scale-strided grid resolution."""
    sc = max(1, int(sh.vis_scale))
    wp, nm = world_pos, normal
    if sc > 1:
        wp = world_pos[::sc, ::sc]
        nm = normal[::sc, ::sc]
    crops = _scaled_crop_sizes(sh.vis_crop, sc)

    spot_ks = [k for k in range(sh.n_shadowed)
               if sh.kinds[k] != SHADOW_POINT_CUBE]
    point_ks = [k for k in range(sh.n_shadowed)
                if sh.kinds[k] == SHADOW_POINT_CUBE]
    parts = {}
    if spot_ks:
        sp = _spot_planes(sh, spot_ks, wp, nm, crop_sizes=crops)
        for i, k in enumerate(spot_ks):
            parts[k] = sp[i]
    if point_ks:
        pp = _point_planes(sh, point_ks, wp, nm, crop_sizes=crops)
        for i, k in enumerate(point_ks):
            parts[k] = pp[i]
    planes = [parts[k] for k in range(sh.n_shadowed)]
    planes.append(jnp.ones(wp.shape[:-1], jnp.float32))
    return planes
