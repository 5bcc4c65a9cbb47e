"""Local-light evaluation + tiled/clustered multi-light shading passes.

Mirrors lighting/light_runtime.hpp:95-632 (ILightModel family) as one
vectorized, type-branchless evaluator:

- Point:   shaping 1,                     spec (36.0, 0.30)
- Spot:    smoothstep cone shaping,       spec (34.0, 0.32)
- Rect:    representative-point + facing, spec (26.0, 0.26)
- Tube:    closest-point-on-segment,      spec (22.0, 0.20)

Distance attenuation (eval_distance_attenuation, light_runtime.hpp:180-213):
Linear / Smooth(smoothstep) / InverseSquare, with power & cutoff shaping.

The Forward+ shading pass accumulates binned lights per screen tile in
fixed-size chunks (a lax.scan over the padded per-tile lists), which keeps
every shape static while only paying for the tile cap, not the light count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsr_tpu.lighting.light_types import (
    LIGHT_POINT,
    LIGHT_RECT_AREA,
    LIGHT_SPOT,
    LIGHT_TUBE_AREA,
    LightsSoA,
)

_HALF_PI = 1.5707963267948966


def _norm(v, eps=1e-8):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


def eval_distance_attenuation(dist, rng, model, power, bias, cutoff):
    """Vectorized port of eval_distance_attenuation (light_runtime.hpp:180)."""
    rng = jnp.maximum(rng, 0.001)
    norm = jnp.clip(1.0 - dist / rng, 0.0, 1.0)
    lin = norm
    smooth = norm * norm * (3.0 - 2.0 * norm)
    inv = jnp.minimum(1.0, (rng * rng) / jnp.maximum(dist * dist, bias)) * norm * norm
    falloff = jnp.where(model == 0, lin, jnp.where(model == 1, smooth, inv))
    falloff = jnp.power(jnp.maximum(falloff, 0.0), jnp.maximum(power, 0.001))
    falloff = jnp.where((cutoff > 0.0) & (falloff < cutoff), 0.0, falloff)
    in_range = dist < rng
    return jnp.where(in_range, jnp.maximum(falloff, 0.0), 0.0)


def eval_local_lights(lights_g, world_pos, normal, view_dir):
    """Evaluate gathered lights against shaded points.

    lights_g: dict of light columns gathered to shape (..., K, C)
    world_pos/normal/view_dir: (..., 3) broadcast against K.
    Returns (diffuse (..., K, 3), specular (..., K, 3)).
    """
    p = world_pos[..., None, :]
    n = normal[..., None, :]
    v = view_dir[..., None, :]

    ltype = lights_g["type"]
    pos = lights_g["position"]
    fwd = _norm(lights_g["direction"])
    axis = _norm(lights_g["axis"])

    # --- emission point per type ------------------------------------------
    # Rect: clamp surface offset into the rect plane basis.
    up_hint = _norm(lights_g["up"])
    right = jnp.cross(up_hint, fwd)
    right = _norm(right)
    up = _norm(jnp.cross(fwd, right))
    right = _norm(jnp.cross(up, fwd))
    dvec = p - pos
    he = jnp.maximum(lights_g["rect_half_extents"], 0.05)
    ux = jnp.clip(jnp.sum(dvec * right, -1, keepdims=True), -he[..., :1], he[..., :1])
    uy = jnp.clip(jnp.sum(dvec * up, -1, keepdims=True), -he[..., 1:2], he[..., 1:2])
    rect_pt = pos + right * ux + up * uy

    # Tube: closest point on the axis segment.
    half_len = jnp.maximum(lights_g["tube_half_length"], 0.1)[..., None]
    a = pos - axis * half_len
    ab = axis * (2.0 * half_len)
    denom = jnp.maximum(jnp.sum(ab * ab, -1, keepdims=True), 1e-8)
    t = jnp.clip(jnp.sum((p - a) * ab, -1, keepdims=True) / denom, 0.0, 1.0)
    tube_pt = a + ab * t

    is_rect = (ltype == LIGHT_RECT_AREA)[..., None]
    is_tube = (ltype == LIGHT_TUBE_AREA)[..., None]
    emit = jnp.where(is_rect, rect_pt, jnp.where(is_tube, tube_pt, pos))

    to_light = emit - p
    dist = jnp.linalg.norm(to_light, axis=-1)
    l_dir = to_light / jnp.maximum(dist, 1e-8)[..., None]

    # --- per-type shaping ---------------------------------------------------
    # Spot cone smoothstep (light_runtime.hpp:390-402).
    inner = jnp.clip(lights_g["inner_angle"], 0.02, _HALF_PI - 0.02)
    outer = jnp.clip(jnp.maximum(inner + 0.005, lights_g["outer_angle"]),
                     inner + 0.005, _HALF_PI - 0.005)
    cos_inner = jnp.cos(inner)
    cos_outer = jnp.cos(outer)
    cos_theta = jnp.sum(-l_dir * fwd, axis=-1)
    tt = jnp.clip((cos_theta - cos_outer) / jnp.maximum(cos_inner - cos_outer, 1e-5),
                  0.0, 1.0)
    spot_shape = jnp.where(cos_theta > cos_outer, tt * tt * (3.0 - 2.0 * tt), 0.0)

    # Rect emission facing gain (light_runtime.hpp:465-472).
    facing = jnp.maximum(jnp.sum(fwd * (-l_dir), axis=-1), 0.0)
    rect_shape = jnp.where(facing > 0.0, 0.65 + 0.55 * facing, 0.0)

    # Tube radial softening (light_runtime.hpp:528-534).
    soft = jnp.clip(1.0 - dist / jnp.maximum(lights_g["range"], 0.1), 0.0, 1.0)
    tube_shape = 0.75 + 0.35 * soft

    shaping = jnp.where(
        ltype == LIGHT_SPOT, spot_shape,
        jnp.where(ltype == LIGHT_RECT_AREA, rect_shape,
                  jnp.where(ltype == LIGHT_TUBE_AREA, tube_shape, 1.0)),
    )
    spec_power = jnp.where(
        ltype == LIGHT_SPOT, 34.0,
        jnp.where(ltype == LIGHT_RECT_AREA, 26.0,
                  jnp.where(ltype == LIGHT_TUBE_AREA, 22.0, 36.0)),
    )
    spec_scale = jnp.where(
        ltype == LIGHT_SPOT, 0.32,
        jnp.where(ltype == LIGHT_RECT_AREA, 0.26,
                  jnp.where(ltype == LIGHT_TUBE_AREA, 0.20, 0.30)),
    )

    # --- BRDF (eval_local_light_brdf, light_runtime.hpp:212-246) ------------
    ndl = jnp.maximum(jnp.sum(n * l_dir, axis=-1), 0.0)
    atten = eval_distance_attenuation(
        dist, lights_g["range"], lights_g["atten_model"],
        lights_g["atten_power"], lights_g["atten_bias"], lights_g["atten_cutoff"],
    ) * jnp.maximum(shaping, 0.0)
    live = (dist > 1e-4) & (ndl > 0.0) & (atten > 0.0)

    radiance = (
        jnp.maximum(lights_g["color"], 0.0)
        * jnp.maximum(lights_g["intensity"], 0.0)[..., None]
        * atten[..., None]
    )
    h = _norm(l_dir + v)
    ndh = jnp.maximum(jnp.sum(n * h, axis=-1), 0.0)
    spec = spec_scale * jnp.power(ndh, spec_power)

    live_f = live[..., None].astype(radiance.dtype)
    diffuse = radiance * ndl[..., None] * live_f
    specular = radiance * spec[..., None] * live_f
    return diffuse, specular


def pack_light_records(lights: LightsSoA):
    """Pack the light SoA into ONE (L, 32) f32 record for fast row gathers.

    Layout: [0] type | [1:4] pos | [4:7] dir | [7:10] up | [10:13] axis |
    [13:16] color | [16] intensity | [17] range | [18] inner | [19] outer |
    [20:22] rect_he | [22] tube_hl | [23] tube_r | [24] atten_model |
    [25] atten_power | [26] atten_bias | [27] atten_cutoff | [28:32] pad.
    """
    l = lights.type.shape[0]  # noqa: E741
    cols = [
        lights.type.astype(jnp.float32)[:, None],
        lights.position, lights.direction, lights.up, lights.axis,
        lights.color,
        lights.intensity[:, None], lights.range[:, None],
        lights.inner_angle[:, None], lights.outer_angle[:, None],
        lights.rect_half_extents,
        lights.tube_half_length[:, None], lights.tube_radius[:, None],
        lights.atten_model.astype(jnp.float32)[:, None],
        lights.atten_power[:, None], lights.atten_bias[:, None],
        lights.atten_cutoff[:, None],
        jnp.zeros((l, 4), jnp.float32),
    ]
    return jnp.concatenate(cols, axis=-1)


def unpack_light_records(rec, live_mask=None):
    """(…, 32) packed records -> the column dict eval_local_lights expects."""
    intensity = rec[..., 16]
    if live_mask is not None:
        intensity = jnp.where(live_mask, intensity, 0.0)
    return {
        "type": rec[..., 0].astype(jnp.int32),
        "position": rec[..., 1:4],
        "direction": rec[..., 4:7],
        "up": rec[..., 7:10],
        "axis": rec[..., 10:13],
        "color": rec[..., 13:16],
        "intensity": intensity,
        "range": rec[..., 17],
        "inner_angle": rec[..., 18],
        "outer_angle": rec[..., 19],
        "rect_half_extents": rec[..., 20:22],
        "tube_half_length": rec[..., 22],
        "tube_radius": rec[..., 23],
        "atten_model": rec[..., 24].astype(jnp.int32),
        "atten_power": rec[..., 25],
        "atten_bias": rec[..., 26],
        "atten_cutoff": rec[..., 27],
    }


def _gather_light_columns(lights: LightsSoA, idx):
    """Gather light SoA columns by padded index array (…)->(…, C)."""
    safe = jnp.maximum(idx, 0)
    cols = {}
    for name in ("type", "position", "direction", "up", "axis", "color",
                 "intensity", "range", "inner_angle", "outer_angle",
                 "rect_half_extents", "tube_half_length", "tube_radius",
                 "atten_model", "atten_power", "atten_bias", "atten_cutoff"):
        from lsr_tpu.core.gather import take_rows

        cols[name] = take_rows(getattr(lights, name), safe)
    # Disable padded slots by zeroing intensity.
    cols["intensity"] = jnp.where(idx >= 0, cols["intensity"], 0.0)
    return cols


def _to_tiles(x, tile_size, tiles_y, tiles_x):
    """(H, W, C) -> (tiles, ts*ts, C) with far-pad."""
    h, w = x.shape[0], x.shape[1]
    ph, pw = tiles_y * tile_size, tiles_x * tile_size
    pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (x.ndim - 2)
    xp = jnp.pad(x, pad)
    xp = xp.reshape((tiles_y, tile_size, tiles_x, tile_size) + x.shape[2:])
    xp = jnp.swapaxes(xp, 1, 2)
    return xp.reshape((tiles_y * tiles_x, tile_size * tile_size) + x.shape[2:])


def _from_tiles(x, tile_size, tiles_y, tiles_x, h, w):
    c = x.shape[2:]
    xp = x.reshape((tiles_y, tiles_x, tile_size, tile_size) + c)
    xp = jnp.swapaxes(xp, 1, 2)
    xp = xp.reshape((tiles_y * tile_size, tiles_x * tile_size) + c)
    return xp[:h, :w]


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile_size", "chunk", "slices"),
)
def accumulate_local_lights(
    gb_world_pos, gb_normal, camera_pos,
    lights: LightsSoA, tile_lists, width: int, height: int,
    tile_size: int = 16, chunk: int = 8,
    cluster_of_pixel=None, slices: int = 1,
    shadow_vis_stack=None, light_shadow_index=None,
):
    """Accumulate binned local lights over the framebuffer.

    tile_lists: (tiles[*slices], cap) i32 light indices (-1 padded).
    cluster_of_pixel: optional (H, W) i32 cluster slice index per pixel
    (clustered mode); None = pure tiled.
    shadow_vis_stack: optional (H, W, K+1) per-shadowed-light visibility
    planes (lighting/local_shadows.py; channel K is the constant 1.0
    plane); light_shadow_index: (L,) i32 channel per light.  Applied as a
    one-hot (K+1)-wide matmul per binned light — the eval_local_shadow
    multiply of fp_stress_scene.frag:520-521.
    Returns (diffuse (H,W,3), specular (H,W,3)).
    """
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    px = tile_size * tile_size

    wp_t = _to_tiles(gb_world_pos, tile_size, tiles_y, tiles_x)   # (T, px, 3)
    n_t = _to_tiles(gb_normal, tile_size, tiles_y, tiles_x)
    v_t = _norm(camera_pos[None, None, :] - wp_t)

    vis_t = None
    if shadow_vis_stack is not None:
        vis_t = _to_tiles(shadow_vis_stack, tile_size, tiles_y, tiles_x)
        # Padded framebuffer rows tile to all-zero channels; route them to
        # the constant plane by rebuilding channel K+0..: zeros are harmless
        # because padded pixels are cropped by _from_tiles anyway.

    if cluster_of_pixel is not None:
        cl_t = _to_tiles(cluster_of_pixel[..., None], tile_size, tiles_y, tiles_x)
        cl_t = cl_t[..., 0]  # (T, px) slice index per pixel
        tile_base = jnp.arange(tiles_y * tiles_x, dtype=jnp.int32)[:, None] * slices
        list_idx = tile_base + cl_t  # (T, px) row into tile_lists per pixel
    else:
        list_idx = None

    cap = tile_lists.shape[1]
    n_chunks = -(-cap // chunk)
    pad = n_chunks * chunk - cap
    lists_p = jnp.pad(tile_lists, ((0, 0), (0, pad)), constant_values=-1)

    if list_idx is None:
        # Pre-gather ALL per-tile light records in ONE wide row gather
        # (gathers pay a per-row overhead; see raster/interp.py).
        packed = pack_light_records(lights)
        from lsr_tpu.core.gather import take_rows
        tile_rec = take_rows(packed, jnp.maximum(lists_p, 0))  # (T, capP, 32)
        tile_rec = jnp.where((lists_p >= 0)[..., None], tile_rec, 0.0)
    else:
        packed_cl = pack_light_records(lights)

    def body(carry, ck):
        diff, spec = carry
        if list_idx is None:
            rec = jax.lax.dynamic_slice_in_dim(tile_rec, ck * chunk, chunk, axis=1)
            live = rec[..., 17] > 0.0  # padded slots have zero range
            cols = unpack_light_records(rec, live)
            # (T, 1, chunk, C) broadcasts against points (T, px, 1, 3).
            cols = {k: v[:, None] for k, v in cols.items()}
            d, s = eval_local_lights(cols, wp_t, n_t, v_t)
            if vis_t is not None:
                ids = jax.lax.dynamic_slice_in_dim(
                    lists_p, ck * chunk, chunk, axis=1)       # (T, chunk)
                sidx = take_rows(light_shadow_index, jnp.maximum(ids, 0))
                kp1 = vis_t.shape[-1]
                onehot = (sidx[..., None]
                          == jnp.arange(kp1)[None, None, :]).astype(
                              jnp.float32)                    # (T, chunk, K+1)
                vis = jnp.einsum("tpk,tck->tpc", vis_t, onehot,
                                 precision=jax.lax.Precision.HIGHEST)
                d = d * vis[..., None]
                s = s * vis[..., None]
        else:
            rows = jax.lax.dynamic_slice_in_dim(lists_p, ck * chunk, chunk, axis=1)
            idx = rows[list_idx]  # (T, px, chunk)
            # ONE wide packed-record gather per chunk instead of 17 column
            # gathers (each gather op pays its own overhead).
            from lsr_tpu.core.gather import take_rows as _tr

            rec = _tr(packed_cl, jnp.maximum(idx, 0))      # (T, px, chunk, 32)
            cols = unpack_light_records(rec, idx >= 0)
            d, s = eval_local_lights(cols, wp_t, n_t, v_t)
            if vis_t is not None:
                sidx = take_rows(light_shadow_index, jnp.maximum(idx, 0))
                kp1 = vis_t.shape[-1]
                onehot = (sidx[..., None]
                          == jnp.arange(kp1)[None, None, None, :]).astype(
                              jnp.float32)                # (T, px, chunk, K+1)
                vis = jnp.sum(vis_t[:, :, None, :] * onehot, -1)
                d = d * vis[..., None]
                s = s * vis[..., None]
        return (diff + d.sum(-2), spec + s.sum(-2)), None

    zero = jnp.zeros((tiles_y * tiles_x, px, 3), jnp.float32)
    (diff, spec), _ = jax.lax.scan(
        body, (zero, zero), jnp.arange(n_chunks)
    )
    diffuse = _from_tiles(diff, tile_size, tiles_y, tiles_x, height, width)
    specular = _from_tiles(spec, tile_size, tiles_y, tiles_x, height, width)
    return diffuse, specular


def combine_local_light(albedo, diffuse, specular):
    """Material combine used by the forward demos: albedo-modulated diffuse
    plus white specular."""
    return albedo * diffuse + specular


def eval_env_probes(lights: LightsSoA, world_pos, ambient,
                    max_probes: int = 8):
    """Localized-IBL environment probes (LIGHT_ENV_PROBE rows).

    The reference enumerates EnvironmentProbe as a light type
    (light_types.hpp:31, named at :74) but never evaluates it in any
    shader; this is our completion of that surface: a probe is a sphere of
    influence (position, range) inside which the frame's IBL/fake-IBL
    ambient term is re-emitted scaled by the probe's color * intensity with
    a smoothstep falloff — localized image-based ambience.

    ambient: the (H, W, 3) ambient term already computed from the context's
    IBL maps.  Returns the ADDITIVE probe contribution (H, W, 3); up to
    `max_probes` enabled probe rows are honored (static bound).
    """
    from lsr_tpu.lighting.light_types import LIGHT_ENV_PROBE

    is_probe = (lights.type == LIGHT_ENV_PROBE) & lights.enabled
    order = jnp.argsort(jnp.where(is_probe, 0, 1),
                        stable=True)[:max_probes]           # probe rows first
    pos = lights.position[order]                            # (K, 3)
    rng = jnp.maximum(lights.range[order], 1e-3)
    gain = (jnp.maximum(lights.color[order], 0.0)
            * jnp.maximum(lights.intensity[order], 0.0)[:, None])
    valid = is_probe[order].astype(jnp.float32)             # (K,)

    d = jnp.linalg.norm(
        world_pos[..., None, :] - pos[None, None, :, :], axis=-1)  # (H,W,K)
    t = jnp.clip(1.0 - d / rng[None, None, :], 0.0, 1.0)
    w = t * t * (3.0 - 2.0 * t) * valid[None, None, :]
    mod = jnp.einsum("hwk,kc->hwc", w, gain)
    return ambient * mod


# ---------------------------------------------------------------------------
# Per-object light selection + light motion (light_runtime.hpp:537-632)
# ---------------------------------------------------------------------------

def collect_object_lights(lights: LightsSoA, obj_centers, obj_radii,
                          cap: int = 8):
    """Per-object candidate light lists (collect_object_lights /
    LightSelection, light_runtime.hpp:258-289, :592): for each object keep
    the `cap` nearest lights whose bounding spheres touch the object's
    bounding sphere.  Returns (indices (O, cap) i32 -1-padded, counts (O,)).
    """
    from lsr_tpu.lighting.light_types import light_bounding_spheres

    centers, radii = light_bounding_spheres(lights)
    d = obj_centers[:, None, :] - centers[None, :, :]
    dist2 = jnp.sum(d * d, axis=-1)                       # (O, L)
    reach = (radii[None, :] + obj_radii[:, None])
    touching = dist2 <= reach * reach
    local = (lights.type != 0) & (lights.type != 5) & lights.enabled
    mask = touching & local[None, :]

    # Keep the `cap` nearest: sort keys put non-candidates at +inf.
    key = jnp.where(mask, dist2, jnp.inf)
    order = jnp.argsort(key, axis=1)[:, :cap]             # (O, cap)
    picked = jnp.take_along_axis(mask, order, axis=1)
    idx = jnp.where(picked, order.astype(jnp.int32), -1)
    counts = picked.sum(axis=1, dtype=jnp.int32)
    return idx, counts


def animate_lights(lights: LightsSoA, time_s, orbit_radius=0.0,
                   orbit_speed=1.0, orbit_axis=(0.0, 1.0, 0.0),
                   pulse_amount=0.0, pulse_speed=2.0, phase=None):
    """Light motion profiles (update_light_motion, light_runtime.hpp:537-590):
    orbit positions around their anchors + intensity pulsing, vectorized over
    the whole set.  `phase`: optional (L,) per-light phase offsets."""
    import dataclasses as _dc

    l = lights.count  # noqa: E741
    if phase is None:
        phase = jnp.arange(l, dtype=jnp.float32) * 0.618  # golden spread
    t = jnp.asarray(time_s, jnp.float32)

    axis = jnp.asarray(orbit_axis, jnp.float32)
    axis = axis / jnp.maximum(jnp.linalg.norm(axis), 1e-8)
    # Orbit in the plane orthogonal to the axis.
    ref = jnp.where(jnp.abs(axis[1]) > 0.9,
                    jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
                    jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    u = jnp.cross(axis, ref)
    u = u / jnp.maximum(jnp.linalg.norm(u), 1e-8)
    v = jnp.cross(axis, u)
    ang = t * orbit_speed + phase
    offset = (
        u[None, :] * jnp.cos(ang)[:, None] + v[None, :] * jnp.sin(ang)[:, None]
    ) * orbit_radius
    pulse = 1.0 + pulse_amount * jnp.sin(t * pulse_speed + phase)
    return _dc.replace(
        lights,
        position=lights.position + offset,
        intensity=lights.intensity * pulse,
    )
