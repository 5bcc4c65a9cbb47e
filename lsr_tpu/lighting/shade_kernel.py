"""Local-light shading kernel: binned local lights in ONE Pallas pass
(Triton route).

One program shades one light-binning tile (tile_size x tile_size pixels):
it reads the G-buffer block in its natural (H, W, C) layout, walks its own
light list, loading each light's packed record by index, and accumulates
albedo-modulated diffuse plus specular in registers.  The sun, ambient and
emissive terms stay in XLA (passes/forward_plus.py): they are per-pixel
elementwise work that XLA fuses, and sharing them keeps this path equal to
the plain one up to the order of the light sum.

The light lists are the XLA path's own (cull_lights_tiled /
cull_lights_clustered at the same tile size and cap), so both paths shade
every pixel with the same lights.

Per-pixel inputs: world_pos (H,W,3) | normal (H,W,3) | albedo (H,W,3) |
covered (H,W) f32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from lsr_tpu.core.device import kernel_interpret
from lsr_tpu.core.util import cdiv
from lsr_tpu.lighting.light_culling import cull_lights_tiled
from lsr_tpu.lighting.light_runtime import pack_light_records
from lsr_tpu.lighting.light_types import (
    LIGHT_RECT_AREA,
    LIGHT_SPOT,
    LIGHT_TUBE_AREA,
)

_HALF_PI = 1.5707963267948966


def _shade_kernel(p_ref, cnt_ref, lst_ref, lrec_ref, wp_ref, n_ref, alb_ref,
                  cov_ref, *rest, cap: int, tiles_x: int, n_vis: int,
                  slices: int, unit_pow: bool, light_kinds: tuple | None):
    # Static light-type specialization: when the caller knows the scene's
    # light-type set at trace time, math for ABSENT types is skipped — the
    # where-chains below would select the same operands with all-False
    # conditions, so the result is bit-identical.
    has_spot = light_kinds is None or LIGHT_SPOT in light_kinds
    has_rect = light_kinds is None or LIGHT_RECT_AREA in light_kinds
    has_tube = light_kinds is None or LIGHT_TUBE_AREA in light_kinds
    rest = list(rest)
    out_ref = rest.pop()
    vis_ref = rest.pop(0) if n_vis else None
    slice_ref = rest.pop(0) if slices else None

    t_lin = pl.program_id(0) * tiles_x + pl.program_id(1)
    px, py, pz = wp_ref[:, :, 0], wp_ref[:, :, 1], wp_ref[:, :, 2]
    nx, ny, nz = n_ref[:, :, 0], n_ref[:, :, 1], n_ref[:, :, 2]
    covered = cov_ref[...] > 0.0

    vx, vy, vz = p_ref[0] - px, p_ref[1] - py, p_ref[2] - pz
    vl = jax.lax.rsqrt(jnp.maximum(vx * vx + vy * vy + vz * vz, 1e-16))
    vx, vy, vz = vx * vl, vy * vl, vz * vl

    def unit3(a_, b_, c_):
        il = jax.lax.rsqrt(jnp.maximum(a_ * a_ + b_ * b_ + c_ * c_, 1e-16))
        return a_ * il, b_ * il, c_ * il

    def light_body(lid, carry, slice_mask=None):
        ldr_, ldg, ldb, lsr, lsg, lsb = carry

        def f(j):
            return lrec_ref[lid, j]

        ltype = f(0)
        posx, posy, posz = f(1), f(2), f(3)
        if has_spot or has_rect:
            fwdx, fwdy, fwdz = unit3(f(4), f(5), f(6))
        rng = jnp.maximum(f(17), 0.001)
        # Type tests as full tiles: every select below is then tile-shaped
        # (the Triton lowering does not broadcast scalar predicates).
        is_spot = jnp.broadcast_to(ltype == float(LIGHT_SPOT), px.shape)
        is_rect = jnp.broadcast_to(ltype == float(LIGHT_RECT_AREA), px.shape)
        is_tube = jnp.broadcast_to(ltype == float(LIGHT_TUBE_AREA), px.shape)

        emx, emy, emz = posx, posy, posz
        if has_rect:
            upx, upy, upz = unit3(f(7), f(8), f(9))
            rx0, ry0, rz0 = unit3(upy * fwdz - upz * fwdy,
                                  upz * fwdx - upx * fwdz,
                                  upx * fwdy - upy * fwdx)
            u2x, u2y, u2z = unit3(fwdy * rz0 - fwdz * ry0,
                                  fwdz * rx0 - fwdx * rz0,
                                  fwdx * ry0 - fwdy * rx0)
            rx, ry, rz = unit3(u2y * fwdz - u2z * fwdy,
                               u2z * fwdx - u2x * fwdz,
                               u2x * fwdy - u2y * fwdx)
            hex_, hey = jnp.maximum(f(20), 0.05), jnp.maximum(f(21), 0.05)
            dxp, dyp, dzp = px - posx, py - posy, pz - posz
            ux = jnp.clip(dxp * rx + dyp * ry + dzp * rz, -hex_, hex_)
            uy = jnp.clip(dxp * u2x + dyp * u2y + dzp * u2z, -hey, hey)
            emx = jnp.where(is_rect, posx + rx * ux + u2x * uy, emx)
            emy = jnp.where(is_rect, posy + ry * ux + u2y * uy, emy)
            emz = jnp.where(is_rect, posz + rz * ux + u2z * uy, emz)
        if has_tube:
            axx, axy, axz = unit3(f(10), f(11), f(12))
            thl = jnp.maximum(f(22), 0.1)
            ax2, ay2, az2 = axx * (2.0 * thl), axy * (2.0 * thl), axz * (2.0 * thl)
            a0x, a0y, a0z = posx - axx * thl, posy - axy * thl, posz - axz * thl
            denom_seg = jnp.maximum(ax2 * ax2 + ay2 * ay2 + az2 * az2, 1e-8)
            tseg = jnp.clip(((px - a0x) * ax2 + (py - a0y) * ay2
                             + (pz - a0z) * az2) / denom_seg, 0.0, 1.0)
            emx = jnp.where(is_tube, a0x + ax2 * tseg, emx)
            emy = jnp.where(is_tube, a0y + ay2 * tseg, emy)
            emz = jnp.where(is_tube, a0z + az2 * tseg, emz)

        tlx, tly, tlz = emx - px, emy - py, emz - pz
        dist = jnp.sqrt(jnp.maximum(tlx * tlx + tly * tly + tlz * tlz, 1e-16))
        inv_d = 1.0 / dist
        llx, lly, llz = tlx * inv_d, tly * inv_d, tlz * inv_d

        shaping = 1.0
        spec_pw, spec_sc = 36.0, 0.30
        if has_spot:
            inner = jnp.clip(f(18), 0.02, _HALF_PI - 0.02)
            outer = jnp.clip(jnp.maximum(inner + 0.005, f(19)),
                             inner + 0.005, _HALF_PI - 0.005)
            cin, cout = jnp.cos(inner), jnp.cos(outer)
            cos_t = -(llx * fwdx + lly * fwdy + llz * fwdz)
            tt = jnp.clip((cos_t - cout) / jnp.maximum(cin - cout, 1e-5),
                          0.0, 1.0)
            shaping = jnp.where(
                is_spot, jnp.where(cos_t > cout, tt * tt * (3.0 - 2.0 * tt),
                                   0.0), shaping)
            spec_pw = jnp.where(is_spot, 34.0, spec_pw)
            spec_sc = jnp.where(is_spot, 0.32, spec_sc)
        if has_rect:
            facing = jnp.maximum(-(fwdx * llx + fwdy * lly + fwdz * llz), 0.0)
            shaping = jnp.where(
                is_rect, jnp.where(facing > 0.0, 0.65 + 0.55 * facing, 0.0),
                shaping)
            spec_pw = jnp.where(is_rect, 26.0, spec_pw)
            spec_sc = jnp.where(is_rect, 0.26, spec_sc)
        if has_tube:
            soft = jnp.clip(1.0 - dist / rng, 0.0, 1.0)
            shaping = jnp.where(is_tube, 0.75 + 0.35 * soft, shaping)
            spec_pw = jnp.where(is_tube, 22.0, spec_pw)
            spec_sc = jnp.where(is_tube, 0.20, spec_sc)

        amodel = f(24)
        norm = jnp.clip(1.0 - dist / rng, 0.0, 1.0)
        smooth = norm * norm * (3.0 - 2.0 * norm)
        invsq = jnp.minimum(1.0, (rng * rng) / jnp.maximum(
            dist * dist, jnp.maximum(f(26), 1e-5))) * norm * norm
        fall = jnp.where(amodel == 0.0, norm,
                         jnp.where(amodel == 1.0, smooth, invsq))
        if not unit_pow:
            # Skipped when every light's atten_power is 1 (pow(x, 1) = x).
            fall = jnp.power(jnp.maximum(fall, 1e-9),
                             jnp.maximum(f(25), 0.001))
        acut = f(27)
        fall = jnp.where((acut > 0.0) & (fall < acut), 0.0, fall)
        atten = jnp.where(dist < rng, fall, 0.0) * jnp.maximum(shaping, 0.0)

        lndl = jnp.maximum(nx * llx + ny * lly + nz * llz, 0.0)
        live = (dist > 1e-4) & (lndl > 0.0) & (atten > 0.0) & covered
        if slice_mask is not None:
            live = live & slice_mask
        gain = jnp.where(live, f(16) * atten, 0.0)
        if n_vis:
            # Local shadow maps: record lane 28 is the light's visibility
            # plane (eval_local_shadow multiply, fp_stress_scene.frag:520);
            # plane n_vis-1 is the constant 1.0 of unshadowed lights.
            sidx = f(28).astype(jnp.int32)
            gain = jax.lax.cond(sidx < n_vis - 1,
                                lambda g: g * vis_ref[:, :, sidx],
                                lambda g: g, gain)

        hxl, hyl, hzl = llx + vx, lly + vy, llz + vz
        hll = jax.lax.rsqrt(jnp.maximum(hxl * hxl + hyl * hyl + hzl * hzl,
                                        1e-16))
        lndh = jnp.maximum(nx * (hxl * hll) + ny * (hyl * hll)
                           + nz * (hzl * hll), 0.0)
        spec = spec_sc * jnp.power(jnp.maximum(lndh, 1e-9), spec_pw)
        wd = gain * lndl
        ws = gain * spec
        cr = jnp.maximum(f(13), 0.0)
        cg = jnp.maximum(f(14), 0.0)
        cb = jnp.maximum(f(15), 0.0)
        return (ldr_ + cr * wd, ldg + cg * wd, ldb + cb * wd,
                lsr + cr * ws, lsg + cg * ws, lsb + cb * ws)

    def walk(bin_idx, carry, slice_mask=None):
        n = jnp.minimum(cnt_ref[bin_idx], cap)
        return jax.lax.fori_loop(
            0, n, lambda k, c: light_body(lst_ref[bin_idx * cap + k], c,
                                          slice_mask), carry)

    zero = jnp.zeros_like(px)
    acc = (zero,) * 6
    if slices:
        # Clustered: walk only the slices present among covered pixels,
        # each pixel taking its own slice's lights
        # (view_depth_to_cluster_slice semantics).
        sl = slice_ref[...]
        s_lo = jnp.min(jnp.min(jnp.where(covered, sl, slices), axis=1),
                       axis=0)
        s_hi = jnp.max(jnp.max(jnp.where(covered, sl, -1), axis=1), axis=0)
        acc = jax.lax.fori_loop(
            s_lo, s_hi + 1,
            lambda s, c: walk(t_lin * slices + s, c, slice_mask=sl == s), acc)
    else:
        acc = walk(t_lin, acc)
    ld_r, ld_g, ld_b, ls_r, ls_g, ls_b = acc

    covf = covered.astype(jnp.float32)
    out_ref[:, :, 0] = (alb_ref[:, :, 0] * ld_r + ls_r) * covf
    out_ref[:, :, 1] = (alb_ref[:, :, 1] * ld_g + ls_g) * covf
    out_ref[:, :, 2] = (alb_ref[:, :, 2] * ld_b + ls_b) * covf


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile_size", "cap", "slices",
                     "unit_atten_power", "light_kinds"),
)
def shade_local_lights(
    gb_world_pos, gb_normal, gb_covered, albedo, camera_pos,
    lights, view, proj,
    width: int, height: int,
    tile_size: int = 16,
    cap: int = 128,
    tile_depth_range=None,
    local_vis_stack=None,
    light_shadow_index=None,
    cluster_slice_plane=None,
    slices: int = 0,
    zn=None,
    zf=None,
    unit_atten_power: bool = False,
    light_kinds: tuple | None = None,
):
    """Binned local lighting.  Returns ((H,W,3) lit, bin_stats): albedo *
    diffuse + specular summed over each pixel's tile list, zero outside
    coverage (the XLA path's accumulate_local_lights + material combine).

    local_vis_stack: optional (H, W, K+1) per-shadowed-light visibility
    planes (lighting/local_shadows.local_shadow_vis_stack; channel K must
    be 1.0); light_shadow_index: (L,) i32 plane index per light.

    cluster_slice_plane + slices>0 switches the light walk to CLUSTERED
    mode: lists come from cull_lights_clustered (per tile x log-Z slice) and
    pixels take only their own slice's lights.

    unit_atten_power: every light has atten_power == 1, so the attenuation
    pow is skipped.  light_kinds: static set of light types present.
    """
    ts = tile_size
    assert ts & (ts - 1) == 0, "tile_size must be a power of two"
    tiles_x = cdiv(width, ts)
    tiles_y = cdiv(height, ts)
    ph, pw = tiles_y * ts, tiles_x * ts

    if slices:
        from lsr_tpu.lighting.light_culling import cull_lights_clustered

        lists, counts, bin_stats = cull_lights_clustered(
            lights, view, proj, zn, zf, width, height,
            tile_size=ts, cap=cap, slices=slices,
        )
    else:
        lists, counts, bin_stats = cull_lights_tiled(
            lights, view, proj, width, height, tile_size=ts, cap=cap,
            tile_depth_range=tile_depth_range,
        )
    packed = pack_light_records(lights)
    if light_shadow_index is not None:
        packed = packed.at[:, 28].set(light_shadow_index.astype(jnp.float32))

    def padp(x):
        return jnp.pad(
            x, ((0, ph - height), (0, pw - width)) + ((0, 0),) * (x.ndim - 2))

    pix = [padp(gb_world_pos), padp(gb_normal), padp(albedo),
           padp(gb_covered.astype(jnp.float32))]
    n_vis = 0
    if local_vis_stack is not None:
        n_vis = local_vis_stack.shape[-1]
        pix.append(padp(local_vis_stack))
    if slices:
        pix.append(padp(cluster_slice_plane.astype(jnp.int32)))

    def block(x):
        if x.ndim == 2:
            return pl.BlockSpec((ts, ts), lambda i, j: (i, j))
        return pl.BlockSpec((ts, ts, x.shape[-1]), lambda i, j: (i, j, 0))

    whole = pl.BlockSpec(None, None)
    kern = functools.partial(
        _shade_kernel, cap=cap, tiles_x=tiles_x, n_vis=n_vis, slices=slices,
        unit_pow=unit_atten_power, light_kinds=light_kinds)
    out = pl.pallas_call(
        kern,
        grid=(tiles_y, tiles_x),
        in_specs=[whole] * 4 + [block(x) for x in pix],
        out_specs=pl.BlockSpec((ts, ts, 3), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((ph, pw, 3), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=2, num_stages=1),
        backend="triton",
        interpret=kernel_interpret(),
        name="lsr_shade",
    )(jnp.pad(camera_pos.astype(jnp.float32), (0, 1)), counts,
      lists.reshape(-1), packed, *pix)
    return out[:height, :width], bin_stats
