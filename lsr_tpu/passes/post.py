"""Post-process stack: fused fullscreen image passes.

Each pass mirrors a reference pass/demo, expressed as one XLA-fused array
transform (these are the embarrassingly-parallel row loops of the reference,
which is exactly what fuses into one elementwise pass):

- motion_vectors: per-pixel velocity from history matrices
  (rasterizer.hpp:387-414 write_motion block)
- motion_blur: velocity-scaled line blur with depth rejection on LDR
  (pass_motion_blur.hpp:30-200; defaults frame_params.hpp:49-57)
- light_shafts: sun screen projection + luma prepass + radial march
  (pass_light_shafts.hpp:44-210; defaults frame_params.hpp:35-42)
- gaussian_blur / bloom / fog / outline / dof: the HelloMultiPass &
  hello-render-target post chains (hello_multi_pass.cpp:605-1050)
- fxaa: luma-based edge AA (hello_multi_pass.cpp:1000 fxaa_pass)
- taa: exponential history blend with neighborhood clamp
  (TemporalAARuntimeState analog, core/context.hpp:98)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsr_tpu.core.color import quantize_u8
from lsr_tpu.core.gather import take_rows

# ---------------------------------------------------------------------------
# Motion vectors + motion blur
# ---------------------------------------------------------------------------


def motion_vectors_pass(gb, objects, viewproj, prev_viewproj, width, height,
                        max_vel: float = 96.0):
    """Per-pixel screen-space velocity in pixels (rasterizer.hpp:387-414)."""
    # curr_to_prev = prev_model @ inverse(model) PER OBJECT (tiny O set),
    # then one per-pixel row gather — never per-pixel matrix inverses.
    det = jnp.linalg.det(objects.model[:, :3, :3])
    safe = jnp.abs(det) > 1e-10
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), objects.model.shape)
    inv_model = jnp.linalg.inv(
        jnp.where(safe[:, None, None], objects.model, eye)
    )
    c2p_obj = jnp.where(safe[:, None, None],
                        objects.prev_model @ inv_model, eye)  # (O, 4, 4)

    obj = jnp.maximum(gb.obj_id, 0)
    o = objects.model.shape[0]
    c2p = take_rows(c2p_obj.reshape(o, 16), obj).reshape(obj.shape + (4, 4))

    wp = gb.world_pos
    hom = jnp.concatenate([wp, jnp.ones_like(wp[..., :1])], -1)
    hi = jax.lax.Precision.HIGHEST
    prev_world = jnp.einsum("hwij,hwj->hwi", c2p, hom, precision=hi)
    curr_clip = jnp.matmul(hom, viewproj.T, precision=hi)
    prev_clip = jnp.matmul(prev_world, prev_viewproj.T, precision=hi)

    wc = curr_clip[..., 3:4]
    wp_ = prev_clip[..., 3:4]
    ok = (jnp.abs(wc) > 1e-8) & (jnp.abs(wp_) > 1e-8)
    curr_ndc = curr_clip[..., :2] / jnp.where(ok, wc, 1.0)
    prev_ndc = prev_clip[..., :2] / jnp.where(ok, wp_, 1.0)
    vel = (curr_ndc - prev_ndc) * 0.5 * jnp.asarray([width, height], wp.dtype)
    ln = jnp.linalg.norm(vel, axis=-1, keepdims=True)
    scale = jnp.where(ln > max_vel, max_vel / jnp.maximum(ln, 1e-6), 1.0)
    vel = vel * scale
    vel = jnp.where(ok & gb.covered[..., None], vel, 0.0)
    return vel


@functools.partial(jax.jit, static_argnames=("samples",))
def motion_blur_pass(img, depth01, velocity, dt,
                     samples: int = 10, strength: float = 1.0,
                     max_velocity_px: float = 20.0,
                     min_velocity_px: float = 0.25,
                     depth_reject: float = 0.08):
    """Velocity line blur (pass_motion_blur.hpp semantics, including lround
    sampling, dt normalization clamp and the 'fewer than 1 accepted sample
    -> passthrough' rule).

    Dtype-generic: float input (the reference's HDR pipeline form,
    pass_motion_blur.hpp:40 runs on RT_ColorHDR) stays float with no
    quantization; uint8 input (legacy HelloMultiPass LDR chain) keeps the
    exact round+clip semantics."""
    h, w = depth01.shape
    is_u8 = img.dtype == jnp.uint8
    src = img.astype(jnp.float32)
    dt_scale = jnp.clip(jnp.maximum(dt, 1e-4) * 60.0, 0.5, 2.5)

    v = velocity * (strength * dt_scale)
    ln = jnp.linalg.norm(v, axis=-1)
    over = (ln > max_velocity_px) & (ln > 1e-6)
    v = jnp.where(over[..., None], v * (max_velocity_px / jnp.maximum(ln, 1e-6))[..., None], v)

    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]

    # Color + depth packed per texel: ONE row gather per tap instead of two.
    packed = jnp.concatenate([src, depth01[..., None]], -1).reshape(h * w, 4)

    acc = jnp.zeros((h, w, 3), jnp.float32)
    cnt = jnp.zeros((h, w), jnp.float32)
    for i in range(samples):
        t = i / (samples - 1) - 0.5
        sx = jnp.clip(jnp.round(xs + v[..., 0] * t), 0, w - 1).astype(jnp.int32)
        sy = jnp.clip(jnp.round(ys + v[..., 1] * t), 0, h - 1).astype(jnp.int32)
        row = take_rows(packed, sy * w + sx)
        sd = row[..., 3]
        take = jnp.abs(sd - depth01) <= depth_reject
        acc = acc + jnp.where(take[..., None], row[..., :3], 0.0)
        cnt = cnt + take.astype(jnp.float32)

    ok = (cnt >= 1.0) & (ln >= min_velocity_px)
    avg = acc / jnp.maximum(cnt, 1.0)[..., None]
    out = jnp.where(ok[..., None], avg, src)
    if is_u8:
        return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)
    return out


# ---------------------------------------------------------------------------
# Light shafts
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("steps", "log_march"))
def light_shafts_pass(img, depth01, camera_pos, sun_dir_ws, viewproj,
                      steps: int = 48, density: float = 0.8,
                      weight: float = 0.9, decay: float = 0.95,
                      log_march: bool = True):
    """Radial god-ray march toward the projected sun (pass_light_shafts.hpp).

    Dtype-generic: float input is treated as HDR in [0,1]-ish scale (the
    reference pass runs on HDR, pass_light_shafts.hpp:44) and returns float
    with no quantization; uint8 keeps the exact legacy round/clip math.

    log_march=True (default) runs the march as log2(N) ZOOM-COMPOSE passes
    instead of N per-step gathers: each pass adds a decayed, sun-zoomed
    copy of its own accumulation, so pass k contributes samples at every
    index j with weight decay^j and position t_j = 1-(1-d)^j (geometric
    spacing toward the sun; zoom maps compose as 1-(1-a)(1-b)).  That is
    2^ceil(log2 steps) effective taps from ~6 gathers — the gather count
    is the cost of this pass.  The reference's linear-t spacing is available with
    log_march=False; the deviation of the default is documented in
    PARITY.md ("light shafts march") and golden/parity presets pin
    log_march explicitly."""
    h, w = depth01.shape
    is_u8 = img.dtype == jnp.uint8
    src = img.astype(jnp.float32)
    scale = 255.0 if is_u8 else 1.0

    sun_pos = camera_pos + (-sun_dir_ws) * 100.0
    clip = jnp.concatenate([sun_pos, jnp.ones(1, jnp.float32)]) @ viewproj.T
    wc = clip[3]
    ndc = clip[:3] / jnp.where(jnp.abs(wc) > 1e-6, wc, 1.0)
    sun_u = ndc[0] * 0.5 + 0.5
    sun_v = ndc[1] * 0.5 + 0.5
    sun_valid = (
        (jnp.abs(wc) > 1e-6) & (wc > 0.0)
        & (ndc[2] >= -1.0) & (ndc[2] <= 1.0)
        & (sun_u >= 0.0) & (sun_u <= 1.0) & (sun_v >= 0.0) & (sun_v <= 1.0)
    )

    luma = (0.2126 * src[..., 0] + 0.7152 * src[..., 1]
            + 0.0722 * src[..., 2]) / scale
    # Sky/far pixels keep shafts: luma scaled by depth (near=0 kills them).
    luma = luma * jnp.clip(depth01, 0.0, 1.0)

    u = jnp.arange(w, dtype=jnp.float32)[None, :] / max(1, w - 1)
    v = jnp.arange(h, dtype=jnp.float32)[:, None] / max(1, h - 1)

    if log_march:
        import math

        k_passes = max(1, math.ceil(math.log2(max(steps, 2))))
        n = 2 ** k_passes
        # density/decay/weight may be traced (FrameParams values): all the
        # schedule math stays in jnp.
        dens = jnp.minimum(jnp.asarray(density, jnp.float32), 0.99)
        decay_f = jnp.asarray(decay, jnp.float32)
        one_m = jnp.power(1.0 - dens, 1.0 / max(n - 1, 1))  # (1 - delta)

        accum = luma * weight  # j = 0 term
        for k in range(k_passes):
            tk = 1.0 - jnp.power(one_m, 2 ** k)
            wk = jnp.power(decay_f, 2 ** k)
            su = u + (sun_u - u) * tk
            sv = v + (sun_v - v) * tk
            sx = jnp.clip(jnp.round(su * (w - 1)), 0, w - 1).astype(jnp.int32)
            sy = jnp.clip(jnp.round(sv * (h - 1)), 0, h - 1).astype(jnp.int32)
            accum = accum + wk * take_rows(accum.reshape(-1), sy * w + sx)
        # Keep overall energy comparable to the linear march: the linear sum
        # of `steps` decayed taps vs 2^K; rescale by the geometric-series
        # weight-sum ratio (decay == 1 guarded).
        safe_d = jnp.where(jnp.abs(decay_f - 1.0) < 1e-6, 0.999999, decay_f)
        lin_sum = (1.0 - jnp.power(safe_d, steps)) / (1.0 - safe_d)
        log_sum = (1.0 - jnp.power(safe_d, n)) / (1.0 - safe_d)
        accum = accum * (lin_sum / log_sum)
    else:
        accum = jnp.zeros((h, w), jnp.float32)
        illum = 1.0
        for i in range(steps):
            t = i / steps
            su = u + (sun_u - u) * (t * density)
            sv = v + (sun_v - v) * (t * density)
            sx = jnp.clip(jnp.round(su * (w - 1)), 0, w - 1).astype(jnp.int32)
            sy = jnp.clip(jnp.round(sv * (h - 1)), 0, h - 1).astype(jnp.int32)
            accum = accum + take_rows(luma.reshape(-1), sy * w + sx) \
                * (illum * weight)
            illum = illum * decay

    if is_u8:
        boost = jnp.clip(jnp.round(accum * 80.0), 0, 120)
        out = jnp.stack([
            src[..., 0] + boost,
            src[..., 1] + boost,
            src[..., 2] + jnp.floor(boost / 2),
        ], axis=-1)
        out = jnp.clip(out, 0, 255).astype(jnp.uint8)
        return jnp.where(sun_valid, out, img)
    boost = jnp.clip(accum * 80.0, 0.0, 120.0) / 255.0
    out = jnp.stack([
        src[..., 0] + boost,
        src[..., 1] + boost,
        src[..., 2] + boost * 0.5,
    ], axis=-1)
    return jnp.where(sun_valid, out, src)


# ---------------------------------------------------------------------------
# Blur / bloom / fog / outline / DoF / FXAA / TAA
# ---------------------------------------------------------------------------


def _gaussian_kernel1d(radius: int, sigma: float | None = None):
    if sigma is None:
        sigma = max(radius * 0.5, 1e-3)
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def _shift_clamped(x, off: int, axis: int):
    """Edge-clamped shift as pad+slice (pure data movement; a jnp.take here
    lowers to a slow gather)."""
    if off == 0:
        return x
    n = x.shape[axis]
    take = [slice(None)] * x.ndim
    if off > 0:
        take[axis] = slice(off, n)
        body = x[tuple(take)]
        edge = [slice(None)] * x.ndim
        edge[axis] = slice(n - 1, n)
        pads = [x[tuple(edge)]] * off
        return jnp.concatenate([body] + pads, axis=axis)
    take[axis] = slice(0, n + off)
    body = x[tuple(take)]
    edge = [slice(None)] * x.ndim
    edge[axis] = slice(0, 1)
    pads = [x[tuple(edge)]] * (-off)
    return jnp.concatenate(pads + [body], axis=axis)


@functools.partial(jax.jit, static_argnames=("radius",))
def gaussian_blur(img, radius: int = 2, sigma: float | None = None):
    """Separable clamped gaussian blur; float (H,W,C) in/out."""
    k = _gaussian_kernel1d(radius, sigma)
    img_f = img.astype(jnp.float32)

    def blur_axis(x, axis):
        out = jnp.zeros_like(x)
        for j, off in enumerate(range(-radius, radius + 1)):
            out = out + k[j] * _shift_clamped(x, off, axis)
        return out

    return blur_axis(blur_axis(img_f, 0), 1)


@functools.partial(jax.jit, static_argnames=("blur_radius", "passes"))
def bloom_pass(hdr, threshold: float = 1.0, intensity: float = 0.5,
               blur_radius: int = 4, passes: int = 2):
    """Bright-pass + iterated blur + additive combine (HelloGlowingStar /
    composition 'bloom' post preset)."""
    luma = 0.2126 * hdr[..., 0] + 0.7152 * hdr[..., 1] + 0.0722 * hdr[..., 2]
    bright = jnp.where((luma > threshold)[..., None], hdr, 0.0)
    blurred = bright
    for _ in range(passes):
        blurred = gaussian_blur(blurred, radius=blur_radius)
    return hdr + blurred * intensity


def fog_pass(hdr, depth01, fog_color=(0.55, 0.6, 0.68), fog_density: float = 1.6):
    """Exponential depth fog (hello_multi_pass.cpp:764 fog_pass)."""
    f = 1.0 - jnp.exp(-fog_density * jnp.clip(depth01, 0.0, 1.0))
    fc = jnp.asarray(fog_color, jnp.float32)
    return hdr + (fc - hdr) * f[..., None]


def outline_pass(hdr, depth01, threshold: float = 0.003,
                 color=(0.0, 0.0, 0.0)):
    """Depth-discontinuity outlines (hello_multi_pass.cpp:689 outline_pass)."""
    d = depth01
    dx = jnp.abs(d - jnp.roll(d, 1, axis=1))
    dy = jnp.abs(d - jnp.roll(d, 1, axis=0))
    edge = (jnp.maximum(dx, dy) > threshold)[..., None]
    return jnp.where(edge, jnp.asarray(color, jnp.float32), hdr)


@functools.partial(jax.jit, static_argnames=("blur_radius", "center_frac"))
def depth_of_field_pass(hdr, depth01, focus_depth: float = -1.0,
                        focus_range: float = 0.08, blur_radius: int = 4,
                        center_frac: float = 0.125):
    """Autofocus-median DoF (hello_multi_pass.cpp:907-990): focus depth =
    median of the center window (when focus_depth < 0), then blend sharp vs
    blurred by circle of confusion."""
    h, w = depth01.shape
    ch = max(2, int(h * center_frac))
    cw = max(2, int(w * center_frac))
    y0 = (h - ch) // 2
    x0 = (w - cw) // 2
    center = jax.lax.dynamic_slice(depth01, (y0, x0), (ch, cw))
    auto_focus = jnp.median(center)
    focus = jnp.where(focus_depth >= 0.0, focus_depth, auto_focus)

    coc = jnp.clip(jnp.abs(depth01 - focus) / jnp.maximum(focus_range, 1e-4),
                   0.0, 1.0)
    blurred = gaussian_blur(hdr, radius=blur_radius)
    return hdr + (blurred - hdr) * coc[..., None]


@jax.jit
def fxaa_pass(ldr_u8, contrast_threshold: float = 0.0312,
              relative_threshold: float = 0.125):
    """Luma-based FXAA on the LDR image (hello_multi_pass.cpp:1000)."""
    src = ldr_u8.astype(jnp.float32) / 255.0
    luma = 0.299 * src[..., 0] + 0.587 * src[..., 1] + 0.114 * src[..., 2]

    def sh(dx, dy):
        return jnp.roll(jnp.roll(luma, dy, axis=0), dx, axis=1)

    n, s, e, w_ = sh(0, -1), sh(0, 1), sh(1, 0), sh(-1, 0)
    lmax = jnp.maximum(jnp.maximum(jnp.maximum(n, s), jnp.maximum(e, w_)), luma)
    lmin = jnp.minimum(jnp.minimum(jnp.minimum(n, s), jnp.minimum(e, w_)), luma)
    contrast = lmax - lmin
    thresh = jnp.maximum(contrast_threshold, relative_threshold * lmax)
    active = contrast >= thresh

    ne, nw, se, sw = sh(1, -1), sh(-1, -1), sh(1, 1), sh(-1, 1)
    blend_l = (2.0 * (n + s + e + w_) + ne + nw + se + sw) / 12.0
    f = jnp.clip(jnp.abs(blend_l - luma) / jnp.maximum(contrast, 1e-5), 0.0, 1.0)
    f = f * f * (3.0 - 2.0 * f)

    horiz = (jnp.abs(n + s - 2 * luma) * 2.0 +
             jnp.abs(ne + se - 2 * e) + jnp.abs(nw + sw - 2 * w_)) >= \
            (jnp.abs(e + w_ - 2 * luma) * 2.0 +
             jnp.abs(ne + nw - 2 * n) + jnp.abs(se + sw - 2 * s))
    pos_l = jnp.where(horiz, n, e)
    neg_l = jnp.where(horiz, s, w_)
    pgrad = jnp.abs(pos_l - luma)
    ngrad = jnp.abs(neg_l - luma)
    step_pos = pgrad >= ngrad
    neighbor = jnp.where(
        (step_pos & horiz)[..., None], jnp.roll(src, -1, axis=0),
        jnp.where((~step_pos & horiz)[..., None], jnp.roll(src, 1, axis=0),
                  jnp.where((step_pos & ~horiz)[..., None],
                            jnp.roll(src, 1, axis=1),
                            jnp.roll(src, -1, axis=1))))
    out = src + (neighbor - src) * (f * active)[..., None]
    return quantize_u8(out)


@jax.jit
def taa_pass(hdr, history, velocity, blend: float = 0.1,
             clamp_neighborhood: bool = True):
    """Temporal AA: reproject history by velocity, clamp to the 3x3
    neighborhood, exponential blend.  Returns (resolved, new_history)."""
    h, w = hdr.shape[:2]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    px = jnp.clip(jnp.round(xs - velocity[..., 0]), 0, w - 1).astype(jnp.int32)
    py = jnp.clip(jnp.round(ys - velocity[..., 1]), 0, h - 1).astype(jnp.int32)
    hist = take_rows(history.reshape(h * w, -1), py * w + px)

    if clamp_neighborhood:
        cmin = hdr
        cmax = hdr
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nb = jnp.roll(jnp.roll(hdr, dy, axis=0), dx, axis=1)
                cmin = jnp.minimum(cmin, nb)
                cmax = jnp.maximum(cmax, nb)
        hist = jnp.clip(hist, cmin, cmax)

    resolved = hist + (hdr - hist) * blend
    return resolved, resolved


@functools.partial(jax.jit, static_argnames=("ghosts",))
def lens_flare_pass(hdr, threshold: float = 2.0, intensity: float = 0.35,
                    ghosts: int = 4, halo_radius: float = 0.45):
    """Pseudo lens flare (the HelloGlowingStar demo's flare):
    bright-pass ghosts mirrored through the screen center + a halo ring."""
    h, w = hdr.shape[:2]
    luma = 0.2126 * hdr[..., 0] + 0.7152 * hdr[..., 1] + 0.0722 * hdr[..., 2]
    bright = jnp.where((luma > threshold)[..., None], hdr, 0.0)
    bright = gaussian_blur(bright, radius=3)

    # Ghosts: sample the bright pass at center-mirrored, scaled positions.
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    out = jnp.zeros_like(hdr)
    for g in range(ghosts):
        s = -0.4 - 0.35 * g  # mirrored, spreading scales
        gy = jnp.clip(jnp.round(cy + (ys - cy) * s), 0, h - 1).astype(jnp.int32)
        gx = jnp.clip(jnp.round(cx + (xs - cx) * s), 0, w - 1).astype(jnp.int32)
        weight = intensity / (g + 1.0)
        tint = jnp.asarray([1.0 - 0.15 * g, 0.8, 0.7 + 0.1 * g], jnp.float32)
        out = out + take_rows(bright.reshape(h * w, -1), gy * w + gx) * weight * tint

    # Halo: ring of bright energy at a fixed radius from center.
    r = jnp.sqrt(((ys - cy) / h) ** 2 + ((xs - cx) / w) ** 2)
    halo_w = jnp.exp(-((r - halo_radius) ** 2) / 0.001)[..., None]
    halo_src = take_rows(
        bright.reshape(h * w, -1),
        ((h - 1) - ys.astype(jnp.int32)) * w + (w - 1) - xs.astype(jnp.int32))
    out = out + halo_src * halo_w * (intensity * 0.5)
    return hdr + out
