"""Directional shadow-map sampling with PCF (fullscreen, vectorized).

Semantics follow the reference exactly (shadow_sample.hpp:30-108):
- project world pos by light viewproj, NDC [-1,1] -> uv/z in [0,1],
- outside-map or degenerate w -> fully lit,
- slope-scaled bias from NdotL,
- hard (radius 0) or PCF (2r+1)^2 box average on nearest-texel centers with
  clamped fetches.

The PCF window is a static unrolled offset set, so the whole pass fuses into
one elementwise+gather XLA program over the framebuffer.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["depth", "light_viewproj", "bias_const", "bias_slope",
                 "strength", "depth_taps"],
    meta_fields=["pcf_radius", "pcf_step", "tap_stride", "filter_mode",
                 "esm_c"],
)
@dataclasses.dataclass(frozen=True)
class ShadowContext:
    depth: jnp.ndarray           # (S, S) f32 shadow map depth in [0,1]
    light_viewproj: jnp.ndarray  # (4, 4)
    bias_const: jnp.ndarray      # scalar (default 0.0008)
    bias_slope: jnp.ndarray      # scalar (default 0.0015)
    strength: jnp.ndarray        # scalar in [0,1]
    pcf_radius: int = 2          # 0 = hard
    pcf_step: int = 1            # texel step
    tap_stride: int = 8          # anchor stride of depth_taps windows
    depth_taps: jnp.ndarray | None = None  # pcf: ((S/stride)^2, win^2);
                                 # esm: (S*S/2,) u32 packed soft-map pairs
    filter_mode: str = "pcf"     # "pcf" (reference-exact) | "esm"
    esm_c: float = 80.0          # ESM sharpness exponent


# Whole-frame fusion knob: materialize tap-table slices before gathering.
TAPS_BARRIER = True

# Quantize packed tap tables to u16 pairs in u32 lanes: 4x smaller table
# bytes and half the gather lanes.  The gather's row rate falls as the
# table grows, so shrinking the table is the main visibility lever; the
# 1/65535 depth quantum is ~130x below the smallest shadow bias in use
# (2e-3), so the lit-fraction change is confined to taps within one
# quantum of the biased test depth.
TAPS_U16 = True


def _quantize_q16(z):
    """f32 [0,1] depth -> i32 [0, 65535] (round-to-nearest)."""
    return jnp.clip(jnp.round(z * 65535.0), 0.0, 65535.0).astype(jnp.int32)


def pack_taps_u16(taps):
    """(R, L) f32 [0,1] window table -> (R, L/2) u32, 2 u16 taps per lane.

    Lane i packs taps 2i (low half) and 2i+1 (high half).  L must be even
    (it is for every stride/radius in use: win^2 with win = stride + 2r and
    stride in {6, 8})."""
    r, l = taps.shape
    if l % 2:
        raise ValueError("pack_taps_u16 needs an even lane count")
    q = _quantize_q16(taps).astype(jnp.uint32)
    return q[:, 0::2] | (q[:, 1::2] << 16)


def pack_shadow_taps_u16(depth, radius: int, stride: int = 8):
    """Quantize-at-source u16 window table: (S, S) f32 -> (R, win^2/2) u32.

    Bit-identical to pack_taps_u16(pack_shadow_taps(depth, ...)) — window
    assembly is pure data movement, so quantizing the (S, S) map FIRST
    commutes with it — but assembles the windows at 2 bytes/texel instead
    of 4 and skips the full-table requantize pass (the window table is
    ~2.25x the map's texel count at stride 8/r 2)."""
    q16 = _quantize_q16(depth).astype(jnp.uint16)
    taps = pack_shadow_taps(q16, radius, stride)
    if taps.shape[-1] % 2:
        raise ValueError("pack_shadow_taps_u16 needs an even lane count")
    q = taps.astype(jnp.uint32)
    return q[:, 0::2] | (q[:, 1::2] << 16)


def count_lit(window, z_test, mask):
    """Masked count of window taps passing the depth test, dtype-dispatched.

    window: gathered tap rows — (..., L) f32, or (..., L/2) u32 packed u16
    pairs (pack_taps_u16); z_test: (...) f32 biased test depth; mask:
    (..., L) f32 lane mask (broadcastable).  Returns (...) f32 counts.
    """
    if window.dtype == jnp.uint32:
        q = _quantize_q16(z_test)[..., None]
        lo = (window & jnp.uint32(0xFFFF)).astype(jnp.int32)
        hi = (window >> jnp.uint32(16)).astype(jnp.int32)
        return (jnp.sum((q <= lo).astype(jnp.float32) * mask[..., 0::2], -1)
                + jnp.sum((q <= hi).astype(jnp.float32) * mask[..., 1::2],
                          -1))
    return jnp.sum((z_test[..., None] <= window).astype(jnp.float32) * mask,
                   -1)


def pack_shadow_taps(depth, radius: int, stride: int = 8):
    """(S, S) -> ((S/stride)^2, (stride+2r)^2) strided anchor windows.

    ONE wide row gather per pixel fetches the whole PCF window, but its
    cost scales with the TABLE size (the per-texel (S*S, 25) form is the
    slow one).  Packing one window per `stride`-aligned ANCHOR shrinks the
    table by
    stride^2 while still covering every pixel's full clamped (2r+1)^2
    window: a pixel at (cy, cx) uses anchor (cy//stride, cx//stride), whose
    window spans [A*stride - r, A*stride + stride-1 + r] — lane
    (ry + dy + r, rx + dx + r) with (ry, rx) = (cy, cx) % stride holds
    exactly the clamped texel (cy+dy, cx+dx).  For 2048^2 at r=2: stride 4
    = 67MB, stride 8 = 38MB instead of 420MB.  Packing is stride^2-subsampled
    shifted copies (dense elementwise work), rebuilt once per shadow-map
    render."""
    if 2 * radius > stride:
        raise ValueError("pack_shadow_taps needs 2*radius <= stride so a "
                         "window spans at most 2 blocks per axis")
    s = depth.shape[0]
    win = stride + 2 * radius
    n_anchor = -(-s // stride)
    if radius == 0:
        # Hard shadows: each anchor window IS its stride-block (no overlap;
        # the general path below would drop the last block row).
        pad = n_anchor * stride - s
        dd = jnp.pad(depth, ((0, pad), (0, pad)), mode="edge")
        bl = dd.reshape(n_anchor, stride, n_anchor, stride)
        return bl.transpose(0, 2, 1, 3).reshape(n_anchor * n_anchor,
                                                stride * stride)
    # Edge-pad so anchor (ay, ax)'s window starts at padded row ay*stride
    # and the padded map is a whole number of stride-blocks.  Assembling
    # windows is then FOUR shifted block-array concats (im2col by reshape)
    # instead of win^2 full-map shifted copies (which cost ~200ms at 2048^2).
    need = n_anchor * stride + 2 * radius
    d_size = -(-need // stride) * stride
    pad_br = d_size - s - radius
    dd = jnp.pad(depth, ((radius, pad_br), (radius, pad_br)), mode="edge")
    nb = d_size // stride
    bl = dd.reshape(nb, stride, nb, stride).transpose(0, 2, 1, 3)
    top = jnp.concatenate([bl[:-1, :-1], bl[:-1, 1:]], axis=-1)
    bot = jnp.concatenate([bl[1:, :-1], bl[1:, 1:]], axis=-1)
    w = jnp.concatenate([top, bot], axis=-2)  # (nb-1, nb-1, 2*st, 2*st)
    w = w[:n_anchor, :n_anchor, :win, :win]
    return w.reshape(n_anchor * n_anchor, win * win)


def prefilter_esm(depth, radius: int, c: float = 80.0):
    """ESM soft occluder map: log-domain box-filtered exp depth.

    soft(y, x) = ln(mean over the clamped (2r+1)^2 window of exp(c*z)) / c,
    computed as exp((z-1)*c) so every operand stays in [e^-c, 1] (no f32
    overflow for any c; c <= ~85 keeps e^-c normal, avoiding
    flush-to-zero of subnormals).  The box window + edge clamping match the
    PCF footprint exactly (shadow_sample.hpp:65 clamps per-tap coords; an
    edge-padded blur is the same operator), so ESM visibility
    clamp(exp(c*(soft - z_test))) converges to the PCF box average as
    c -> inf.  Separable: two unrolled (2r+1)-tap passes of dense adds
    — NO gathers, which is the point: sampling becomes one 1-lane fetch
    per (pixel, light) instead of a win^2-lane window gather
    (ARCHITECTURE.md round-4 ledger; the round-3 gather-floor finding).

    Returns (S, S) f32 soft depth; log-mean-exp lies in [window min,
    window max] so the result stays in [0, 1].
    """
    if radius <= 0:
        return depth
    k = 2 * radius + 1
    e = jnp.exp((depth - 1.0) * c)
    p = jnp.pad(e, radius, mode="edge")
    rows = sum(p[i:i + depth.shape[0], :] for i in range(k))
    both = sum(rows[:, i:i + depth.shape[1]] for i in range(k))
    mean = both * jnp.float32(1.0 / (k * k))
    return jnp.log(mean) * jnp.float32(1.0 / c) + 1.0


def pack_soft_u16(soft):
    """(S, S) f32 [0,1] soft map -> (S*S/2,) u32, texel pairs per lane.

    Lane i packs texels 2i (low) and 2i+1 (high) of the row-major flat
    map.  Halving the table bytes raises the gather row rate (the rate is
    table-size-bound; see pack_shadow_taps' cost notes)."""
    flat = _quantize_q16(soft).astype(jnp.uint32).reshape(-1)
    if flat.shape[0] % 2:
        raise ValueError("pack_soft_u16 needs an even texel count")
    return flat[0::2] | (flat[1::2] << 16)


def fetch_soft(packed, idx):
    """Fetch f32 [0,1] soft depths for flat row-major texel indices.

    packed: (T/2,) u32 from pack_soft_u16 (possibly a per-slot slice);
    idx: any-shape i32 flat texel ids local to `packed`'s map. ONE 1-lane
    gather row per element."""
    from lsr_tpu.core.gather import take_rows

    w = take_rows(packed, idx >> 1)
    lo = (w & jnp.uint32(0xFFFF)).astype(jnp.float32)
    hi = (w >> jnp.uint32(16)).astype(jnp.float32)
    q = jnp.where((idx & 1) == 0, lo, hi)
    return q * jnp.float32(1.0 / 65535.0)


def esm_visibility(soft_z, z_test, c: float):
    """clamp(exp(c * (soft_z - z_test)), 0, 1): ~1 where the receiver is at
    or in front of the filtered occluder depth, exponential falloff with
    the depth gap behind it (the classic ESM estimator)."""
    return jnp.clip(jnp.exp((soft_z - z_test) * jnp.float32(c)), 0.0, 1.0)


def make_shadow_context(
    depth,
    light_viewproj,
    bias_const: float = 0.0008,
    bias_slope: float = 0.0015,
    strength: float = 1.0,
    pcf_radius: int = 2,
    pcf_step: int = 1,
    tap_stride: int = 8,
    filter_mode: str = "pcf",
    esm_c: float = 80.0,
) -> ShadowContext:
    if filter_mode == "esm" and pcf_radius > 0:
        taps = pack_soft_u16(prefilter_esm(depth, pcf_radius, esm_c))
    elif filter_mode == "esm":
        filter_mode = "pcf"  # radius 0 is a single hard tap either way
        taps = None
    elif pcf_radius > 0 and pcf_step == 1:
        taps = (pack_shadow_taps_u16(depth, pcf_radius, tap_stride)
                if TAPS_U16
                else pack_shadow_taps(depth, pcf_radius, tap_stride))
    else:
        taps = None
    if taps is not None and TAPS_BARRIER:
        # Force the window table to MATERIALIZE contiguously before any
        # consumer, so the visibility gather never reads a fused strided
        # view of the padded block assembly (see module flag).
        taps = jax.lax.optimization_barrier(taps)
    return ShadowContext(
        depth=depth,
        light_viewproj=jnp.asarray(light_viewproj, jnp.float32),
        bias_const=jnp.float32(bias_const),
        bias_slope=jnp.float32(bias_slope),
        strength=jnp.float32(strength),
        pcf_radius=int(pcf_radius),
        pcf_step=int(pcf_step),
        tap_stride=tap_stride,
        depth_taps=taps,
        filter_mode=filter_mode,
        esm_c=float(esm_c),
    )


def shadow_visibility_dir(shadow: ShadowContext, world_pos, ndotl):
    """Visibility in [0,1] per pixel; world_pos (H,W,3), ndotl (H,W)."""
    sm = shadow.depth
    sh, sw = sm.shape

    # Explicit-FMA projection: an (H,W,4)@(4,4) dot_general may run at
    # reduced precision by default (TF32 would move uvs by texels at
    # 2048^2); the FMAs keep full f32.
    m = shadow.light_viewproj
    px_, py_, pz_ = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]

    def mrow(r):
        return m[r, 0] * px_ + m[r, 1] * py_ + m[r, 2] * pz_ + m[r, 3]

    p = jnp.stack([mrow(0), mrow(1), mrow(2), mrow(3)], -1)  # (H, W, 4)
    w = p[..., 3]
    w_ok = jnp.abs(w) >= 1e-8
    w_safe = jnp.where(w_ok, w, 1.0)
    ndc = p[..., :3] / w_safe[..., None]
    u = ndc[..., 0] * 0.5 + 0.5
    v = ndc[..., 1] * 0.5 + 0.5
    z = ndc[..., 2] * 0.5 + 0.5
    in_map = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0) & w_ok

    slope = 1.0 - jnp.clip(ndotl, 0.0, 1.0)
    z_test = z - (shadow.bias_const + shadow.bias_slope * slope)

    fx = u * (sw - 1)
    fy = v * (sh - 1)
    cx = jnp.round(fx).astype(jnp.int32)
    cy = jnp.round(fy).astype(jnp.int32)

    r = max(0, shadow.pcf_radius)
    step = max(1, shadow.pcf_step)

    def fetch(ox, oy):
        x = jnp.clip(cx + ox, 0, sw - 1)
        y = jnp.clip(cy + oy, 0, sh - 1)
        return sm[y, x]

    if r == 0:
        vis = (z_test <= fetch(0, 0)).astype(jnp.float32)
    elif shadow.filter_mode == "esm" and shadow.depth_taps is not None:
        # ESM: the (2r+1)^2 box filter is baked into the soft map
        # (prefilter_esm), so sampling is ONE 1-lane fetch per pixel at the
        # PCF anchor texel — the round-4 gather-floor fix.  Deviation class:
        # exp-filtered visibility approximates the PCF box average
        # (documented in PARITY.md; exact PCF stays the default path).
        idx = jnp.clip(cy, 0, sh - 1) * sw + jnp.clip(cx, 0, sw - 1)
        soft = fetch_soft(shadow.depth_taps, idx)
        vis = esm_visibility(soft, z_test, shadow.esm_c)
    elif shadow.depth_taps is not None and step == 1:
        # Packed path: ONE wide gather fetches the strided anchor window
        # that covers this pixel's whole (2r+1)^2 PCF footprint (see
        # pack_shadow_taps for the table geometry + cost model), then a
        # static lane mask selects the exact taps.  Clamp semantics match
        # the reference's per-tap coordinate clamp (edge-replicated pack).
        from lsr_tpu.core.gather import take_rows

        stride = shadow.tap_stride
        win = stride + 2 * r
        n_anchor = -(-sw // stride)
        ax = cx // stride
        ay = cy // stride
        rx = (cx - ax * stride)[..., None]           # (..., 1) in [0, stride)
        ry = (cy - ay * stride)[..., None]
        window = take_rows(shadow.depth_taps, ay * n_anchor + ax)
        lane = jnp.arange(win * win, dtype=jnp.int32)
        li = lane // win                             # lane row in window
        lj = lane % win
        m = ((li >= ry) & (li <= ry + 2 * r)
             & (lj >= rx) & (lj <= rx + 2 * r)).astype(jnp.float32)
        lit = count_lit(window, z_test, m)
        vis = lit / float((2 * r + 1) ** 2)
    else:
        lit = jnp.zeros_like(z_test)
        for oy in range(-r, r + 1):
            for ox in range(-r, r + 1):
                lit = lit + (z_test <= fetch(ox * step, oy * step)).astype(jnp.float32)
        vis = lit / float((2 * r + 1) ** 2)

    vis = jnp.where(in_map, vis, 1.0)
    return 1.0 + (vis - 1.0) * jnp.clip(shadow.strength, 0.0, 1.0)
