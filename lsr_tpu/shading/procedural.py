"""Procedural 2D fragment-shader library (the hello-shaders demo family).

Every function is a fullscreen field: (H, W) uv/pixel grids -> (H, W, 3)
colors, evaluated as one fused elementwise pass — the array form of the reference's
per-pixel fragment_shader loops (hello-shaders/*.cpp).

Building blocks mirror shs::Math (shs_renderer.hpp:127-197): the sin-dot
hash `f_random` (:179), simplex-based `fbm` with rotation+shift octaves
(:182-194), and the demos' hsb_to_rgb (hello_color_hsb.cpp:26-40).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_PI = 3.14159265358979


def uv_grid(width: int, height: int):
    """(H, W) u and v in [0,1) plus raw pixel coords, bottom-left origin."""
    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32)
    px, py = jnp.meshgrid(xs, ys)
    return px / width, py / height, px, py


def f_random(x, y):
    """shs::Math::f_random — fract(sin(dot(st, (12.9898,78.233))) * 43758.5453)."""
    return jnp.modf(jnp.sin(x * 12.9898 + y * 78.233) * 43758.5453123)[0] % 1.0


def _permute(x):
    return jnp.mod(((x * 34.0) + 1.0) * x, 289.0)


def snoise2(x, y):
    """2D simplex noise (the classic permutation-polynomial formulation that
    glm::simplex uses).  Returns values in about [-1, 1]."""
    c_x = 0.211324865405187
    c_y = 0.366025403784439
    c_z = -0.577350269189626
    c_w = 0.024390243902439

    s = (x + y) * c_y
    ix = jnp.floor(x + s)
    iy = jnp.floor(y + s)
    t = (ix + iy) * c_x
    x0 = x - ix + t
    y0 = y - iy + t

    i1x = jnp.where(x0 > y0, 1.0, 0.0)
    i1y = 1.0 - i1x
    x1 = x0 + c_x - i1x
    y1 = y0 + c_x - i1y
    x2 = x0 + c_z
    y2 = y0 + c_z

    ix = jnp.mod(ix, 289.0)
    iy = jnp.mod(iy, 289.0)
    p0 = _permute(_permute(iy) + ix)
    p1 = _permute(_permute(iy + i1y) + ix + i1x)
    p2 = _permute(_permute(iy + 1.0) + ix + 1.0)

    def contrib(p, xx, yy):
        m = jnp.maximum(0.5 - (xx * xx + yy * yy), 0.0)
        m = m * m
        m = m * m
        gx = 2.0 * jnp.modf(p * c_w)[0] - 1.0
        h = jnp.abs(gx) - 0.5
        ox = jnp.floor(gx + 0.5)
        a0 = gx - ox
        m = m * (1.79284291400159 - 0.85373472095314 * (a0 * a0 + h * h))
        return m * (a0 * xx + h * yy)

    return 130.0 * (contrib(p0, x0, y0) + contrib(p1, x1, y1) + contrib(p2, x2, y2))


def fbm(x, y, octaves: int = 5):
    """shs::Math::fbm — simplex octaves with fixed rotation + shift."""
    c, s = jnp.cos(0.5), jnp.sin(0.5)
    v = jnp.zeros_like(x)
    a = 0.5
    for _ in range(octaves):
        v = v + a * snoise2(x, y)
        # p = rot * p * 2 + 100 with rot = [[c, -s], [s, c]] (glm col-major).
        nx = (c * x - s * y) * 2.0 + 100.0
        ny = (s * x + c * y) * 2.0 + 100.0
        x, y = nx, ny
        a = a * 0.5
    return v


def hsb_to_rgb(h, s, b):
    """hello_color_hsb.cpp:26-40 conversion (smoothstepped hue ramp)."""
    def channel(off):
        r = jnp.clip(jnp.abs(jnp.mod(h * 6.0 + off, 6.0) - 3.0) - 1.0, 0.0, 1.0)
        return r * r * (3.0 - 2.0 * r)

    rgb = jnp.stack([channel(0.0), channel(4.0), channel(2.0)], axis=-1)
    out = 1.0 + (rgb - 1.0) * s[..., None]
    return out * b[..., None]


# ---------------------------------------------------------------------------
# Shader fields (one per reference demo)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("width", "height"))
def shader_color_gradient(width: int, height: int, t=0.0):
    """HelloColorGradient: animated two-corner rgb gradient."""
    u, v, _, _ = uv_grid(width, height)
    r = u * (0.5 + 0.5 * jnp.sin(t))
    g = v
    b = 0.5 + 0.5 * jnp.cos(t * 0.7)
    return jnp.stack([r, g, jnp.broadcast_to(b, u.shape)], axis=-1)


@functools.partial(jax.jit, static_argnames=("width", "height"))
def shader_color_hsb(width: int, height: int, t=0.0):
    """HelloColorHSB: hue from x, brightness from y."""
    u, v, _, _ = uv_grid(width, height)
    return hsb_to_rgb(u, jnp.ones_like(u), v)


@functools.partial(jax.jit, static_argnames=("width", "height"))
def shader_color_hsb_polar(width: int, height: int, t=0.0):
    """HelloColorHSBPolar: hue from angle, saturation from radius."""
    u, v, _, _ = uv_grid(width, height)
    x = u * 2.0 - 1.0
    y = v * 2.0 - 1.0
    ang = jnp.arctan2(y, x) / (2.0 * _PI) + 0.5 + t * 0.05
    rad = jnp.minimum(jnp.sqrt(x * x + y * y), 1.0)
    return hsb_to_rgb(jnp.mod(ang, 1.0), rad, jnp.ones_like(rad))


@functools.partial(jax.jit, static_argnames=("width", "height"))
def shader_color_mix(width: int, height: int, t=0.0):
    """HelloColorMix: mix of two colors by an animated sine curve."""
    u, v, _, _ = uv_grid(width, height)
    a = jnp.asarray([0.149, 0.141, 0.912], jnp.float32)
    b = jnp.asarray([1.000, 0.833, 0.224], jnp.float32)
    pct = (0.5 + 0.5 * jnp.sin(u * _PI * 2.0 + t))[..., None]
    return a + (b - a) * pct


@functools.partial(jax.jit, static_argnames=("width", "height", "octaves"))
def shader_fbm_clouds(width: int, height: int, t=0.0, octaves: int = 5):
    """HelloFractalBrownianMotion (hello_fbm.cpp:32-64): warped fbm clouds."""
    _, _, px, py = uv_grid(width, height)
    t = jnp.asarray(t, jnp.float32)
    sx = px / width * 3.0
    sy = py / height * 3.0
    warp = jnp.abs(jnp.sin(t * 0.1) * 3.0)
    sx = sx + warp * sx
    sy = sy + warp * sy

    qx = fbm(sx, sy, octaves)
    qy = fbm(sx + 1.0, sy + 1.0, octaves)
    rx = fbm(sx + qx + 1.7 + 0.15 * t, sy + qy + 9.2, octaves)
    ry = fbm(sx + qx + 8.3 + 0.126 * t, sy + qy + 2.8, octaves)
    f = fbm(sx + rx, sy + ry, octaves)

    c1 = jnp.asarray([0.101961, 0.619608, 0.666667], jnp.float32)
    c2 = jnp.asarray([0.666667, 0.666667, 0.498039], jnp.float32)
    c3 = jnp.asarray([0.0, 0.0, 0.164706], jnp.float32)
    c4 = jnp.asarray([0.666667, 1.0, 1.0], jnp.float32)

    m1 = jnp.clip(f * f * 4.0, 0.0, 1.0)[..., None]
    col = c1 + (c2 - c1) * m1
    ql = jnp.clip(jnp.sqrt(qx * qx + qy * qy), 0.0, 1.0)[..., None]
    col = col + (c3 - col) * ql
    rl = jnp.clip(jnp.abs(rx), 0.0, 1.0)[..., None]
    col = col + (c4 - col) * rl
    return col * (f * f * f + 0.6 * f * f + 0.5 * f)[..., None]


@functools.partial(jax.jit, static_argnames=("width", "height", "font_scale"))
def shader_green_noise(width: int, height: int, t=0.0, font_scale: float = 16.0):
    """HelloGreenNoise (matrix rain, hello_green_noise.cpp:27-60)."""
    _, _, px, py = uv_grid(width, height)
    ix = px / font_scale
    iy = py / font_scale
    jx = jnp.mod(ix, 1.0)
    jy = jnp.mod(iy, 1.0)
    fx = jnp.floor(ix)
    fy = jnp.floor(iy)
    speed = 10.0
    offset = 18.0 * jnp.sin(fx)
    pyv = fy + jnp.floor(jnp.asarray(t, jnp.float32) * (speed + offset))
    noise = f_random(jnp.zeros_like(pyv), pyv)
    g = jnp.where((jx > 0.75) | (jy > 0.75) | (noise < 0.25), 0.0, noise)
    z = jnp.zeros_like(g)
    return jnp.stack([z, g, z], axis=-1)


@functools.partial(jax.jit, static_argnames=("width", "height"))
def shader_mongolian_flag(width: int, height: int, t=0.0):
    """HelloMongolianFlag: waving three-band flag + emblem + vignette + grain
    (hello_mongolian_flag.cpp:97-117 field structure)."""
    u, v, px, py = uv_grid(width, height)
    t = jnp.asarray(t, jnp.float32)
    red = jnp.asarray([0.753, 0.188, 0.286], jnp.float32)
    blue = jnp.asarray([0.095, 0.278, 0.610], jnp.float32)
    yellow = jnp.asarray([0.980, 0.824, 0.212], jnp.float32)

    w = jnp.sin((u + v - t * 2.95
                 + jnp.sin(15.5 * u + 4.5 * v) * _PI * 0.1) * _PI * 0.6)
    uw = u * (1.0 + (0.026 - 0.026 * w))
    vw = v * (1.0 + (0.026 - 0.026 * w))

    band = jnp.where(uw < 1.0 / 3.0, 0, jnp.where(uw < 2.0 / 3.0, 1, 0))
    col = jnp.where(band[..., None] == 0, red, blue)

    # Emblem: stacked simple soyombo-like glyph in the left band.
    ex = (uw - 1.0 / 6.0) * 6.0
    ey = (vw - 0.5) * 3.0
    flame = (jnp.abs(ex) < 0.22) & (ey > 0.55) & (ey < 1.0 + 0.2 * jnp.cos(ex * 8.0))
    sun = ex * ex + (ey - 0.35) ** 2 < 0.18 ** 2
    bars = (jnp.abs(ex) < 0.45) & (
        ((ey > -0.95) & (ey < -0.75)) | ((ey > 0.05) & (ey < 0.25))
    )
    rects = (jnp.abs(jnp.abs(ex) - 0.58) < 0.10) & (jnp.abs(ey) < 0.95)
    circ = ex * ex + (ey + 0.42) ** 2 < 0.22 ** 2
    emblem = flame | sun | bars | rects | circ
    col = jnp.where(emblem[..., None], yellow, col)

    col = col + w[..., None] * 0.225
    vin = 16.0 * u * (1.0 - u) * v * (1.0 - v)
    col = col * (1.0 - 0.6 * jnp.exp2(-1.75 * vin))[..., None]
    col = col - f_random(px, py)[..., None] * 0.004
    return jnp.clip(col, 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("width", "height", "samples"))
def shader_worm_hole(width: int, height: int, t=0.0, samples: int = 7):
    """HelloWormHole: swirling tunnel with temporal supersampling
    (hello_worm_hole.cpp:137-159 structure)."""
    u, v, _, _ = uv_grid(width, height)
    x = (u * 2.0 - 1.0) * (width / height)
    y = v * 2.0 - 1.0
    t = jnp.asarray(t, jnp.float32)
    r = jnp.sqrt(x * x + y * y) + 1e-4
    span = 0.0045 + 0.0002 * r

    col = jnp.zeros(u.shape + (3,), jnp.float32)
    for k in range(samples):
        f = k / (samples - 1)
        tk = t + f * span
        ang = jnp.arctan2(y, x)
        tunnel = 0.3 / r + tk * 2.0
        swirl = ang * 3.0 + 4.0 * r - tk * 3.0
        stripes = 0.5 + 0.5 * jnp.sin(tunnel * 8.0 + jnp.sin(swirl))
        glow = jnp.exp(-2.5 * r)
        ck = jnp.stack([
            stripes * (0.4 + 0.6 * jnp.sin(tk + ang)) + glow,
            stripes * 0.55 + glow * 0.7,
            stripes * (0.7 + 0.3 * jnp.cos(tk * 0.7)) + glow * 1.2,
        ], axis=-1)
        fade = jnp.clip(r * 1.4, 0.0, 1.0)[..., None]
        col = col + ck * fade
    return jnp.clip(col / samples, 0.0, 1.0)


PROCEDURAL_SHADERS = {
    "color_gradient": shader_color_gradient,
    "color_hsb": shader_color_hsb,
    "color_hsb_polar": shader_color_hsb_polar,
    "color_mix": shader_color_mix,
    "fbm": shader_fbm_clouds,
    "green_noise": shader_green_noise,
    "mongolian_flag": shader_mongolian_flag,
    "worm_hole": shader_worm_hole,
}
