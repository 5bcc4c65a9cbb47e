"""Built-in shading models as fused fullscreen passes over the G-buffer.

Each model mirrors a reference fragment shader:
- blinn_phong: make_blinn_phong_program (builtin_shaders.hpp:105-152) —
  normalized Blinn-Phong + directional shadow + fake IBL.
- pbr_mr: make_pbr_mr_program (builtin_shaders.hpp:154-218) — Cook-Torrance
  GGX D / Smith-Schlick G / Schlick F metal-rough.
- flat/gouraud/phong/toon/gooch/oren_nayar: the hello_pipeline_* family
  (hello-3d-primitives demos), classic formulations.
- debug views: make_debug_view_shader_program (builtin_shaders.hpp:221-246).

All functions take the G-buffer + a ShadeContext and return a linear HDR
(H, W, 3) image for COVERED pixels (callers composite with background/sky
using gb.covered).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from lsr_tpu.lighting.shadow_sample import ShadowContext, shadow_visibility_dir
from lsr_tpu.shading.common import MaterialsSoA, eval_fake_ibl, sample_texture_bilinear

_PI = 3.14159265358979


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "light_dir_ws", "light_color", "light_intensity", "camera_pos",
        "materials", "textures", "shadow", "texture_quads", "ibl",
        "mat_override", "sun_vis",
    ],
    meta_fields=["surface_maps"],
)
@dataclasses.dataclass(frozen=True)
class ShadeContext:
    """Frame-level shading uniforms (the ShaderUniforms analog,
    shader/types.hpp:86-113)."""

    light_dir_ws: jnp.ndarray     # (3,) direction FROM light TOWARD scene
    light_color: jnp.ndarray      # (3,)
    light_intensity: jnp.ndarray  # scalar
    camera_pos: jnp.ndarray       # (3,)
    materials: MaterialsSoA
    textures: jnp.ndarray | None = None     # (NT, S, S, 3) linear
    shadow: ShadowContext | None = None
    texture_quads: jnp.ndarray | None = None  # pack_texture_quads(textures)
    ibl: tuple | None = None  # (irradiance_faces, (prefiltered mips...))
    mat_override: tuple | None = None  # per-pixel (albedo, metal, rough, ao,
                                # emissive) — set by surface-map application
                                # so ORM/emissive maps reach every model
    sun_vis: jnp.ndarray | None = None  # (H, W) precomputed sun shadow
                                # visibility (forward+ at reduced resolution)
    surface_maps: bool = False  # STATIC: any normal/ORM/emissive slot used
                                # (set by make_shade_context; gates the
                                # extra texture gathers per frame)


def make_shade_context(
    materials: MaterialsSoA,
    light_dir_ws=(0.0, -1.0, 0.0),
    light_color=(1.0, 1.0, 1.0),
    light_intensity=1.0,
    camera_pos=(0.0, 0.0, 0.0),
    textures=None,
    shadow=None,
    ibl=None,
) -> ShadeContext:
    import numpy as np

    from lsr_tpu.shading.common import pack_texture_quads

    surface_maps = textures is not None and bool(
        (np.asarray(materials.normal_tex) >= 0).any()
        or (np.asarray(materials.orm_tex) >= 0).any()
        or (np.asarray(materials.emissive_tex) >= 0).any()
    )
    return ShadeContext(
        light_dir_ws=jnp.asarray(light_dir_ws, jnp.float32),
        light_color=jnp.asarray(light_color, jnp.float32),
        light_intensity=jnp.float32(light_intensity),
        camera_pos=jnp.asarray(camera_pos, jnp.float32),
        materials=materials,
        textures=textures,
        shadow=shadow,
        texture_quads=None if textures is None else pack_texture_quads(textures),
        ibl=ibl,
        surface_maps=surface_maps,
    )


def _ambient(ctx, n, v, albedo, metal, rough, ao):
    """Real IBL when maps are present, the fake approximation otherwise
    (the reference's eval_fake_ibl is explicitly the no-PMREM fallback)."""
    if ctx.ibl is not None:
        from lsr_tpu.resources.ibl import eval_ibl

        irr, pref = ctx.ibl
        return eval_ibl(irr, list(pref), n, v, albedo, metal, rough, ao)
    return eval_fake_ibl(n, v, albedo, metal, rough, ao)


def _norm(v, eps=1e-12):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


def _gather_material(gb, ctx):
    from lsr_tpu.shading.common import gather_materials

    if ctx.mat_override is not None:
        return ctx.mat_override

    base, metal, rough, ao, emissive, tex_id = gather_materials(
        ctx.materials, gb.obj_id, mat_rec=getattr(gb, "mat", None)
    )
    if ctx.textures is not None:
        tex = sample_texture_bilinear(ctx.textures, tex_id, gb.uv,
                                      quads=ctx.texture_quads)
    else:
        tex = 1.0
    albedo = jnp.maximum(base * tex, 0.0)
    return albedo, metal, rough, ao, emissive


def _common_vectors(gb, ctx):
    n = _norm(gb.normal_ws)
    l = _norm(-ctx.light_dir_ws)[None, None, :]  # noqa: E741
    v = _norm(ctx.camera_pos[None, None, :] - gb.world_pos)
    h = _norm(l + v)
    ndl = jnp.maximum(jnp.sum(n * l, axis=-1, keepdims=True), 0.0)
    return n, jnp.broadcast_to(l, n.shape), v, h, ndl


def _shadow_term(gb, ctx, ndl):
    if ctx.sun_vis is not None:
        return ctx.sun_vis[..., None]
    if ctx.shadow is None:
        return 1.0
    vis = shadow_visibility_dir(ctx.shadow, gb.world_pos, ndl[..., 0])
    # Reference only samples when NdotL > 0 (shading is zero otherwise anyway).
    return jnp.where(ndl[..., 0] > 0.0, vis, 1.0)[..., None]


def shade_blinn_phong(gb, ctx: ShadeContext):
    albedo, metal, rough, ao, emissive = _gather_material(gb, ctx)
    n, l, v, h, ndl = _common_vectors(gb, ctx)  # noqa: E741
    ndh = jnp.maximum(jnp.sum(n * h, axis=-1, keepdims=True), 0.0)

    rough_c = jnp.clip(rough, 0.0, 1.0)
    metal_c = jnp.clip(metal, 0.0, 1.0)
    spec_pow = jnp.maximum(4.0, 8.0 + (1.0 - rough_c) * 120.0)
    spec_norm = (spec_pow + 2.0) / (2.0 * _PI)
    spec_f0 = 0.04 + 0.96 * metal_c
    spec = jnp.power(ndh, spec_pow) * spec_norm * spec_f0 * ndl
    kd = 1.0 - metal_c
    diffuse = kd * albedo * (ndl / _PI)

    vis = _shadow_term(gb, ctx, ndl)
    radiance = ctx.light_color[None, None, :] * ctx.light_intensity
    direct = (diffuse + spec) * radiance * vis
    ibl = _ambient(ctx, n, v, albedo, metal, rough, ao)
    return direct + ibl + emissive


def shade_pbr_mr(gb, ctx: ShadeContext):
    albedo, metal, rough, ao, emissive = _gather_material(gb, ctx)
    n, l, v, h, ndl = _common_vectors(gb, ctx)  # noqa: E741
    ndv = jnp.maximum(jnp.sum(n * v, axis=-1, keepdims=True), 0.0)
    ndh = jnp.maximum(jnp.sum(n * h, axis=-1, keepdims=True), 0.0)
    vdh = jnp.maximum(jnp.sum(v * h, axis=-1, keepdims=True), 0.0)

    rough_c = jnp.clip(rough, 0.04, 1.0)
    metal_c = jnp.clip(metal, 0.0, 1.0)
    f0 = 0.04 + (albedo - 0.04) * metal_c

    a = rough_c * rough_c
    a2 = a * a
    denom_d = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 / (_PI * denom_d * denom_d + 1e-7)

    k = (a + 1.0) * (a + 1.0) * 0.125
    g1 = lambda ndx: ndx / (ndx * (1.0 - k) + k + 1e-7)  # noqa: E731
    g = g1(ndv) * g1(ndl)

    f = f0 + (1.0 - f0) * jnp.power(1.0 - vdh, 5.0)
    spec = (d * g) * f / jnp.maximum(4.0 * ndl * ndv, 1e-6)

    kd = (1.0 - f) * (1.0 - metal_c)
    diff = kd * albedo * (1.0 / _PI)
    radiance = ctx.light_color[None, None, :] * ctx.light_intensity
    vis = _shadow_term(gb, ctx, ndl)
    lit = (ndl > 0.0) & (ndv > 0.0)
    direct = jnp.where(lit, (diff + spec) * radiance * ndl * vis, 0.0)
    ibl = _ambient(ctx, n, v, albedo, metal_c, rough_c, ao)
    return direct + ibl + emissive


# ---------------------------------------------------------------------------
# Stylized family (hello_pipeline_* demos)
# ---------------------------------------------------------------------------

def shade_flat(gb, ctx: ShadeContext):
    """Flat shading from the face normal (lambert, per-face constant)."""
    albedo, *_ = _gather_material(gb, ctx)
    n = _norm(gb.face_normal) if hasattr(gb, "face_normal") else _norm(gb.normal_ws)
    l = _norm(-ctx.light_dir_ws)[None, None, :]  # noqa: E741
    ndl = jnp.maximum(jnp.sum(n * l, axis=-1, keepdims=True), 0.0)
    return albedo * ndl * ctx.light_color * ctx.light_intensity


def shade_lambert(gb, ctx: ShadeContext):
    albedo, *_ = _gather_material(gb, ctx)
    n, l, v, h, ndl = _common_vectors(gb, ctx)  # noqa: E741
    return albedo * ndl * ctx.light_color * ctx.light_intensity


def shade_phong(gb, ctx: ShadeContext, shininess: float = 32.0,
                ambient: float = 0.08, spec_strength: float = 0.5):
    albedo, *_ = _gather_material(gb, ctx)
    n, l, v, h, ndl = _common_vectors(gb, ctx)  # noqa: E741
    r = _norm(2.0 * jnp.sum(n * l, axis=-1, keepdims=True) * n - l)
    rdv = jnp.maximum(jnp.sum(r * v, axis=-1, keepdims=True), 0.0)
    spec = spec_strength * jnp.power(rdv, shininess)
    c = (ambient + ndl) * albedo + spec
    return c * ctx.light_color * ctx.light_intensity


def shade_toon(gb, ctx: ShadeContext, bands: int = 4, ambient: float = 0.12):
    albedo, *_ = _gather_material(gb, ctx)
    n, l, v, h, ndl = _common_vectors(gb, ctx)  # noqa: E741
    q = jnp.ceil(ndl * bands) / bands
    return (ambient + q) * albedo * ctx.light_color * ctx.light_intensity


def shade_gooch(gb, ctx: ShadeContext, alpha: float = 0.25, beta: float = 0.5):
    albedo, *_ = _gather_material(gb, ctx)
    n, l, v, h, ndl = _common_vectors(gb, ctx)  # noqa: E741
    ndl_s = jnp.sum(n * l, axis=-1, keepdims=True)  # signed
    t = (ndl_s + 1.0) * 0.5
    cool = jnp.array([0.0, 0.0, 0.55], jnp.float32) + alpha * albedo
    warm = jnp.array([0.3, 0.3, 0.0], jnp.float32) + beta * albedo
    r = _norm(2.0 * ndl_s * n - l)
    rdv = jnp.maximum(jnp.sum(r * v, axis=-1, keepdims=True), 0.0)
    spec = jnp.power(rdv, 32.0)
    return cool + (warm - cool) * t + spec


def shade_gouraud(setup, gb, ctx: ShadeContext, shininess: float = 24.0,
                  ambient: float = 0.08, spec_strength: float = 0.35):
    """True Gouraud: Blinn-Phong evaluated at the triangle CORNERS, then
    interpolated with the pixel's perspective-correct barycentrics (the
    hello_pipeline_gouraud_shading vertex-lighting path)."""
    from lsr_tpu.core.gather import take_rows

    safe = jnp.maximum(gb.tri_id, 0)
    wp_c = take_rows(setup.wp, safe)  # (H, W, 3, 3)
    nw_c = _norm(take_rows(setup.nw, safe))
    l = _norm(-ctx.light_dir_ws)[None, None, None, :]  # noqa: E741
    v = _norm(ctx.camera_pos[None, None, None, :] - wp_c)
    h = _norm(l + v)
    ndl = jnp.maximum(jnp.sum(nw_c * l, -1, keepdims=True), 0.0)
    ndh = jnp.maximum(jnp.sum(nw_c * h, -1, keepdims=True), 0.0)
    albedo, *_ = _gather_material(gb, ctx)
    corner = (ambient + ndl) * albedo[..., None, :] \
        + spec_strength * jnp.power(ndh, shininess)
    lit = jnp.sum(corner * gb.bary[..., None], axis=-2)
    return lit * ctx.light_color * ctx.light_intensity


def shade_oren_nayar(gb, ctx: ShadeContext, sigma: float = 0.35):
    albedo, *_ = _gather_material(gb, ctx)
    n, l, v, h, ndl = _common_vectors(gb, ctx)  # noqa: E741
    ndv = jnp.sum(n * v, axis=-1, keepdims=True)
    s2 = sigma * sigma
    a = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b = 0.45 * s2 / (s2 + 0.09)
    theta_i = jnp.arccos(jnp.clip(ndl, -1.0, 1.0))
    theta_r = jnp.arccos(jnp.clip(ndv, -1.0, 1.0))
    alpha = jnp.maximum(theta_i, theta_r)
    beta = jnp.minimum(theta_i, theta_r)
    lp = _norm(l - ndl * n)
    vp = _norm(v - ndv * n)
    cos_phi = jnp.maximum(jnp.sum(lp * vp, axis=-1, keepdims=True), 0.0)
    f = a + b * cos_phi * jnp.sin(alpha) * jnp.tan(beta)
    return albedo * ndl * f * ctx.light_color * ctx.light_intensity


# ---------------------------------------------------------------------------
# Debug views (DebugViewMode, frame_params.hpp:96)
# ---------------------------------------------------------------------------

def shade_debug_albedo(gb, ctx: ShadeContext):
    from lsr_tpu.core.gather import take_rows

    obj = jnp.maximum(gb.obj_id, 0)
    return jnp.broadcast_to(
        take_rows(ctx.materials.base_color, obj), gb.world_pos.shape
    )


def shade_debug_normal(gb, ctx: ShadeContext):
    return _norm(gb.normal_ws) * 0.5 + 0.5


def shade_debug_depth(gb, ctx: ShadeContext):
    d = jnp.clip(gb.depth01, 0.0, 1.0)[..., None]
    return jnp.broadcast_to(d, gb.depth01.shape + (3,))


SHADING_MODELS = {
    "blinn_phong": shade_blinn_phong,
    "pbr_mr": shade_pbr_mr,
    "flat": shade_flat,
    "lambert": shade_lambert,
    "phong": shade_phong,
    "toon": shade_toon,
    "gooch": shade_gooch,
    "oren_nayar": shade_oren_nayar,
    "debug_albedo": shade_debug_albedo,
    "debug_normal": shade_debug_normal,
    "debug_depth": shade_debug_depth,
}


def composite_over_background(shaded, gb, background):
    """Covered pixels take the shaded color; others the background (H,W,3)."""
    return jnp.where(gb.covered[..., None], shaded, background)
