"""Shading parity: full forward frame vs oracle raster + numpy port of the
reference Blinn-Phong/PBR fragment shaders (builtin_shaders.hpp:105-218)."""

import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.render import concat_scene, render_forward, simple_camera
from lsr_tpu.shading.common import checkerboard_texture, make_materials
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu.resources.assets import make_head_mesh

from tests.oracle import rasterize_oracle


def _np_norm(v, axis=-1):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), 1e-12)


def np_fake_ibl(n, v, base, metal, rough, ao):
    n = _np_norm(n)
    v = _np_norm(v)
    ndv = np.sum(n * v, -1, keepdims=True)
    r = 2 * ndv * n - v
    zen = np.float32([0.32, 0.46, 0.72])
    hor = np.float32([0.62, 0.66, 0.72])
    gnd = np.float32([0.16, 0.15, 0.14])
    up_n = np.clip(n[..., 1:2] * 0.5 + 0.5, 0, 1)
    up_r = np.clip(r[..., 1:2] * 0.5 + 0.5, 0, 1)
    env_n = gnd + ((hor + (zen - hor) * up_n) - gnd) * up_n
    env_r = gnd + ((hor + (zen - hor) * up_r) - gnd) * up_r
    m = np.clip(metal, 0, 1)
    rg = np.clip(rough, 0, 1)
    f0 = 0.04 + (np.maximum(base, 0) - 0.04) * m
    fres = (1 - np.maximum(ndv, 0)) ** 5
    f = f0 + (1 - f0) * fres
    kd = (1 - f) * (1 - m)
    return (kd * base * env_n * 0.12 + env_r * f * (0.02 + (1 - rg) * 0.18)) * np.clip(ao, 0, 1)


def np_blinn_phong(wp, n, uv, covered, base_color, metal, rough, ao,
                   light_dir, light_color, intensity, cam_pos, tex=None):
    albedo = base_color * np.ones_like(wp)
    if tex is not None:
        th, tw, _ = tex.shape
        u = uv[..., 0] - np.floor(uv[..., 0])
        v = uv[..., 1] - np.floor(uv[..., 1])
        fx, fy = u * (tw - 1), v * (th - 1)
        x0, y0 = np.floor(fx).astype(int), np.floor(fy).astype(int)
        x1, y1 = np.minimum(x0 + 1, tw - 1), np.minimum(y0 + 1, th - 1)
        txf, tyf = (fx - x0)[..., None], (fy - y0)[..., None]
        cx0 = tex[y0, x0] * (1 - txf) + tex[y0, x1] * txf
        cx1 = tex[y1, x0] * (1 - txf) + tex[y1, x1] * txf
        albedo = base_color * (cx0 * (1 - tyf) + cx1 * tyf)
    albedo = np.maximum(albedo, 0)
    n = _np_norm(n)
    l = _np_norm(-np.float32(light_dir))[None, None]  # noqa: E741
    v = _np_norm(np.float32(cam_pos)[None, None] - wp)
    h = _np_norm(l + v)
    ndl = np.maximum(np.sum(n * l, -1, keepdims=True), 0)
    ndh = np.maximum(np.sum(n * h, -1, keepdims=True), 0)
    spec_pow = max(4.0, 8.0 + (1 - np.clip(rough, 0, 1)) * 120.0)
    spec_norm = (spec_pow + 2) / (2 * np.pi)
    spec_f0 = 0.04 + 0.96 * np.clip(metal, 0, 1)
    spec = ndh**spec_pow * spec_norm * spec_f0 * ndl
    kd = 1 - np.clip(metal, 0, 1)
    diffuse = kd * albedo * (ndl / np.pi)
    direct = (diffuse + spec) * np.float32(light_color) * intensity
    ibl = np_fake_ibl(n, v, albedo, metal, rough, ao)
    out = direct + ibl
    return np.where(covered[..., None], out, 0)


def test_blinn_phong_frame_matches_oracle():
    mesh = make_head_mesh()
    w, h = 128, 128
    model = np.asarray(m3.rotate_y(0.4))
    vp, zn, zf = simple_camera(w, h, (0.3, 0.4, -3.0), (0, 0, 0))
    batch = {k: jnp.asarray(v) for k, v in concat_scene([mesh]).items()}

    tex = checkerboard_texture(64)
    light_dir = (0.4, -0.7, 0.6)
    mats = make_materials(
        base_color=[(0.9, 0.6, 0.4)], metallic=[0.1], roughness=[0.45],
        tex_id=[0],
    )
    ctx = make_shade_context(
        mats, light_dir_ws=light_dir, light_color=(1.0, 0.96, 0.9),
        light_intensity=2.5, camera_pos=(0.3, 0.4, -3.0),
        textures=jnp.asarray(tex)[None],
    )
    ldr, gb = render_forward(
        batch, jnp.asarray(model)[None],
        jnp.asarray(np.asarray(m3.normal_matrix(jnp.asarray(model))))[None],
        vp, zn, zf, ctx, w, h, model_name="blinn_phong",
        background=(0.0, 0.0, 0.0), use_tiled=True,
    )
    ldr = np.asarray(ldr)

    oracle = rasterize_oracle(
        mesh.positions, mesh.normals, mesh.uvs, mesh.indices,
        model, np.asarray(vp), w, h, float(zn), float(zf),
    )
    hdr_ref = np_blinn_phong(
        oracle["world_pos"], oracle["normal"], oracle["uv"], oracle["covered"],
        np.float32([0.9, 0.6, 0.4]), 0.1, 0.45, 1.0,
        light_dir, (1.0, 0.96, 0.9), 2.5, (0.3, 0.4, -3.0), tex=tex,
    )
    # Reference tonemap (pass_tonemap.hpp:55-80).
    c = np.maximum(hdr_ref, 0)
    c = c / (1 + c)
    c = c ** (1 / 2.2)
    ldr_ref = np.clip(np.floor(c * 255 + 0.5), 0, 255).astype(np.uint8)

    both = oracle["covered"] & np.asarray(gb.covered)
    agree = both.sum()
    assert agree > 3000
    diff = np.abs(ldr.astype(int) - ldr_ref.astype(int)).max(axis=-1)
    # Covered pixels: near-exact (float assoc differences only).
    q = np.quantile(diff[both], 0.99)
    assert q <= 2, f"q99 LDR diff {q}"
    # Coverage disagreement is a thin edge set.
    cov_dis = (oracle["covered"] != np.asarray(gb.covered)).sum()
    assert cov_dis < 0.01 * w * h


def test_all_shading_models_run():
    mesh = make_head_mesh()
    w, h = 64, 64
    model = np.eye(4, dtype=np.float32)
    vp, zn, zf = simple_camera(w, h, (0, 0, -3.0), (0, 0, 0))
    batch = {k: jnp.asarray(v) for k, v in concat_scene([mesh]).items()}
    mats = make_materials(base_color=[(0.8, 0.8, 0.8)])
    ctx = make_shade_context(mats, light_dir_ws=(0.3, -0.6, 0.7),
                             camera_pos=(0, 0, -3.0), light_intensity=2.0)
    for name in ("blinn_phong", "pbr_mr", "flat", "lambert", "phong", "toon",
                 "gooch", "oren_nayar", "debug_albedo", "debug_normal",
                 "debug_depth"):
        ldr, gb = render_forward(
            batch, jnp.asarray(model)[None], jnp.eye(3)[None], vp, zn, zf,
            ctx, w, h, model_name=name, use_tiled=False,
        )
        a = np.asarray(ldr)
        assert a.shape == (h, w, 3)
        assert np.isfinite(a.astype(np.float64)).all()
        cov = np.asarray(gb.covered)
        assert a[cov].std() > 0 or name == "debug_albedo", name


def test_gouraud_interpolates_corner_lighting():
    mesh = make_head_mesh()
    w, h = 64, 64
    model = np.eye(4, dtype=np.float32)
    vp, zn, zf = simple_camera(w, h, (0, 0, -3.0), (0, 0, 0))
    batch = {k: jnp.asarray(v) for k, v in concat_scene([mesh]).items()}
    mats = make_materials(base_color=[(0.8, 0.8, 0.8)])
    ctx = make_shade_context(mats, light_dir_ws=(0.3, -0.6, 0.7),
                             camera_pos=(0, 0, -3.0), light_intensity=2.0)
    ldr, gb = render_forward(
        batch, jnp.asarray(model)[None], jnp.eye(3)[None], vp, zn, zf,
        ctx, w, h, model_name="gouraud", use_tiled=False,
    )
    a = np.asarray(ldr)
    cov = np.asarray(gb.covered)
    assert a[cov].std() > 5.0  # lit with variation

    # Per-pixel phong differs from per-corner gouraud (highlights sharper).
    ldr_p, _ = render_forward(
        batch, jnp.asarray(model)[None], jnp.eye(3)[None], vp, zn, zf,
        ctx, w, h, model_name="phong", use_tiled=False,
    )
    assert (np.asarray(ldr_p) != a).any()
