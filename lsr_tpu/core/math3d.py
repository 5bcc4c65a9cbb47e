"""Left-handed 3D math kernel (conventions: LH, +Y up, +Z forward, NDC z in [-1,1]).

Mirrors the semantics the reference gets from GLM (`glm::perspectiveLH_NO`,
`glm::lookAtLH`, `glm::orthoLH_NO`; see the reference's docs/spec/conventions.md
and shs-renderer-lib usage), expressed as row-major matrices acting on column
vectors: ``clip = M @ [x, y, z, 1]^T``.  Batched point transforms are written as
``pts_h @ M.T`` so they lower to one matmul.

All functions accept/return jnp arrays and are jit/vmap-safe unless noted.
"""

from __future__ import annotations

import jax.numpy as jnp


def normalize(v, eps: float = 1e-12):
    """Normalize along the last axis (safe: returns v/eps-guarded norm)."""
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, eps)


# ---------------------------------------------------------------------------
# Projection / view matrices
# ---------------------------------------------------------------------------

def perspective_lh_no(fovy, aspect, znear, zfar):
    """Left-handed perspective, NDC z in [-1, 1] (glm::perspectiveLH_NO).

    Row-major, column-vector convention:
      x' = x / (aspect * tan(fovy/2))
      y' = y / tan(fovy/2)
      z' = ((zf+zn) z - 2 zf zn) / (zf - zn)
      w' = +z      (LH: +Z forward maps to positive w)
    """
    fovy = jnp.asarray(fovy, jnp.float32)
    t = jnp.tan(fovy * 0.5)
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(1.0 / (aspect * t))
    m = m.at[1, 1].set(1.0 / t)
    m = m.at[2, 2].set((zfar + znear) / (zfar - znear))
    m = m.at[2, 3].set(-(2.0 * zfar * znear) / (zfar - znear))
    m = m.at[3, 2].set(1.0)
    return m


def ortho_lh_no(left, right, bottom, top, znear, zfar):
    """Left-handed orthographic, NDC z in [-1, 1] (glm::orthoLH_NO)."""
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, 0].set(2.0 / (right - left))
    m = m.at[1, 1].set(2.0 / (top - bottom))
    m = m.at[2, 2].set(2.0 / (zfar - znear))
    m = m.at[0, 3].set(-(right + left) / (right - left))
    m = m.at[1, 3].set(-(top + bottom) / (top - bottom))
    m = m.at[2, 3].set(-(zfar + znear) / (zfar - znear))
    return m


def look_at_lh(eye, center, up):
    """Left-handed look-at view matrix (glm::lookAtLH)."""
    eye = jnp.asarray(eye, jnp.float32)
    center = jnp.asarray(center, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    f = normalize(center - eye)              # forward (+Z view axis)
    s = normalize(jnp.cross(up, f))          # right
    u = jnp.cross(f, s)                      # true up
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, :3].set(s)
    m = m.at[1, :3].set(u)
    m = m.at[2, :3].set(f)
    m = m.at[0, 3].set(-jnp.dot(s, eye))
    m = m.at[1, 3].set(-jnp.dot(u, eye))
    m = m.at[2, 3].set(-jnp.dot(f, eye))
    return m


# ---------------------------------------------------------------------------
# Affine model transforms
# ---------------------------------------------------------------------------

def translate(t):
    t = jnp.asarray(t, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(t)


def scale(s):
    s = jnp.broadcast_to(jnp.asarray(s, jnp.float32), (3,))
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[jnp.arange(3), jnp.arange(3)].set(s)


def rotate_axis_angle(axis, angle):
    """Rotation about a (normalized) axis by angle (radians), like glm::rotate."""
    axis = normalize(jnp.asarray(axis, jnp.float32))
    x, y, z = axis[0], axis[1], axis[2]
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    ic = 1.0 - c
    r = jnp.array(
        [
            [c + x * x * ic, x * y * ic - z * s, x * z * ic + y * s],
            [y * x * ic + z * s, c + y * y * ic, y * z * ic - x * s],
            [z * x * ic - y * s, z * y * ic + x * s, c + z * z * ic],
        ],
        jnp.float32,
    )
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, :3].set(r)


def rotate_x(a):
    return rotate_axis_angle(jnp.array([1.0, 0.0, 0.0]), a)


def rotate_y(a):
    return rotate_axis_angle(jnp.array([0.0, 1.0, 0.0]), a)


def rotate_z(a):
    return rotate_axis_angle(jnp.array([0.0, 0.0, 1.0]), a)


def compose_trs(translation, rotation, scale_v):
    """Model matrix = T * R * S (rotation: 4x4 or 3x3 rotation matrix)."""
    rotation = jnp.asarray(rotation, jnp.float32)
    if rotation.shape == (3, 3):
        r4 = jnp.eye(4, dtype=jnp.float32).at[:3, :3].set(rotation)
    else:
        r4 = rotation
    return translate(translation) @ r4 @ scale(scale_v)


def euler_xyz(rx, ry, rz):
    """R = Rz @ Ry @ Rx (matching successive glm::rotate Z,Y,X application)."""
    return rotate_z(rz) @ rotate_y(ry) @ rotate_x(rx)


# ---------------------------------------------------------------------------
# Batched transforms
# ---------------------------------------------------------------------------

def transform_points_h(m, pts):
    """(..., N, 3) points -> homogeneous (..., N, 4) via clip = M @ [p,1]."""
    pts = jnp.asarray(pts, jnp.float32)
    ones = jnp.ones(pts.shape[:-1] + (1,), pts.dtype)
    hom = jnp.concatenate([pts, ones], axis=-1)
    return hom @ m.T


def transform_points(m, pts):
    """Affine transform of (..., N, 3) points; drops w (assumes affine m)."""
    return transform_points_h(m, pts)[..., :3]


def transform_dirs(m, dirs):
    """Transform direction vectors by the upper-left 3x3 of m."""
    return jnp.asarray(dirs, jnp.float32) @ m[:3, :3].T


def normal_matrix(model):
    """Inverse-transpose of the upper-left 3x3, with degenerate-det guard.

    Mirrors make_default_vertex_out (builtin_shaders.hpp:92-99): if
    |det| <= 1e-8 the raw 3x3 is used unchanged.
    """
    m3 = model[:3, :3]
    det = jnp.linalg.det(m3)
    safe = jnp.abs(det) > 1e-8
    inv_t = jnp.linalg.inv(jnp.where(safe, m3, jnp.eye(3, dtype=m3.dtype))).T
    return jnp.where(safe, inv_t, m3)


def project_to_ndc(clip, eps: float = 1e-12):
    """Perspective divide: (..., 4) clip -> (..., 3) NDC with w-guard."""
    w = clip[..., 3:4]
    w = jnp.where(jnp.abs(w) < eps, jnp.where(w < 0, -eps, eps), w)
    return clip[..., :3] / w


def ndc_to_screen(ndc_xy, width, height):
    """NDC [-1,1] -> canvas pixel coords, bottom-left origin.

    Matches rasterizer.hpp:267-269: s = (ndc*0.5+0.5) * (W-1, H-1).
    """
    wh = jnp.array([width - 1, height - 1], jnp.float32)
    return (ndc_xy * 0.5 + 0.5) * wh


def reflect(i, n):
    """GLM reflect: i - 2*dot(n,i)*n (i points toward the surface)."""
    return i - 2.0 * jnp.sum(n * i, axis=-1, keepdims=True) * n
