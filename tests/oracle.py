"""Test oracle: direct numpy implementation of the reference rasterizer semantics.

Implements the *full* reference pipeline — 6-plane Sutherland-Hodgman clipping,
fan re-triangulation, sequential per-pixel z-test — as slow, obviously-correct
Python/numpy (mirroring rasterize_mesh, rasterizer.hpp:181-446).  Used only in
tests to validate the fast paths (which clip near-only + scissor, and
resolve depth by parallel reduction).
"""

from __future__ import annotations

import numpy as np


def _lerp_vtx(a, b, t):
    out = {k: a[k] + (b[k] - a[k]) * t for k in a}
    n = out["normal"]
    ln = np.linalg.norm(n)
    out["normal"] = n / max(ln, 1e-12)
    return out


def _clip_plane(poly, dist_fn):
    out = []
    if not poly:
        return out
    for i in range(len(poly)):
        cur = poly[i]
        nxt = poly[(i + 1) % len(poly)]
        da, db = dist_fn(cur), dist_fn(nxt)
        cin, nin = da >= 0.0, db >= 0.0
        if cin and nin:
            out.append(nxt)
        elif cin and not nin:
            den = da - db
            if abs(den) > 1e-8:
                out.append(_lerp_vtx(cur, nxt, da / den))
        elif not cin and nin:
            den = da - db
            if abs(den) > 1e-8:
                out.append(_lerp_vtx(cur, nxt, da / den))
            out.append(nxt)
    return out


def _clip_frustum(poly):
    planes = [
        lambda v: v["clip"][0] + v["clip"][3],
        lambda v: v["clip"][3] - v["clip"][0],
        lambda v: v["clip"][1] + v["clip"][3],
        lambda v: v["clip"][3] - v["clip"][1],
        lambda v: v["clip"][2] + v["clip"][3],
        lambda v: v["clip"][3] - v["clip"][2],
    ]
    for p in planes:
        poly = _clip_plane(poly, p)
    return poly


def _bary2d(p, a, b, c):
    v0 = b - a
    v1 = c - a
    v2 = p - a
    den = v0[0] * v1[1] - v1[0] * v0[1]
    if abs(den) < 1e-8:
        return np.array([-1.0, -1.0, -1.0])
    inv = 1.0 / den
    v = (v2[0] * v1[1] - v1[0] * v2[1]) * inv
    w = (v0[0] * v2[1] - v2[0] * v0[1]) * inv
    return np.array([1.0 - v - w, v, w])


def rasterize_oracle(
    positions,
    normals,
    uvs,
    indices,
    model,
    viewproj,
    width,
    height,
    zn,
    zf,
    cull_back=True,
    front_face_ccw=True,
):
    """Returns dict with depth (H,W), covered, world_pos, normal, uv planes."""
    model = np.asarray(model, np.float32)
    viewproj = np.asarray(viewproj, np.float32)
    m3 = model[:3, :3]
    det = np.linalg.det(m3)
    nm = np.linalg.inv(m3).T if abs(det) > 1e-8 else m3

    hom = np.concatenate([positions, np.ones((len(positions), 1), np.float32)], -1)
    world = (hom @ model.T)[:, :3]
    clip = np.concatenate([world, np.ones((len(world), 1), np.float32)], -1) @ viewproj.T
    n_ws = normals @ nm.T
    n_ws = n_ws / np.maximum(np.linalg.norm(n_ws, axis=-1, keepdims=True), 1e-12)

    depth = np.ones((height, width), np.float32)
    covered = np.zeros((height, width), bool)
    wp_buf = np.zeros((height, width, 3), np.float32)
    n_buf = np.zeros((height, width, 3), np.float32)
    uv_buf = np.zeros((height, width, 2), np.float32)

    def fully_inside(c):
        if not c[3] > 0:
            return False
        return (
            -c[3] <= c[0] <= c[3]
            and -c[3] <= c[1] <= c[3]
            and -c[3] <= c[2] <= c[3]
        )

    for tri in indices:
        verts = [
            {
                "clip": clip[i].astype(np.float64),
                "wp": world[i].astype(np.float64),
                "normal": n_ws[i].astype(np.float64),
                "uv": uvs[i].astype(np.float64),
            }
            for i in tri
        ]
        if not all(fully_inside(v["clip"]) for v in verts):
            verts = _clip_frustum(verts)
        if len(verts) < 3:
            continue
        for k in range(1, len(verts) - 1):
            vs = [verts[0], verts[k], verts[k + 1]]
            ndc = []
            bad = False
            for v in vs:
                n = v["clip"][:3] / v["clip"][3]
                if not np.all(np.isfinite(n)):
                    bad = True
                ndc.append(n)
            if bad:
                continue
            s = [
                np.array(
                    [
                        (n[0] * 0.5 + 0.5) * (width - 1),
                        (n[1] * 0.5 + 0.5) * (height - 1),
                    ]
                )
                for n in ndc
            ]
            e0 = s[1] - s[0]
            e1 = s[2] - s[0]
            area2 = e0[0] * e1[1] - e0[1] * e1[0]
            if abs(area2) < 1e-10:
                continue
            is_front = (area2 > 0) == front_face_ccw
            if cull_back and not is_front:
                continue
            x0 = max(0, int(np.floor(min(p[0] for p in s))))
            x1 = min(width - 1, int(np.ceil(max(p[0] for p in s))))
            y0 = max(0, int(np.floor(min(p[1] for p in s))))
            y1 = min(height - 1, int(np.ceil(max(p[1] for p in s))))
            if x0 > x1 or y0 > y1:
                continue
            iw = [1.0 / v["clip"][3] for v in vs]
            for y in range(y0, y1 + 1):
                for x in range(x0, x1 + 1):
                    p = np.array([x + 0.5, y + 0.5])
                    bc = _bary2d(p, s[0], s[1], s[2])
                    if bc[0] < 0 or bc[1] < 0 or bc[2] < 0:
                        continue
                    den = bc[0] * iw[0] + bc[1] * iw[1] + bc[2] * iw[2]
                    if den <= 1e-10:
                        continue
                    view_z = 1.0 / den
                    z01 = np.clip((view_z - zn) / (zf - zn), 0.0, 1.0)
                    if z01 >= depth[y, x]:
                        continue
                    depth[y, x] = z01
                    covered[y, x] = True
                    wgt = bc * iw / den
                    wp_buf[y, x] = sum(wgt[i] * vs[i]["wp"] for i in range(3))
                    nn = sum(wgt[i] * vs[i]["normal"] for i in range(3))
                    n_buf[y, x] = nn / max(np.linalg.norm(nn), 1e-12)
                    uv_buf[y, x] = sum(wgt[i] * vs[i]["uv"] for i in range(3))

    return {
        "depth": depth,
        "covered": covered,
        "world_pos": wp_buf,
        "normal": n_buf,
        "uv": uv_buf,
    }
