"""Seeded scene assets: a head mesh in place of Suzanne, a water skybox, and
the instanced scenes built from them.

Every asset is generated from a seed at run time; nothing is read from
outside the checkout.

- `make_head_mesh` is the Suzanne stand-in: the reference scenes' monkey has
  967 triangles, and so does this mesh.  A closed triangle mesh always has an
  even number of faces, so the head is a closed, deformed UV sphere of 966
  triangles (eye sockets, brow, snout and two ears give it concavity and
  self-occlusion) plus one open "tuft" triangle on top.
- `skybox_faces` / `write_skybox` bake the procedural sky into the six
  cubemap faces the reference's water_scene skybox provides: sky above,
  water-coloured below, continuous across face seams.
- `instanced_grid_scene` lays out grid x grid copies of a mesh (the bench and
  high-poly scenes).
"""

from __future__ import annotations

import os

import numpy as np

from lsr_tpu.io.obj import MeshData, compute_vertex_normals

HEAD_TRIANGLES = 967
_SECTORS = 23   # 2 * 23 * (22 - 1) = 966 closed-body triangles
_RINGS = 22

WATER_COLOR = (0.05, 0.24, 0.32)
# Light direction (toward the scene) of the skybox's sun: the disk sits on
# the +X face, so no two faces are mirror images.
SKY_SUN_DIR = (-0.80, -0.45, -0.25)


def _bump(d, center, width):
    """Gaussian bump on the unit sphere around direction `center`."""
    c = np.asarray(center, np.float64)
    c = c / np.linalg.norm(c)
    ang = np.arccos(np.clip(d @ c, -1.0, 1.0))
    return np.exp(-(ang / width) ** 2)


def make_head_mesh(seed: int = 0) -> MeshData:
    """Closed non-convex head mesh plus one tuft triangle: 967 triangles.

    The face looks down -Z (toward a camera at z < 0, as the monkey does in
    the reference scenes).  Winding is CCW seen from outside (the loaders'
    convention), and normals are smooth area-weighted vertex normals."""
    rng = np.random.default_rng(seed)
    jit = lambda s: rng.uniform(-s, s)  # noqa: E731
    theta = np.linspace(0.0, np.pi, _RINGS + 1)[1:-1]          # interior rings
    phi = np.linspace(0.0, 2.0 * np.pi, _SECTORS + 1)           # seam repeated
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                  np.sin(tt) * np.sin(pp)], -1)                 # (R-1, S+1, 3)
    poles = np.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])

    def radius(u):
        r = 1.0 + 0.08 * u[..., 1]
        for sx in (-1.0, 1.0):
            r -= (0.30 + jit(0.04)) * _bump(
                u, (0.36 * sx + jit(0.03), 0.28 + jit(0.03), -0.89), 0.24)
            r += (0.55 + jit(0.05)) * _bump(u, (sx, 0.15, 0.05), 0.22)
        r += 0.22 * _bump(u, (0.0, -0.30 + jit(0.03), -0.95), 0.35)
        r += 0.10 * _bump(u, (0.0, 0.45, -0.89), 0.20)
        return 0.95 * r

    ring_pos = d * radius(d)[..., None]
    pole_pos = poles * radius(poles)[..., None]

    stride = _SECTORS + 1
    top, bottom = 0, 1
    base = 2
    positions = np.concatenate([pole_pos, ring_pos.reshape(-1, 3)])
    uvs = np.concatenate([
        np.array([[0.5, 1.0], [0.5, 0.0]]),
        np.stack([pp / (2.0 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2),
    ])

    def vid(ring, sector):
        return base + ring * stride + sector

    tris = []
    n_rings = len(theta)
    for j in range(_SECTORS):
        tris.append((top, vid(0, j), vid(0, j + 1)))
        for r in range(n_rings - 1):
            a, b = vid(r, j), vid(r, j + 1)
            c, e = vid(r + 1, j), vid(r + 1, j + 1)
            tris.append((a, e, b))
            tris.append((a, c, e))
        tris.append((bottom, vid(n_rings - 1, j + 1), vid(n_rings - 1, j)))

    # The open tuft: one triangle standing on the crown.
    t0 = len(positions)
    tuft = np.array([[-0.10, 1.00, 0.00], [0.12, 1.00, 0.02],
                     [0.02 + jit(0.03), 1.32, 0.06]])
    positions = np.concatenate([positions, tuft])
    uvs = np.concatenate([uvs, [[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]]])
    tris.append((t0, t0 + 1, t0 + 2))

    pos = positions.astype(np.float32)
    idx = np.asarray(tris, np.int32)
    assert idx.shape[0] == HEAD_TRIANGLES
    # compute_vertex_normals' cross product points into CCW-front faces;
    # negate it for outward normals.
    return MeshData(positions=pos, normals=-compute_vertex_normals(pos, idx),
                    uvs=uvs.astype(np.float32), indices=idx)


def mesh_obj_text(mesh: MeshData) -> str:
    """Wavefront OBJ text of a mesh (one v/vt/vn triplet per vertex)."""
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.positions]
    lines += [f"vt {u:.9g} {v:.9g}" for u, v in mesh.uvs]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.normals]
    lines += ["f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in tri)
              for tri in mesh.indices]
    return "\n".join(lines) + "\n"


def write_obj(path: str, mesh: MeshData) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write(mesh_obj_text(mesh))
    return path


def skybox_faces(size: int = 256, sun_dir_ws=SKY_SUN_DIR):
    """(6, S, S, 3) linear water-scene cubemap baked from the procedural sky
    ([+X, -X, +Y, -Y, +Z, -Z], row 0 = v 0, sample_cubemap's layout)."""
    from lsr_tpu.sky.sky_models import procedural_sky_cubemap

    faces = procedural_sky_cubemap(size, sun_dir_ws=sun_dir_ws,
                                   ground=WATER_COLOR)
    return np.clip(np.asarray(faces, np.float32), 0.0, 1.0)


def write_skybox(directory: str, size: int = 256) -> str:
    """Write the six faces as sRGB PNGs under the reference's file names
    (right/left/top/bottom/front/back.png), in the row order
    resources.cubemap.load_cubemap reads back."""
    from lsr_tpu.io.png import write_png
    from lsr_tpu.resources.cubemap import FACE_FILES

    os.makedirs(directory, exist_ok=True)
    lin = skybox_faces(size)
    srgb = np.where(lin <= 0.0031308, lin * 12.92,
                    1.055 * np.power(lin, 1.0 / 2.4) - 0.055)
    img = np.round(np.clip(srgb, 0.0, 1.0) * 255.0).astype(np.uint8)
    for name, face in zip(FACE_FILES, img):
        write_png(os.path.join(directory, f"{name}.png"), face[::-1])
    return directory


def instanced_grid_scene(mesh: MeshData, grid: int, spacing: float,
                         seed: int, ground: float | None = None):
    """grid x grid copies of `mesh`, randomly yawed, materials 0..3 in turn;
    an optional ground plane of half-extent `ground` (material 4, casts no
    shadow).  Returns (SceneGeometry, SceneObjects)."""
    from lsr_tpu.core import math3d as m3
    from lsr_tpu.io.obj import make_plane
    from lsr_tpu.scene.scene import SceneBuilder

    rng = np.random.default_rng(seed)
    sb = SceneBuilder()
    for i in range(grid * grid):
        x = (i % grid - grid // 2) * spacing
        z = (i // grid - grid // 2) * spacing
        rot = float(rng.uniform(0, 2 * np.pi))
        sb.add(mesh, np.asarray(m3.translate([x, 0.0, z]) @ m3.rotate_y(rot)),
               material=i % 4)
    if ground is not None:
        sb.add(make_plane(ground, y=-1.0), material=4, casts_shadow=False)
    return sb.build()
