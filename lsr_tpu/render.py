"""Convenience forward-render entry points (the minimal end-to-end slice).

A single jitted frame: geometry setup -> tiled raster -> G-buffer interp ->
shading model -> background composite -> tonemap.  This is the functional
equivalent of the reference's simple demo loop (vertex transform ->
rasterize_mesh -> PassTonemap); the full pluggable pass/pipeline framework
lives in lsr_tpu.pipeline.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.raster.brute import rasterize_brute
from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import scene_setup
from lsr_tpu.raster.tiled import rasterize_direct
from lsr_tpu.shading.models import SHADING_MODELS, composite_over_background
from lsr_tpu.passes.tonemap import tonemap_pass


def upload_mesh(mesh):
    """Host MeshData -> device arrays dict."""
    return dict(
        positions=jnp.asarray(mesh.positions),
        normals=jnp.asarray(mesh.normals),
        uvs=jnp.asarray(mesh.uvs),
        indices=jnp.asarray(mesh.indices),
    )


def morton_order(mesh) -> np.ndarray:
    """Triangle permutation sorting by Morton code of the centroid.

    The tiled rasterizer walks triangles in chunks with per-chunk bbox
    rejection (raster/tiled.py): spatially coherent chunks have tight bboxes
    and reject far more work.  OBJ face order is only loosely local; Morton
    order roughly halves mean chunk bbox area (measured on the monkey mesh).
    This permutes submission order —
    the first-wins depth tie rule then resolves ties in Morton order, which
    is an allowed submission order (the reference imposes none)."""
    cent = mesh.positions[mesh.indices].mean(axis=1)  # (T, 3)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = ((cent - lo) / span * 1023.0).astype(np.uint64)  # 10 bits per axis

    def spread(v):  # interleave with 2 zero bits (standard Morton spread)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable").astype(np.int64)


def concat_scene(meshes, object_of_mesh=None, spatial_sort=True):
    """Concatenate host meshes into one SoA batch with per-vertex object ids.

    meshes: list of MeshData; object_of_mesh: optional list of object indices
    (defaults to 0..len-1).  spatial_sort reorders each mesh's triangles into
    Morton order (see morton_order).  Returns dict of numpy arrays.
    """
    if object_of_mesh is None:
        object_of_mesh = list(range(len(meshes)))
    pos, nrm, uv, idx, vobj, tobj = [], [], [], [], [], []
    base = 0
    for mesh, obj in zip(meshes, object_of_mesh):
        pos.append(mesh.positions)
        nrm.append(mesh.normals)
        uv.append(mesh.uvs)
        tris = mesh.indices[morton_order(mesh)] if spatial_sort \
            else mesh.indices
        idx.append(tris + base)
        vobj.append(np.full(mesh.num_vertices, obj, np.int32))
        tobj.append(np.full(mesh.num_triangles, obj, np.int32))
        base += mesh.num_vertices
    return dict(
        positions=np.concatenate(pos).astype(np.float32),
        normals=np.concatenate(nrm).astype(np.float32),
        uvs=np.concatenate(uv).astype(np.float32),
        indices=np.concatenate(idx).astype(np.int32),
        vtx_obj=np.concatenate(vobj),
        tri_obj=np.concatenate(tobj),
    )


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "model_name", "use_tiled", "exposure", "gamma"),
)
def render_forward(
    batch,
    models,
    normal_mats,
    viewproj,
    zn,
    zf,
    shade_ctx,
    width: int,
    height: int,
    model_name: str = "blinn_phong",
    background=(0.05, 0.07, 0.12),
    use_tiled: bool = True,
    exposure: float = 1.0,
    gamma: float = 2.2,
):
    """One full forward frame.  Returns (ldr_u8 (H,W,3), gbuffer)."""
    setup = scene_setup(
        batch["positions"], batch["normals"], batch["uvs"], batch["indices"],
        batch["vtx_obj"], batch["tri_obj"],
        models, normal_mats, viewproj, width, height,
    )
    if use_tiled:
        depth, tid, _ = rasterize_direct(setup, width, height, zn, zf,
                                         spatial_sort=True)
    else:
        depth, tid = rasterize_brute(setup, width, height, zn, zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=shade_ctx.materials)
    if model_name == "gouraud":
        from lsr_tpu.shading.models import shade_gouraud

        shaded = shade_gouraud(setup, gb, shade_ctx)
    else:
        shaded = SHADING_MODELS[model_name](gb, shade_ctx)
    bg = jnp.broadcast_to(jnp.asarray(background, jnp.float32), shaded.shape)
    hdr = composite_over_background(shaded, gb, bg)
    ldr = tonemap_pass(hdr, exposure=exposure, gamma=gamma)
    return ldr, gb


def simple_camera(width, height, eye, target, fov=np.pi / 3, zn=0.1, zf=100.0, up=(0, 1, 0)):
    view = m3.look_at_lh(jnp.asarray(eye, jnp.float32),
                         jnp.asarray(target, jnp.float32),
                         jnp.asarray(up, jnp.float32))
    proj = m3.perspective_lh_no(fov, width / height, zn, zf)
    return proj @ view, jnp.float32(zn), jnp.float32(zf)
