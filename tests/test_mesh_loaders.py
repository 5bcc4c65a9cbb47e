"""General mesh loading (glTF 2.0 / STL / dispatcher): the Assimp-surface
parity tests (resources/loaders/mesh_loader_assimp.hpp:42-110 semantics:
triangulated indexed output, generated normals, zero-UV fallback)."""

import base64
import json
import struct

import numpy as np

from lsr_tpu.io.gltf import load_gltf, load_gltf_meshes
from lsr_tpu.io.mesh_loader import load_mesh, load_meshes
from lsr_tpu.io.stl import load_stl

# A unit right triangle + its mirror: 4 verts, 2 tris.
_POS = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
_IDX = np.asarray([[0, 1, 2], [2, 1, 3]], np.uint16)
_UV = _POS[:, :2].copy()


def _gltf_doc(with_normals=False, with_uvs=True, use_stride=False):
    pos = _POS.tobytes()
    idx = _IDX.tobytes()
    uv = _UV.tobytes()
    blobs = [(pos, "VEC3", 5126, len(_POS)), (idx, "SCALAR", 5123, _IDX.size)]
    if with_uvs:
        blobs.append((uv, "VEC2", 5126, len(_UV)))
    if with_normals:
        nrm = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1)).tobytes()
        blobs.append((nrm, "VEC3", 5126, 4))
    buf = b"".join(b for b, *_ in blobs)
    views, accessors, off = [], [], 0
    for b, typ, comp, count in blobs:
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(b)})
        accessors.append({"bufferView": len(views) - 1, "componentType": comp,
                          "count": count, "type": typ})
        off += len(b)
    attrs = {"POSITION": 0}
    if with_uvs:
        attrs["TEXCOORD_0"] = 2
    if with_normals:
        attrs["NORMAL"] = len(accessors) - 1
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
        "bufferViews": views, "accessors": accessors,
        "meshes": [{"primitives": [{"attributes": attrs, "indices": 1}]}],
    }
    return doc, buf


def test_gltf_json_data_uri(tmp_path):
    doc, _ = _gltf_doc(with_uvs=True)
    p = tmp_path / "tri.gltf"
    p.write_text(json.dumps(doc))
    m = load_gltf(str(p))
    assert m.num_vertices == 4 and m.num_triangles == 2
    np.testing.assert_array_equal(m.indices, _IDX.astype(np.int32))
    np.testing.assert_allclose(m.uvs, _UV)
    # Generated smooth normals for the flat quad point +Z.
    np.testing.assert_allclose(m.normals, [[0, 0, 1]] * 4, atol=1e-6)


def test_glb_container(tmp_path):
    doc, buf = _gltf_doc(with_normals=True)
    # Move the buffer into the GLB BIN chunk.
    doc["buffers"] = [{"byteLength": len(buf)}]
    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    bin_c = buf + b"\0" * ((4 - len(buf) % 4) % 4)
    glb = (b"glTF" + struct.pack("<II", 2, 12 + 8 + len(js) + 8 + len(bin_c))
           + struct.pack("<II", len(js), 0x4E4F534A) + js
           + struct.pack("<II", len(bin_c), 0x004E4942) + bin_c)
    p = tmp_path / "tri.glb"
    p.write_bytes(glb)
    ms = load_gltf_meshes(str(p))
    assert len(ms) == 1
    np.testing.assert_allclose(ms[0].positions, _POS)
    np.testing.assert_allclose(ms[0].normals, [[0, 0, 1]] * 4)


def test_stl_binary_and_ascii(tmp_path):
    tris = _POS[_IDX.astype(int)]                    # (2, 3, 3)
    # Binary: 80-byte header, count, 50-byte records.
    rec = b""
    for t in tris:
        rec += struct.pack("<3f", 0, 0, 1)
        for c in t:
            rec += struct.pack("<3f", *c)
        rec += b"\0\0"
    p = tmp_path / "tri.stl"
    p.write_bytes(b"\0" * 80 + struct.pack("<I", len(tris)) + rec)
    m = load_stl(str(p))
    assert m.num_triangles == 2
    assert m.num_vertices == 4                       # corners welded
    np.testing.assert_allclose(
        np.sort(m.positions, axis=0), np.sort(_POS, axis=0))

    lines = ["solid t"]
    for t in tris:
        lines += ["facet normal 0 0 1", "outer loop"]
        lines += [f"vertex {c[0]} {c[1]} {c[2]}" for c in t]
        lines += ["endloop", "endfacet"]
    lines.append("endsolid t")
    p2 = tmp_path / "tri_ascii.stl"
    p2.write_text("\n".join(lines))
    m2 = load_stl(str(p2))
    assert m2.num_triangles == 2 and m2.num_vertices == 4


def test_dispatcher_formats(tmp_path):
    doc, _ = _gltf_doc()
    p = tmp_path / "x.gltf"
    p.write_text(json.dumps(doc))
    assert load_mesh(str(p)).num_triangles == 2
    assert len(load_meshes(str(p))) == 1
    # An OBJ goes through the dispatcher too (the seeded monkey stand-in).
    from lsr_tpu.resources.assets import make_head_mesh, write_obj

    m = load_mesh(write_obj(str(tmp_path / "head.obj"), make_head_mesh()))
    assert m.num_triangles > 400
    try:
        load_mesh(str(tmp_path / "x.dae"))
        raise AssertionError("expected ValueError")
    except ValueError:
        pass


def test_gltf_renders_through_pipeline(tmp_path):
    """A glTF mesh rasterizes end-to-end (SceneBuilder -> raster)."""
    import jax.numpy as jnp

    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct
    from lsr_tpu.scene.scene import SceneBuilder, make_camera

    doc, _ = _gltf_doc()
    p = tmp_path / "tri.gltf"
    p.write_text(json.dumps(doc))
    mesh = load_mesh(str(p))
    sb = SceneBuilder()
    sb.add(mesh, np.eye(4, dtype=np.float32))
    geom, objects = sb.build()
    w, h = 64, 64
    cam = make_camera(w, h, (0.5, 0.5, -2.0), (0.5, 0.5, 0.0))
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices,
        geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
        cam.viewproj, w, h)
    depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf)
    assert int(jnp.sum(tid >= 0)) > 200
