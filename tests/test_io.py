"""PNG round-trip and OBJ parser tests."""

import numpy as np

from lsr_tpu.io.obj import load_obj, make_cube, make_plane, make_uv_sphere
from lsr_tpu.io.png import read_png, save_canvas_png, write_png
from lsr_tpu.resources.assets import HEAD_TRIANGLES, make_head_mesh, write_obj


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    write_png(p, img)
    back = read_png(p)
    assert np.array_equal(img, back)


def test_canvas_png_flips(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    img[0, 0] = [255, 0, 0]  # bottom-left of canvas
    p = str(tmp_path / "c.png")
    save_canvas_png(p, img)
    back = read_png(p)
    assert np.array_equal(back[3, 0], [255, 0, 0])  # bottom row of file


def test_obj_text_parse():
    text = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
vt 0 0
vn 0 0 -1
f 1/1/1 2/1/1 3/1/1 4/1/1
"""
    mesh = load_obj(text, from_text=True)
    assert mesh.num_triangles == 2  # quad fan-triangulated
    assert mesh.num_vertices == 4
    assert np.allclose(mesh.normals[0], [0, 0, -1])


def test_monkey_loads(tmp_path):
    # The seeded Suzanne stand-in, written to OBJ and parsed back.
    gen = make_head_mesh()
    mesh = load_obj(write_obj(str(tmp_path / "head.obj"), gen))
    # 967 'f' records, all triangles, as in the reference's monkey.
    assert mesh.num_triangles == HEAD_TRIANGLES == 967
    assert mesh.num_vertices == gen.num_vertices
    # The parser renumbers vertices in first-use order: compare corners.
    np.testing.assert_array_equal(mesh.positions[mesh.indices],
                                  gen.positions[gen.indices])
    assert mesh.positions.shape[1] == 3
    assert mesh.uvs.shape[0] == mesh.positions.shape[0]
    assert np.all(mesh.indices < mesh.num_vertices)
    # Monkey-sized: fits in roughly [-1.5, 1.5]
    assert np.abs(mesh.positions).max() < 2.0
    # normals are unit length
    lens = np.linalg.norm(mesh.normals, axis=-1)
    assert np.allclose(lens, 1.0, atol=1e-3)


def test_primitives():
    for mesh in (make_plane(2.0), make_cube(), make_uv_sphere(rings=4, sectors=6)):
        assert mesh.indices.max() < mesh.num_vertices
        assert np.isfinite(mesh.positions).all()
