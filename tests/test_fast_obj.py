"""Native OBJ loader parity with the Python parser (when built)."""

import numpy as np
import pytest

from lsr_tpu.io.fast_obj import load_obj_fast, native_available
from lsr_tpu.io.obj import load_obj
from lsr_tpu.resources.assets import make_head_mesh, write_obj

needs_native = pytest.mark.skipif(
    not native_available(), reason="native/libfastobj.so not built"
)


@pytest.fixture
def head_obj(tmp_path):
    """The seeded Suzanne stand-in as an OBJ file."""
    return write_obj(str(tmp_path / "head.obj"), make_head_mesh())


@needs_native
def test_monkey_matches_python_parser(head_obj):
    a = load_obj_fast(head_obj)
    b = load_obj(head_obj)
    assert a.num_vertices == b.num_vertices
    assert a.num_triangles == b.num_triangles
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.positions, b.positions, atol=0)
    np.testing.assert_allclose(a.uvs, b.uvs, atol=0)
    np.testing.assert_allclose(a.normals, b.normals, atol=1e-6)


@needs_native
def test_text_variants():
    text = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
f 1 2 3 4
f -1 -2 -3
"""
    a = load_obj_fast(text, from_text=True)
    b = load_obj(text, from_text=True)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.normals, b.normals, atol=1e-6)
    assert a.num_triangles == 3  # quad fan + one reversed-index tri


def test_fallback_without_native(monkeypatch, head_obj):
    import lsr_tpu.io.fast_obj as fo

    monkeypatch.setattr(fo, "_LIB", None)
    monkeypatch.setattr(fo, "_LIB_TRIED", True)
    m = fo.load_obj_fast(head_obj)
    assert m.num_triangles == 967
