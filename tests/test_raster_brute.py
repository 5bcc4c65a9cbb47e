"""Triangle rasterizer correctness: XLA brute path vs reference-semantics oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_cube
from lsr_tpu.raster.brute import rasterize_brute
from lsr_tpu.raster.interp import interpolate_gbuffer
from lsr_tpu.raster.setup import scene_setup
from lsr_tpu.resources.assets import make_head_mesh

from tests.oracle import rasterize_oracle


def _camera(width, height, eye=(0.0, 0.0, -3.0), target=(0.0, 0.0, 0.0), fov=np.pi / 3):
    view = m3.look_at_lh(jnp.array(eye), jnp.array(target), jnp.array([0.0, 1.0, 0.0]))
    proj = m3.perspective_lh_no(fov, width / height, 0.1, 100.0)
    return np.asarray(proj @ view)


def _run_pair(mesh, model, width, height, eye=(0.0, 0.0, -3.0)):
    zn, zf = 0.1, 100.0
    vp = _camera(width, height, eye)
    setup = scene_setup(
        jnp.asarray(mesh.positions),
        jnp.asarray(mesh.normals),
        jnp.asarray(mesh.uvs),
        jnp.asarray(mesh.indices),
        jnp.zeros(mesh.num_vertices, jnp.int32),
        jnp.zeros(mesh.num_triangles, jnp.int32),
        jnp.asarray(model)[None],
        np.asarray(m3.normal_matrix(jnp.asarray(model)))[None],
        jnp.asarray(vp),
        width,
        height,
    )
    depth, tid = rasterize_brute(setup, width, height, zn, zf)
    gb = interpolate_gbuffer(setup, depth, tid)
    oracle = rasterize_oracle(
        mesh.positions, mesh.normals, mesh.uvs, mesh.indices,
        model, vp, width, height, zn, zf,
    )
    return gb, oracle


def _compare(gb, oracle, cov_tol=0.005, depth_tol=2e-3, attr_tol=2e-2):
    ours_cov = np.asarray(gb.covered)
    ref_cov = oracle["covered"]
    assert ref_cov.sum() > 200, "oracle drew almost nothing — bad test setup"
    h, w = ref_cov.shape
    disagree = (ours_cov != ref_cov).sum()
    assert disagree <= cov_tol * h * w, f"coverage disagrees on {disagree} px"

    both = ours_cov & ref_cov
    d_ours = np.asarray(gb.depth01)
    dd = np.abs(d_ours[both] - oracle["depth"][both])
    assert np.quantile(dd, 0.999) < depth_tol, f"depth diff q999={np.quantile(dd,0.999)}"

    for key, plane in (("world_pos", gb.world_pos), ("normal", gb.normal_ws), ("uv", gb.uv)):
        a = np.asarray(plane)[both]
        b = oracle[key][both]
        err = np.abs(a - b).max(axis=-1)
        assert np.quantile(err, 0.995) < attr_tol, f"{key} q995={np.quantile(err,0.995)}"


def test_monkey_depth_and_attrs_match_oracle():
    mesh = make_head_mesh()
    model = np.asarray(m3.rotate_y(0.4))
    gb, oracle = _run_pair(mesh, model, 96, 96)
    _compare(gb, oracle)


def test_cube_near_clip():
    # Camera inside the scene so the cube pierces the near plane.
    mesh = make_cube(4.0)
    model = np.asarray(m3.translate([0.0, 0.0, 1.0]) @ m3.rotate_y(0.7) @ m3.rotate_x(0.3))
    gb, oracle = _run_pair(mesh, model, 80, 80, eye=(0.0, 0.0, -1.0))
    _compare(gb, oracle, cov_tol=0.01)


def test_depth_ordering_two_quads():
    # Two overlapping quads: nearer one must win everywhere they overlap.
    from lsr_tpu.io.obj import MeshData

    def quad(z):
        pos = np.array(
            [[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32
        )
        nrm = np.tile([[0, 0, -1]], (4, 1)).astype(np.float32)
        uv = np.zeros((4, 2), np.float32)
        # CCW in screen space (seen from -Z with +Y up) = front-facing.
        idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        return pos, nrm, uv, idx

    p1, n1, u1, i1 = quad(2.0)
    p2, n2, u2, i2 = quad(5.0)
    mesh = MeshData(
        np.concatenate([p1, p2]),
        np.concatenate([n1, n2]),
        np.concatenate([u1, u2]),
        np.concatenate([i1, i2 + 4]),
    )
    gb, oracle = _run_pair(mesh, np.eye(4, dtype=np.float32), 64, 64)
    _compare(gb, oracle)
    # The near quad is at view_z≈5 from eye(0,0,-3): z01 = (5-0.1)/99.9
    center = np.asarray(gb.depth01)[32, 32]
    assert abs(center - (5.0 - 0.1) / 99.9) < 1e-3


@pytest.mark.parametrize("cull,expect_any", [(1, True), (2, False)])
def test_backface_cull_modes(cull, expect_any):
    # A single front-facing triangle: visible with Back culling,
    # culled with Front culling.
    from lsr_tpu.io.obj import MeshData
    from lsr_tpu.raster.setup import scene_setup as ss

    pos = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
    mesh = MeshData(pos, np.tile([[0, 0, -1.0]], (3, 1)).astype(np.float32),
                    np.zeros((3, 2), np.float32), np.array([[0, 1, 2]], np.int32))
    width = height = 32
    vp = _camera(width, height)
    setup = ss(
        jnp.asarray(mesh.positions), jnp.asarray(mesh.normals), jnp.asarray(mesh.uvs),
        jnp.asarray(mesh.indices), jnp.zeros(3, jnp.int32), jnp.zeros(1, jnp.int32),
        jnp.eye(4)[None], jnp.eye(3)[None], jnp.asarray(vp),
        width, height, cull_mode=cull,
    )
    depth, tid = rasterize_brute(setup, width, height, 0.1, 100.0)
    assert (np.asarray(tid) >= 0).any() == expect_any
