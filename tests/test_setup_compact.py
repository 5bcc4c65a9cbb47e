"""scene_setup_compact must reproduce scene_setup's raster output exactly.

The compact front-end (VERDICT r5 item 6: the 1M-tri frame is
setup-dominated) culls+compacts before the wide gathers; its contract is
bit-identical coverage/depth/attributes to the full path on tie-free
scenes (z-tie ORDER between a clipped and an unclipped triangle is the
one documented deviation class).
"""

import jax.numpy as jnp
import numpy as np

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_cube
from lsr_tpu.raster.brute import rasterize_brute
from lsr_tpu.raster.setup import scene_setup, scene_setup_compact
from lsr_tpu.resources.assets import make_head_mesh


def _geom(mesh):
    return (
        jnp.asarray(mesh.positions),
        jnp.asarray(mesh.normals),
        jnp.asarray(mesh.uvs),
        jnp.asarray(mesh.indices),
        jnp.zeros(mesh.num_vertices, jnp.int32),
        jnp.zeros(mesh.num_triangles, jnp.int32),
    )


def _vp(eye_z=-3.0):
    return jnp.asarray(np.asarray(
        m3.perspective_lh_no(np.pi / 3, 160 / 96, 0.1, 100.0)
        @ m3.look_at_lh(
            jnp.array([0.0, 0.0, eye_z]), jnp.array([0.0, 0.0, 0.0]),
            jnp.array([0.0, 1.0, 0.0]),
        )
    ))


def _compare(mesh, model, vp, w=160, h=96, obj_visible=None, **kw):
    args = _geom(mesh) + (
        jnp.asarray(np.asarray(model))[None],
        np.asarray(m3.normal_matrix(jnp.asarray(np.asarray(model))))[None],
        vp, w, h,
    )
    full = scene_setup(*args, obj_visible=obj_visible)
    comp, stats = scene_setup_compact(*args, obj_visible=obj_visible, **kw)
    assert not bool(stats.overflow)
    d_f, t_f = rasterize_brute(full, w, h, 0.1, 100.0)
    d_c, t_c = rasterize_brute(comp, w, h, 0.1, 100.0)
    # Depth must be bit-exact; tids renumber, so compare through the
    # per-pixel object id (and coverage) instead.
    assert jnp.array_equal(d_f, d_c), (
        np.abs(np.asarray(d_f) - np.asarray(d_c)).max())
    cov_f, cov_c = t_f >= 0, t_c >= 0
    assert jnp.array_equal(cov_f, cov_c)
    obj_f = jnp.where(cov_f, full.obj_id[t_f], -1)
    obj_c = jnp.where(cov_c, comp.obj_id[t_c], -1)
    assert jnp.array_equal(obj_f, obj_c)
    # Attributes of covered pixels must match: fetch per-corner records of
    # the winning rows and compare (rotation/renumbering-proof: compare
    # the interpolated value at the pixel's barycentric position).
    ys, xs = jnp.mgrid[0:h, 0:w]
    px = xs.astype(jnp.float32) + 0.5
    py = ys.astype(jnp.float32) + 0.5

    def interp(setup, tid):
        c = setup.coef[tid]                       # (H, W, 9)
        bc = jnp.stack([
            c[..., 0] * px + c[..., 1] * py + c[..., 2],
            c[..., 3] * px + c[..., 4] * py + c[..., 5],
            c[..., 6] * px + c[..., 7] * py + c[..., 8],
        ], -1)
        iw = jnp.sum(bc * setup.iw[tid], -1)
        pw = jnp.sum(bc[..., None] * setup.iw[tid][..., None]
                     * setup.wp[tid], -2) / iw[..., None]
        return pw

    wp_f = jnp.where(cov_f[..., None], interp(full, t_f), 0.0)
    wp_c = jnp.where(cov_c[..., None], interp(comp, t_c), 0.0)
    np.testing.assert_allclose(np.asarray(wp_f), np.asarray(wp_c),
                               rtol=0, atol=0)
    return stats


def test_compact_matches_full_monkey():
    mesh = make_head_mesh()
    stats = _compare(mesh, m3.rotate_y(0.5), _vp())
    # The monkey at this view: roughly half the triangles are backfacing,
    # none cross the near plane.
    assert int(stats.n_clip) == 0
    assert 0 < int(stats.n_direct) < mesh.num_triangles


def test_compact_matches_full_near_clip():
    mesh = make_cube(2.0)
    # Camera inside the cube: faces cross the near plane -> clip side path.
    stats = _compare(mesh, m3.translate([0.0, 0.0, -2.2]), _vp(),
                     cull_mode=0)
    assert int(stats.n_clip) > 0


def test_compact_obj_visible_mask():
    mesh = make_head_mesh()
    stats = _compare(mesh, m3.rotate_y(0.5), _vp(),
                     obj_visible=jnp.array([False]))
    assert int(stats.n_direct) == 0 and int(stats.n_clip) == 0


def test_compact_overflow_flag():
    mesh = make_head_mesh()
    args = _geom(mesh) + (
        jnp.asarray(np.asarray(m3.rotate_y(0.5)))[None],
        np.asarray(m3.normal_matrix(jnp.asarray(
            np.asarray(m3.rotate_y(0.5)))))[None],
        _vp(), 160, 96,
    )
    _, stats = scene_setup_compact(*args, cap_fraction=0.01)
    assert bool(stats.overflow)


def test_pipeline_compact_route_bit_exact():
    """The production raster pass's density switch (FrameParams.
    compact_setup_threshold) must not change the image: run the
    forward_plus preset with the threshold forced to 0 (compact route)
    and at default (full route) and compare LDR bit-exact."""
    from lsr_tpu.core.frame import FrameParams, TechniqueMode
    from lsr_tpu.passes.standard_passes import make_standard_registry
    from lsr_tpu.pipeline.executor import RenderContext
    from lsr_tpu.pipeline.pipeline import PluggablePipeline
    from lsr_tpu.pipeline.recipe import builtin_render_path_presets
    from tests.test_pipeline_integration import _MODE_FOR, _scene_state

    preset = [p for p in builtin_render_path_presets()
              if p.name == "forward_plus"][0]
    w, h = 96, 64
    imgs = {}
    for thresh in (10**9, 0):
        reg = make_standard_registry()
        fp = FrameParams(width=w, height=h)
        fp.technique.mode = _MODE_FOR[preset.name]
        fp.technique.light_culling = preset.light_culling
        fp.technique.tile_size = 16
        fp.technique.cluster_slices = 8
        fp.technique.max_lights_per_tile = 32
        fp.pass_params.shadow.map_size = 128
        fp.compact_setup_threshold = thresh
        pipe = PluggablePipeline(preexisting_semantics=())
        assert pipe.configure_from_recipe(preset, reg).ok
        assert pipe.build_plan(fp).ok
        state = pipe.execute(RenderContext(), _scene_state(w, h), fp)
        imgs[thresh] = np.asarray(state["ldr"])
        if thresh == 0:
            assert not bool(np.asarray(
                state["raster_stats"]["compact_overflow"]))
    assert np.array_equal(imgs[0], imgs[10**9])
