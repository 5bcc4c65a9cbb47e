"""Self-contained multi-chip dryrun, runnable as `python -m lsr_tpu.parallel.dryrun N`.

The driver validates multi-chip sharding without N real chips by forcing N
virtual CPU devices (the reference's analog is its fake-device test pattern,
vop_core_tests.cpp:21).  This module sets the XLA host-platform flags BEFORE
importing jax, so it works regardless of what backend the parent process has
already initialized — `__graft_entry__.dryrun_multichip` invokes it as a
subprocess when the current process can't see enough devices.
"""

from __future__ import annotations

import os
import sys


def _force_virtual_devices(n: int) -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    # jax may already be imported; backends initialize lazily, so forcing
    # the platform through jax.config before the first device query still
    # wins (same pattern as tests/conftest.py).
    import jax

    jax.config.update("jax_platforms", "cpu")
    # CPU compiles are fast; a shared on-disk cache written by a different
    # machine type trips XLA:CPU AOT feature checks (SIGILL risk) — skip it.
    jax.config.update("jax_compilation_cache_dir", None)


def run_dryrun(n_devices: int) -> None:
    """Jit the full render step over an n-device ("dp","sp") mesh and run one
    step on tiny shapes (dp = camera batch, sp = framebuffer row bands).

    Requires that jax can already see >= n_devices devices (call
    _force_virtual_devices first if not).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lsr_tpu.core import math3d as m3
    from lsr_tpu.io.obj import make_cube
    from lsr_tpu.parallel.sharding import make_mesh, make_sharded_render
    from lsr_tpu.scene.scene import SceneBuilder, make_camera
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    width, height = 128, 64
    mesh = make_mesh(n_devices)
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    assert height % sp == 0

    sb = SceneBuilder()
    sb.add(make_cube(1.2), np.asarray(m3.rotate_y(0.4) @ m3.rotate_x(0.2)))
    geom, objects = sb.build()
    mats = make_materials(base_color=[(0.8, 0.5, 0.3)])
    ctx = make_shade_context(mats, light_dir_ws=(0.4, -0.7, 0.5),
                             camera_pos=(0, 0.5, -3.0), light_intensity=2.0)

    step = make_sharded_render(mesh, geom, objects, ctx, width, height,
                               cap=256)
    cams = [
        make_camera(width, height, (np.sin(a) * -3.0, 0.5, np.cos(a) * -3.0),
                    (0, 0, 0))
        for a in np.linspace(0.0, 0.5, dp)
    ]
    vps = jnp.stack([c.viewproj for c in cams])
    out = jax.block_until_ready(step(vps, cams[0].zn, cams[0].zf))
    assert out.shape == (dp, height, width, 3), out.shape
    out_np = np.asarray(out)
    assert out_np.any(), "sharded render produced an empty image"

    # dp x sp output equality vs an unsharded single-device render of the
    # same cameras: the mesh must not change the image.
    from lsr_tpu.parallel.sharding import render_band

    for b, cam in enumerate(cams):
        ref = np.asarray(jax.jit(
            lambda vp, zn=cam.zn, zf=cam.zf: render_band(
                geom, objects, vp, zn, zf, ctx, width, height, height, 0,
                cap=256)
        )(cams[b].viewproj))
        assert (ref == out_np[b]).all(), (
            f"sharded output differs from single-device render (camera {b})")
    print(f"dryrun_multichip ok: mesh dp={dp} sp={sp}, out {out.shape}, "
          f"bit-exact vs single-device")

    run_flagship_dryrun(n_devices)


def run_flagship_dryrun(n_devices: int) -> None:
    """The FULL flagship frame (sun shadow + forward+ + tonemap + FXAA)
    jitted over the ("dp","sp") mesh: shadow bands assembled with
    all_gather, FXAA halos exchanged with ppermute — then checked bit-exact
    against the same composition on a 1-device mesh, with per-mesh-shape
    step timings appended to artifacts/multichip_scaling.jsonl."""
    import json
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from lsr_tpu.core import math3d as m3
    from lsr_tpu.io.obj import make_cube, make_plane
    from lsr_tpu.lighting.light_types import LightSetBuilder
    from lsr_tpu.parallel.sharding import make_mesh, make_sharded_flagship
    from lsr_tpu.scene.scene import SceneBuilder, make_camera
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    width = height = 128
    shadow_size = 256

    sb = SceneBuilder()
    sb.add(make_cube(1.1), np.asarray(
        m3.translate([0.0, 0.3, 0.0]) @ m3.rotate_y(0.4)))
    sb.add(make_plane(5.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build()
    mats = make_materials(base_color=[(0.8, 0.5, 0.3), (0.5, 0.55, 0.6)],
                          roughness=[0.4, 0.8])
    ctx = make_shade_context(mats, light_dir_ws=(0.35, -0.7, 0.5),
                             camera_pos=(0.5, 1.8, -3.5), light_intensity=2.0)
    lb = LightSetBuilder()
    rng = np.random.default_rng(2)
    # Shadow-budgeted casters first (2 spots + 2 points -> both atlas
    # stacks shard over "sp"), then unshadowed fill.
    for sx in (-1.5, 1.5):
        lb.spot((sx, 2.5, 0.5), (0, -1, 0), color=(1.0, 0.9, 0.7),
                intensity=2.5, range=4.0, inner_angle=0.4, outer_angle=0.7)
    for _ in range(2):
        lb.point(tuple(rng.uniform([-2, 0.8, -2], [2, 1.4, 2]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.6, range=2.5)
    for _ in range(8):
        lb.point(tuple(rng.uniform([-2, 0.2, -2], [2, 1.5, 2]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.5, range=2.0)
    lights = lb.build()
    sun = jnp.asarray([0.35, -0.7, 0.5], jnp.float32)

    def cams_for(dp):
        return [make_camera(width, height,
                            (np.sin(a) * -3.5, 1.8, np.cos(a) * -3.5),
                            (0, 0, 0))
                for a in np.linspace(0.0, 0.5, dp)]

    def run_on(mesh, cams):
        step = make_sharded_flagship(
            mesh, geom, objects, ctx, lights, width, height,
            shadow_size=shadow_size)
        vps = jnp.stack([c.viewproj for c in cams])
        views = jnp.stack([c.view for c in cams])
        out = jax.block_until_ready(step(
            vps, views, cams[0].proj, cams[0].zn, cams[0].zf, sun))
        t0 = time.perf_counter()
        for _ in range(3):
            out = step(vps, views, cams[0].proj, cams[0].zn, cams[0].zf, sun)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / 3 * 1000
        return np.asarray(out), ms

    run_id = time.strftime("%Y%m%dT%H%M%S")
    mesh1 = make_mesh(1)
    # 1-device reference frame per CAMERA (not just camera 0): every dp
    # slice of every mesh shape must match its own unsharded render.
    ref_cache = {}

    def ref_for(cam):
        key = float(np.asarray(cam.viewproj).sum())
        if key not in ref_cache:
            out, ms = run_on(mesh1, [cam])
            ref_cache[key] = (out[0], ms)
        return ref_cache[key]

    rows = []
    _, ms1 = ref_for(cams_for(1)[0])
    rows.append({"phase": "multichip", "run_id": run_id, "dp": 1, "sp": 1,
                 "w": width, "h": height, "shadow": shadow_size,
                 "step_ms": round(ms1, 2),
                 "platform": jax.devices()[0].platform})
    shapes = [(1, n_devices)]
    if n_devices % 2 == 0 and n_devices >= 4:
        shapes.append((2, n_devices // 2))
    for dp, sp in shapes:
        mesh = make_mesh(dp * sp, dp=dp)
        cams = cams_for(dp)
        out, ms = run_on(mesh, cams)
        assert out.shape == (dp, height, width, 3), out.shape
        for b, cam in enumerate(cams):
            ref_b, _ = ref_for(cam)
            assert (out[b] == ref_b).all(), (
                f"flagship dp={dp} sp={sp} slice {b} differs from its "
                f"1-device frame")
        rows.append({"phase": "multichip", "run_id": run_id, "dp": dp,
                     "sp": sp, "w": width, "h": height,
                     "shadow": shadow_size, "step_ms": round(ms, 2),
                     "platform": jax.devices()[0].platform})
        print(f"flagship dryrun ok: dp={dp} sp={sp} "
              f"(cull + sp-sharded local atlas all_gather + sun shadow "
              f"all_gather + fxaa ppermute halos, all {dp} dp "
              f"slices bit-exact), {ms:.1f} ms/step")
    # --- light-parallel ("lp") axis: psum partial light sums -------------
    from lsr_tpu.parallel.sharding import (
        make_light_sharded_forward, make_mesh_lp)

    cam0 = cams_for(1)[0]

    def run_lp(mesh):
        step, _ = make_light_sharded_forward(
            mesh, geom, objects, ctx, lights, width, height, cap=32)
        out = jax.block_until_ready(step(
            cam0.viewproj, cam0.view, cam0.proj, cam0.zn, cam0.zf))
        t0 = time.perf_counter()
        for _ in range(3):
            out = step(cam0.viewproj, cam0.view, cam0.proj, cam0.zn, cam0.zf)
        jax.block_until_ready(out)
        return np.asarray(out), (time.perf_counter() - t0) / 3 * 1000

    ref_lp, _ = run_lp(make_mesh_lp(1, sp=1, lp=1))
    for sp_n, lp_n in (((n_devices // 2), 2), (1, n_devices)):
        if sp_n * lp_n != n_devices or height % max(sp_n, 1):
            continue
        out_lp, ms_lp = run_lp(make_mesh_lp(n_devices, sp=sp_n, lp=lp_n))
        d = np.abs(out_lp.astype(int) - ref_lp.astype(int))
        assert d.max() <= 1, (
            f"lp={lp_n} psum reassociation exceeded 1 LSB: {d.max()}")
        rows.append({"phase": "multichip", "run_id": run_id, "dp": 1,
                     "sp": sp_n, "lp": lp_n, "w": width, "h": height,
                     "step_ms": round(ms_lp, 2),
                     "platform": jax.devices()[0].platform})
        print(f"light-parallel dryrun ok: sp={sp_n} lp={lp_n} "
              f"(partial light sums psum over lp, <=1 LSB vs 1-device), "
              f"{ms_lp:.1f} ms/step")

    # --- pipeline-parallel ("pp") axis: staged frames over ppermute -------
    from lsr_tpu.parallel.sharding import make_mesh_pp, make_pipelined_render
    from lsr_tpu.parallel.sharding import render_band as _render_band

    pp_stream = make_pipelined_render(make_mesh_pp(2), geom, objects, ctx,
                                      width, height)
    pp_cams = cams_for(1) + cams_for(2)
    pp_vps = jnp.stack([c.viewproj for c in pp_cams])
    pp_out = jax.block_until_ready(
        pp_stream(pp_vps, pp_cams[0].zn, pp_cams[0].zf))
    t0 = time.perf_counter()
    pp_out = jax.block_until_ready(
        pp_stream(pp_vps, pp_cams[0].zn, pp_cams[0].zf))
    ms_pp = (time.perf_counter() - t0) * 1000 / max(len(pp_cams) - 1, 1)
    pp_np = np.asarray(pp_out)
    for i in range(1, len(pp_cams)):
        ref_pp = np.asarray(_render_band(
            geom, objects, pp_cams[i - 1].viewproj, pp_cams[0].zn,
            pp_cams[0].zf, ctx, width, height, height, 0,
            model_name="blinn_phong"))
        d = np.abs(pp_np[i].astype(int) - ref_pp.astype(int))
        assert d.max() <= 1, f"pp frame {i}: max|d|={d.max()}"
    rows.append({"phase": "multichip", "run_id": run_id, "pp": 2,
                 "w": width, "h": height, "step_ms": round(ms_pp, 2),
                 "platform": jax.devices()[0].platform})
    print(f"pipeline-parallel dryrun ok: pp=2 (raster stage | shade stage, "
          f"G-buffer over ppermute, <=1 LSB vs 1-device), "
          f"{ms_pp:.1f} ms/frame")

    try:
        path = "artifacts/multichip_scaling.jsonl"
        import os as _os

        _os.makedirs("artifacts", exist_ok=True)
        with open(path, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    except OSError:
        pass


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    _force_virtual_devices(n)
    run_dryrun(n)


if __name__ == "__main__":
    main()
