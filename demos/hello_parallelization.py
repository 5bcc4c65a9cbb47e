"""Parallelization strategies demo: the hello-parallelization family.

The reference family demonstrates scanline-band threading, tile jobs,
job-system graphs, fibers, and SIMD (hello-parallelization/*.cpp).  Across devices
those map to Pallas tile grids (in-kernel, free) and DEVICE-MESH axes
(SURVEY.md section 2.3).  This demo renders the same scene through each
mesh strategy on a virtual 8-device CPU mesh and asserts agreement:

  dp  - cameras per device (batch parallelism)
  sp  - framebuffer row bands per device (screen-space parallelism)
  lp  - light-set shards, partial sums psum over the interconnect (tensor/expert analog)
  pp  - 2-stage frame pipeline, G-buffer over ppermute (GPipe analog)

Run: python demos/hello_parallelization.py  (re-execs itself with
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu).
"""

import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lsr_tpu.core import math3d as m3
    from lsr_tpu.io.obj import make_plane
    from lsr_tpu.io.png import save_canvas_png
    from lsr_tpu.lighting.light_types import LightSetBuilder
    from lsr_tpu.resources.assets import make_head_mesh
    from lsr_tpu.parallel.sharding import (
        make_light_sharded_forward,
        make_mesh,
        make_mesh_lp,
        make_mesh_pp,
        make_pipelined_render,
        make_pipelined_render as _,  # noqa: F401
        make_sharded_render,
        render_band,
    )
    from lsr_tpu.scene.scene import SceneBuilder, make_camera
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    monkey = make_head_mesh()
    sb = SceneBuilder()
    sb.add(monkey, np.asarray(m3.translate([0, 0.2, 0]) @ m3.rotate_y(0.5)))
    sb.add(make_plane(5.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build()
    mats = make_materials(base_color=[(0.8, 0.55, 0.35), (0.5, 0.55, 0.6)],
                          roughness=[0.4, 0.8])
    eye = (0.6, 1.1, -3.4)
    ctx = make_shade_context(mats, light_dir_ws=(0.4, -0.7, 0.5),
                             camera_pos=eye, light_intensity=2.2)
    lb = LightSetBuilder()
    rng = np.random.default_rng(5)
    for _i in range(16):
        lb.point(tuple(rng.uniform([-2, 0.3, -2], [2, 1.5, 2]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.6, range=2.5)
    lights = lb.build()

    w, h = 256, 128
    cam = make_camera(w, h, eye, (0, 0, 0))
    # The 1-device reference runs the SAME sharded step on a (1,1) mesh —
    # comparing against a separately-jitted program instead shows rare
    # 1-px fusion-ULP amplifications at sharp specular highlights.
    step1 = make_sharded_render(make_mesh(1), geom, objects, ctx, w, h,
                                cap=256)
    ref = np.asarray(step1(cam.viewproj[None], cam.zn, cam.zf))[0]

    panels = {}

    # dp x sp: cameras x row bands.
    mesh = make_mesh(8)  # dp=2, sp=4
    step = make_sharded_render(mesh, geom, objects, ctx, w, h, cap=256)
    vps = jnp.stack([cam.viewproj, cam.viewproj])
    out = np.asarray(step(vps, cam.zn, cam.zf))
    panels["dp2xsp4"] = out[0]
    assert (out[0] == ref).all(), "dp/sp mismatch"
    print("dp=2 x sp=4: bit-exact vs the 1-device mesh")

    # sp x lp: row bands x light shards (+ psum).
    mesh_lp = make_mesh_lp(8, sp=4, lp=2)
    step_lp, _sh = make_light_sharded_forward(
        mesh_lp, geom, objects, ctx, lights, w, h, cap=32)
    out_lp = np.asarray(step_lp(cam.viewproj, cam.view, cam.proj,
                                cam.zn, cam.zf))
    panels["sp4xlp2"] = out_lp
    print("sp=4 x lp=2: lights sharded, partial sums psum'd across devices")

    # pp: 2-stage frame pipeline.
    stream = make_pipelined_render(make_mesh_pp(2), geom, objects, ctx, w, h)
    vps3 = jnp.stack([cam.viewproj] * 3)
    out_pp = np.asarray(stream(vps3, cam.zn, cam.zf))
    panels["pp2"] = out_pp[1]
    # Steady-state determinism: identical cameras -> identical frames.
    assert (out_pp[1] == out_pp[2]).all(), "pp stream nondeterministic"
    d = np.abs(out_pp[1].astype(int) - ref.astype(int))
    frac = (d != 0).any(-1).mean()
    assert frac < 1e-3, f"pp diverges from 1-device: {frac}"
    print(f"pp=2: raster|shade staged over ppermute, "
          f"{frac * 100:.4f}%% px differ from the 1-device mesh "
          f"(cross-program fusion ULP)")

    panels["single"] = ref
    row = np.concatenate([panels[k] for k in
                          ("single", "dp2xsp4", "sp4xlp2", "pp2")], axis=1)
    out_dir = os.path.join(REPO, "out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "hello_parallelization.png")
    save_canvas_png(path, row)
    print(f"wrote {path} (panels: single | dp2xsp4 | sp4xlp2 | pp2)")


if __name__ == "__main__":
    if os.environ.get("_LSR_PAR_DEMO_CHILD") != "1":
        env = dict(os.environ)
        env["_LSR_PAR_DEMO_CHILD"] = "1"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count=8")
        env["JAX_PLATFORMS"] = "cpu"
        raise SystemExit(subprocess.run(
            [sys.executable, os.path.abspath(__file__)], env=env).returncode)
    sys.path.insert(0, REPO)
    from lsr_tpu.core.device import enable_compile_cache

    enable_compile_cache()
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
