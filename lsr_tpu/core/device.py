"""The one place that decides where kernels run.

On the GPU every Pallas kernel compiles through the Triton route; on the
CPU (the test platform) the same kernels run in Pallas interpret mode.  Any
other platform has no kernel route and is refused.  Measurement entry
points (bench.py, chip_smoke.py) call `require_gpu` so that a run without a
card fails instead of timing the CPU.
"""

from __future__ import annotations

import os

import jax

_KERNEL_PLATFORMS = ("gpu", "cpu")


def kernel_interpret() -> bool:
    """True when Pallas kernels must run interpreted (CPU)."""
    p = jax.default_backend()
    if p not in _KERNEL_PLATFORMS:
        raise RuntimeError(f"no kernel route for platform {p!r}; "
                           f"supported: {_KERNEL_PLATFORMS}")
    return p == "cpu"


def require_gpu() -> jax.Device:
    """First device if JAX found a GPU, else raise (no CPU fallback)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"a GPU is required, JAX found {devs[0].platform!r}")
    return devs[0]


def device_summary() -> dict:
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def enable_compile_cache() -> str:
    """Persist compiled programs across processes.

    $JAX_COMPILATION_CACHE_DIR wins when set (JAX reads it itself);
    otherwise the cache lives in `.jax_cache/` at the repository root, a
    fixed path listed in .gitignore.  Call before the first compile."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = os.path.join(repo, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
