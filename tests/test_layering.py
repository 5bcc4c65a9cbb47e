"""Architecture boundary checks — the VOP layering constitution.

The reference enforces its Value-Oriented-Programming layering with a
grep-style ctest (`tools/check_vop_boundaries.sh:36-44`, registered as
`shs_renderer_vop_boundary_check`): planner headers must not reach into
`shs/rhi/drivers/` or `shs/rhi/sync/` (effects live at the edges), and
`dynamic_cast` is forbidden.  The JAX analog: pipeline PLANNING is
deterministic pure-value Python (SURVEY §7 design stance) — the planner
modules must not import jax (device effects), kernels, or the executor;
only the executor (the runtime edge) touches devices.
"""

import ast
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent

# Pure value-plane modules: plan compilation must be deterministic host
# code with no device effects (value_oriented_programming.md §3 analog).
PLANNING_MODULES = [
    "lsr_tpu/pipeline/frame_graph.py",
    "lsr_tpu/pipeline/contracts.py",
    "lsr_tpu/pipeline/registry.py",
    "lsr_tpu/pipeline/planner.py",
    "lsr_tpu/pipeline/recipe.py",
    "lsr_tpu/core/frame.py",
]

# The effectful runtime edge the planners must never import (the analog of
# rhi/drivers + rhi/sync in check_vop_boundaries.sh).
FORBIDDEN_FOR_PLANNERS = (
    "jax",
    "numpy",
    "lsr_tpu.pipeline.executor",
    "lsr_tpu.raster",
    "lsr_tpu.lighting",
    "lsr_tpu.passes",
)


def _imports_of(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    return mods


def test_planner_modules_are_pure_value_code():
    for rel in PLANNING_MODULES:
        path = REPO / rel
        assert path.exists(), rel
        for mod in _imports_of(path):
            for bad in FORBIDDEN_FOR_PLANNERS:
                assert not (mod == bad or mod.startswith(bad + ".")), (
                    f"{rel} imports {mod} — planning must stay pure value "
                    f"code (device/kernel effects belong in the executor)")


def test_library_never_imports_demos_or_scripts():
    """Layer direction: the library can't depend on its own demos/harnesses
    (the reference's demos sit ABOVE the library, SURVEY §1 layer 10)."""
    for path in (REPO / "lsr_tpu").rglob("*.py"):
        for mod in _imports_of(path):
            assert not mod.startswith(("demos", "scripts", "bench")), (
                f"{path.relative_to(REPO)} imports {mod}")


def test_kernels_never_import_pipeline():
    """Compute layers (raster/lighting/shading) sit below pipeline
    orchestration (SURVEY §1 layers 2-4 vs 7) and must not reach up."""
    for sub in ("raster", "lighting", "shading", "geometry"):
        for path in (REPO / "lsr_tpu" / sub).rglob("*.py"):
            for mod in _imports_of(path):
                assert not mod.startswith("lsr_tpu.pipeline"), (
                    f"{path.relative_to(REPO)} imports {mod}")
