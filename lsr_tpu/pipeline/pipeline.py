"""PluggablePipeline: pass container + plan + execute.

The analog of PluggablePipeline (pluggable_pipeline.hpp:743-1000): holds the
pass list, lazily rebuilds the frame graph + execution plan when the pass set
changes, exposes graph/plan reports, and executes through the runtime
executor.  Temporal state reset hooks mirror reset_history/on_scene_reset
(pluggable_pipeline.hpp:960-978).
"""

from __future__ import annotations

from typing import List, Optional

from lsr_tpu.pipeline.executor import RenderContext, XlaBackend, execute_plan
from lsr_tpu.pipeline.planner import BackendCaps, build_execution_plan
from lsr_tpu.pipeline.render_pass import RenderPass


class PluggablePipeline:
    def __init__(self, backends: Optional[dict] = None,
                 default_backend: str = "xla",
                 preexisting_semantics=("scene_depth",)):
        self._passes: List[RenderPass] = []
        self._plan = None
        self._dirty = True
        self._persistent_state: dict = {}
        self._jit_key = None
        self._default_backend = default_backend
        self._preexisting = tuple(preexisting_semantics)
        self.backend_caps = backends or {
            default_backend: BackendCaps(default_backend)
        }
        self.backend_impls = {default_backend: XlaBackend()}

    # -- pass management ----------------------------------------------------
    def add_pass(self, p: RenderPass):
        self._passes.append(p)
        self._dirty = True
        return self

    def find_pass(self, pass_id: str) -> Optional[RenderPass]:
        for p in self._passes:
            if p.pass_id == pass_id:
                return p
        return None

    def set_enabled(self, pass_id: str, enabled: bool) -> bool:
        p = self.find_pass(pass_id)
        if p is None:
            return False
        if p.enabled != enabled:
            p.enabled = enabled
            self._dirty = True
        return True

    def clear(self):
        self._passes.clear()
        self._dirty = True

    @property
    def passes(self):
        return tuple(self._passes)

    # -- configuration from recipes ------------------------------------------
    def configure_from_recipe(self, recipe, registry, caps=None,
                              permissive: bool = False, **factory_kwargs):
        """Compile a recipe and instantiate its pass chain via the registry."""
        from lsr_tpu.pipeline.recipe import compile_recipe

        report = compile_recipe(recipe, registry, caps, permissive=permissive)
        if report.ok:
            self.clear()
            for pid in report.passes:
                self.add_pass(registry.create(pid, **factory_kwargs))
        return report

    # -- planning -------------------------------------------------------------
    def build_plan(self, fp):
        if self._dirty or self._plan is None:
            self._plan = build_execution_plan(
                self._passes, fp,
                backends=self.backend_caps,
                default_backend=self._default_backend,
                preexisting_semantics=self._preexisting,
            )
            self._dirty = False
        return self._plan

    def execution_report(self):
        return self._plan

    # -- execution -------------------------------------------------------------
    def execute(self, ctx: RenderContext, frame_state: dict, fp) -> dict:
        plan = self.build_plan(fp)
        ctx.backends = self.backend_impls
        frame_state = dict(frame_state)
        frame_state.update(self._persistent_state)
        out = execute_plan(plan, self._passes, ctx, frame_state, fp)
        self._capture_persistent(out)
        return out

    PERSISTENT_KEYS = ("history_color", "vis_history")

    def execute_jitted(self, ctx: RenderContext, frame_state: dict, fp) -> dict:
        """Whole-plan jit: every pass traces into ONE compiled program.

        This is the production frame path (eager pass glue dispatches op by
        op).  Per-pass timings are unavailable inside a
        fused program — use execute() for the instrumented path.  Passes must
        be pure (they are; temporal state lives in frame state).
        """
        import jax

        plan = self.build_plan(fp)
        if not plan.ok:
            raise RuntimeError(f"refusing to execute invalid plan: {plan.errors}")
        key = (tuple(plan.order), id(fp))
        if getattr(self, "_jit_key", None) != key:
            passes = self._passes

            def run(state):
                for idx in plan.order:
                    p = passes[idx]
                    req = p.build_execution_request(ctx, state, fp)
                    if not req.valid:
                        continue
                    state = p.execute_resolved(ctx, state, fp, req)
                return state

            self._jitted = jax.jit(run)
            self._jit_key = key
        frame_state = dict(frame_state)
        frame_state.update(self._persistent_state)
        out = self._jitted(frame_state)
        ctx.debug.frames += 1
        ctx.frame_index += 1
        self._capture_persistent(out)
        return out

    def execute_segmented(self, ctx: RenderContext, frame_state: dict, fp,
                          reps: int = 8) -> dict:
        """Per-pass DEVICE timing at jit speed (profiling mode).

        Each pass compiles to its OWN jitted program (cached across frames);
        after one warm call it is timed `reps` times, each call ending
        in jax.block_until_ready — the analog of the reference's per-pass
        GPU timestamp pool (hello_rendering_paths.cpp:111, :274-283).
        Cross-pass XLA fusion is absent by construction, so the SUM of the
        recorded pass times upper-bounds the fused execute_jitted frame;
        use it for stage attribution, not headline fps.  Results (mean ms
        and its standard error) land in ctx.debug.pass_ms / pass_ms_err;
        outputs are identical to execute_jitted up to fusion-order float
        reassociation.
        """
        import time

        import jax

        plan = self.build_plan(fp)
        if not plan.ok:
            raise RuntimeError(
                f"refusing to execute invalid plan: {plan.errors}")
        key = (tuple(plan.order), id(fp))
        if getattr(self, "_seg_key", None) != key:
            self._seg_jits = {}
            self._seg_key = key
        state = dict(frame_state)
        state.update(self._persistent_state)
        for idx in plan.order:
            p = self._passes[idx]
            req = p.build_execution_request(ctx, state, fp)
            if not req.valid:
                ctx.debug.skipped_passes.append(f"{p.pass_id}: {req.error}")
                continue
            if idx not in self._seg_jits:
                self._seg_jits[idx] = jax.jit(
                    lambda s, p=p, req=req: p.execute_resolved(
                        ctx, s, fp, req))
            fn = self._seg_jits[idx]
            jax.block_until_ready(fn(state))           # compile + warm
            ts = []
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                out = jax.block_until_ready(fn(state))
                ts.append((time.perf_counter() - t0) * 1000.0)
            state = out
            ms = sum(ts) / len(ts)
            err = (sum((t - ms) ** 2 for t in ts)
                   / max(1, len(ts) - 1) / len(ts)) ** 0.5
            ctx.debug.pass_ms[p.pass_id] = ms
            ctx.debug.pass_ms_err[p.pass_id] = err
        ctx.debug.frames += 1
        ctx.frame_index += 1
        self._capture_persistent(state)
        return state

    def _capture_persistent(self, state: dict):
        for k in self.PERSISTENT_KEYS:
            if k in state:
                self._persistent_state[k] = state[k]

    # -- temporal state ---------------------------------------------------------
    def reset_history(self):
        self._persistent_state = {}
        for p in self._passes:
            p.reset_history()
