"""Benchmark / parity / soak harnesses (the Phase F / I / G machinery).

Mirrors hello_rendering_paths.cpp's built-in harnesses:
- Phase F (:290-353): warmup + sampled frame timing per composition,
  min/avg/max ms + metadata as JSONL,
- Phase I (:389-414): per-composition low-res headless renders hashed and
  compared across backends — here the two "backends" are the Pallas kernel
  path and the pure-XLA brute path (our DummyBackend-style device pair),
- Phase G (:355-387): timed soak cycling compositions with perturbations,
  asserting frame-time and rebuild-count acceptance thresholds.

All emitters write JSON Lines under artifacts/ like the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Dict, List

import jax
import numpy as np


def write_jsonl(path: str, rows: List[dict]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def ldr_hash(img_u8) -> str:
    """Stable content hash of an LDR image (hash_ldr_color_buffer analog,
    hello_rendering_paths.cpp:1315)."""
    arr = np.ascontiguousarray(np.asarray(img_u8))
    h = hashlib.blake2b(arr.tobytes(), digest_size=16)
    h.update(str(arr.shape).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Phase F: benchmark
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BenchResult:
    name: str
    frames: int
    ms_min: float
    ms_avg: float
    ms_max: float
    meta: dict = dataclasses.field(default_factory=dict)

    def row(self) -> dict:
        return {
            "phase": "F", "composition": self.name, "frames": self.frames,
            "frame_ms_min": round(self.ms_min, 3),
            "frame_ms_avg": round(self.ms_avg, 3),
            "frame_ms_max": round(self.ms_max, 3),
            "fps_avg": round(1000.0 / max(self.ms_avg, 1e-6), 2),
            **self.meta,
        }


def run_benchmark(name: str, frame_fn: Callable[[int], object],
                  warmup: int = 90, samples: int = 180,
                  jsonl_path: str | None = "artifacts/phase_f_metrics.jsonl",
                  meta: dict | None = None, chunk: int = 30) -> BenchResult:
    """Time frame_fn(i) for `samples` frames after `warmup` (defaults match
    hello_rendering_paths.cpp:293-294).

    Frames dispatch asynchronously and are timed in chunks of `chunk`, each
    ending in one jax.block_until_ready; min/avg/max are over chunks.
    """
    out = None
    for i in range(warmup):
        out = frame_fn(i)
    jax.block_until_ready(out)

    chunk_ms = []
    total = 0.0
    i = 0
    while i < samples:
        n = min(chunk, samples - i)
        t0 = time.perf_counter()
        for j in range(n):
            out = frame_fn(warmup + i + j)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) * 1000.0
        chunk_ms.append(dt / n)
        total += dt
        i += n

    res = BenchResult(
        name=name, frames=samples,
        ms_min=min(chunk_ms), ms_avg=total / samples, ms_max=max(chunk_ms),
        meta={**(meta or {}), "chunk": chunk},
    )
    if jsonl_path:
        write_jsonl(jsonl_path, [res.row()])
    return res


# ---------------------------------------------------------------------------
# Phase I: backend parity
# ---------------------------------------------------------------------------

def run_backend_parity(
    compositions: Dict[str, Dict[str, Callable[[int], object]]],
    warmup: int = 2, samples: int = 6,
    jsonl_path: str | None = "artifacts/phase_i_backend_parity.jsonl",
    run_id: str | None = None,
):
    """compositions: {name: {backend_name: frame_fn(i) -> ldr_u8}}.

    Renders each composition on every backend (2 warmup + 6 hashed frames,
    hello_rendering_paths.cpp:398-401) and reports per-frame hash agreement.
    Returns {name: {"match": bool, "hashes": {backend: [hash,...]}}}.
    """
    results = {}
    rows = []
    for name, backends in compositions.items():
        hashes = {}
        for be, fn in backends.items():
            per_frame = []
            for i in range(warmup):
                jax.block_until_ready(fn(i))
            for i in range(samples):
                per_frame.append(ldr_hash(fn(warmup + i)))
            hashes[be] = per_frame
        names = list(hashes)
        match = all(hashes[b] == hashes[names[0]] for b in names[1:])
        results[name] = {"match": match, "hashes": hashes}
        rows.append({
            "phase": "I", "composition": name, "backends": names,
            "match": match,
            "ldr_hash": hashes[names[0]][-1],
            **({"run_id": run_id} if run_id else {}),
        })
    if jsonl_path:
        write_jsonl(jsonl_path, rows)
    return results


# ---------------------------------------------------------------------------
# Phase G: soak
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SoakAcceptance:
    """hello_rendering_paths.cpp:362-369 thresholds."""

    max_avg_frame_ms: float = 50.0
    max_rebuilds: int = 24
    max_cycle_failures: int = 0


def run_soak(
    compositions: Dict[str, Callable[[int], object]],
    duration_s: float = 180.0,
    frames_per_cycle: int = 240,
    acceptance: SoakAcceptance | None = None,
    rt_registry=None,
    perturb: Callable[[int], None] | None = None,
    jsonl_path: str | None = "artifacts/phase_g_soak.jsonl",
    run_id: str | None = None,
    drain_every: int = 30,
):
    """Cycle compositions until duration_s elapses, perturbing between cycles
    (configure-toggle stress, hello_rendering_paths.cpp:1754).  Returns a
    report dict with pass/fail against the acceptance thresholds.

    Frames dispatch asynchronously with one jax.block_until_ready per
    `drain_every` frames; avg_frame_ms is wall time per frame.
    """
    acceptance = acceptance or SoakAcceptance()
    names = list(compositions)
    t_start = time.perf_counter()
    frame = 0
    cycle = 0
    failures = 0
    busy_ms = 0.0
    drains = 0
    while time.perf_counter() - t_start < duration_s:
        name = names[cycle % len(names)]
        fn = compositions[name]
        if perturb is not None:
            perturb(cycle)
        try:
            done = 0
            while done < frames_per_cycle:
                n = min(drain_every, frames_per_cycle - done)
                t0 = time.perf_counter()
                t_disp = 0.0
                out = None
                for _ in range(n):
                    td = time.perf_counter()
                    out = fn(frame)
                    t_disp += time.perf_counter() - td
                    frame += 1
                jax.block_until_ready(out)
                chunk = (time.perf_counter() - t0) * 1000.0
                busy_ms += chunk
                drains += 1
                done += n
                if jsonl_path:
                    # Per-chunk diagnostics: dispatch_ms is the host-side
                    # share (state staging + program dispatch); chunk minus
                    # dispatch is waiting on the device.
                    write_jsonl(jsonl_path, [{
                        "phase": "G_chunk", "cycle": cycle,
                        "composition": name, "frames": n,
                        "ms_per_frame": round(chunk / n, 2),
                        "dispatch_ms_per_frame": round(
                            t_disp * 1000.0 / n, 2),
                        **({"run_id": run_id} if run_id else {}),
                    }])
                if time.perf_counter() - t_start >= duration_s:
                    break
        except Exception:  # cycle failure is data, not a crash (Phase G)
            failures += 1
        cycle += 1

    avg_ms = busy_ms / max(frame, 1)
    rebuilds = rt_registry.rebuild_count if rt_registry is not None else 0
    ok = (
        avg_ms <= acceptance.max_avg_frame_ms
        and rebuilds <= acceptance.max_rebuilds
        and failures <= acceptance.max_cycle_failures
    )
    report = {
        "phase": "G", "frames": frame, "cycles": cycle,
        "avg_frame_ms": round(avg_ms, 3), "rebuilds": rebuilds,
        "cycle_failures": failures, "accepted": ok, "drains": drains,
        **({"run_id": run_id} if run_id else {}),
    }
    if jsonl_path:
        write_jsonl(jsonl_path, [report])
    return report
