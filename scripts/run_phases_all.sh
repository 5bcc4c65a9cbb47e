#!/bin/sh
# Full protocol re-baseline on HEAD, on the GPU: Phase I (+post-stack
# sweep), Phase F (+ per-pass rows) and Phase G (180 s), each phase its own
# invocation/run_id, one after another (one process per card).
set -ex
cd "$(dirname "$0")/.."

env LSR_PHASE_F=0 LSR_PHASE_G=0 python scripts/run_phases.py
env LSR_PHASE_I=0 LSR_PHASE_I_POSTS=0 LSR_PHASE_G=0 python scripts/run_phases.py
env LSR_PHASE_I=0 LSR_PHASE_I_POSTS=0 LSR_PHASE_F=0 python scripts/run_phases.py
