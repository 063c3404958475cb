#!/usr/bin/env bash
# Weak scaling (fixed per-device box), the BASELINE.json north star:
# >= 70% nnz/s efficiency.  Analogue of runs/multiple-node-scaling.pbs
# (concurrent strong-scaling jobs at 16..1024 ranks) recast for device
# meshes.  The emulated mesh below checks the paths only; on a 4-GPU host
# drop the two environment settings and pass --devices 1,2,4.
set -euo pipefail
cd "$(dirname "$0")/.."
PER="${PER:-64}"
OUT="${OUT:-runs/scaling_weak.json}"
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python -m tpusparse.bench.scaling weak --per-device "$PER" \
    --devices 1,2,4,8 --precision f64 --out "$OUT"
