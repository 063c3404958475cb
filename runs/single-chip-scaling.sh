#!/usr/bin/env bash
# Parity with the reference's runs/single-node-scaling.pbs: the same 300^3
# problem at a sweep of parallel widths on one node.  This script sweeps
# VIRTUAL device counts (host-emulated mesh), which checks the
# communication paths but times nothing real; on a 4-GPU host drop the two
# environment settings and pass --devices 1,2,4.  The reference swept MPI
# ranks 16,8,4,2,1 on one Titan node (single-node-scaling.pbs:56-67).
set -euo pipefail
cd "$(dirname "$0")/.."
N="${N:-128}"
OUT="${OUT:-runs/scaling_strong.json}"
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python -m tpusparse.bench.scaling strong --n "$N" --devices 1,2,4,8 \
    --precision f64 --out "$OUT"
