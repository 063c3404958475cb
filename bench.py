#!/usr/bin/env python
"""Headline benchmark: 300^3 Poisson CG+GAMG time-to-rtol-1e-8 on one GPU.

Baseline: the reference's best single node (16 Opteron cores + K20x,
CRAY_CUDA_PROXY) solves the same system in ~25-35 s of KSPSolve time
(BASELINE.md); we take 30 s as the comparison point.  ``vs_baseline`` is the
speedup factor (baseline_time / our_time, > 1 means faster).

Prints exactly one JSON line on stdout, naming the device it ran on.  Exits
non-zero, printing no result, when JAX finds no GPU.
"""

import json
import sys

import jax

jax.config.update("jax_enable_x64", True)

BASELINE_SOLVE_S = 30.0  # reference best-node KSPSolve, BASELINE.md table
N = 300
RTOL = 1e-8   # BASELINE.json gate (reference config runs 1e-14; see report)


def main() -> None:
    from tpusparse.bench.device import require_gpu
    from tpusparse.bench.driver import solve_poisson
    from tpusparse.utils.compile_cache import enable_compile_cache

    device = require_gpu("bench")
    enable_compile_cache()
    rep = solve_poisson(N, rtol=RTOL, atol=1e-12, pc="gamg")
    result = {
        "metric": f"poisson{N}_cg_gamg_solve_s",
        "value": round(rep.t_solve, 6),
        "unit": "s",
        "vs_baseline": round(BASELINE_SOLVE_S / rep.t_solve, 3),
        "device": device,
    }
    # context lines on stderr (never pollute the stdout contract)
    print(rep.reference_block(), file=sys.stderr)
    print(rep.json_sidecar(), file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
