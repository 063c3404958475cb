#!/usr/bin/env python
"""General-matrix (arbitrary-CSR) benchmark sibling of bench.py.

The same 300^3 Poisson system ASSEMBLED as a host CSR and solved through
-mat_type aij (DMSetMatType(MATAIJ) parity — the matrix type the reference
actually ships, solved by PETSc through its patched general-CSR kernel,
/root/reference/src/openacc-step1/MatMult_SeqAIJ.patch).  Baseline: the
reference's best node KSPSolve ~25-35 s (BASELINE.md; 30 s comparison
point).

Prints exactly one JSON line on stdout, naming the device it ran on.  Exits
non-zero, printing no result, when JAX finds no GPU.
"""

import json
import sys

import jax

jax.config.update("jax_enable_x64", True)

BASELINE_SOLVE_S = 30.0  # reference best-node KSPSolve, BASELINE.md table
N = 300
RTOL = 1e-8


def main() -> None:
    from tpusparse.bench.device import require_gpu
    from tpusparse.bench.driver import solve_poisson
    from tpusparse.utils.compile_cache import enable_compile_cache

    device = require_gpu("bench_aij")
    enable_compile_cache()
    # default: production aij (structure detection on — the star proof
    # lifts this matrix onto the structured executor).  --nodetect: the
    # pure general banded executor, no structural shortcuts.
    detect = "--nodetect" not in sys.argv
    rep = solve_poisson(N, rtol=RTOL, atol=1e-12, pc="gamg",
                        mat_type="aij", structure_detect=detect)
    tag = "" if detect else "_nodetect"
    result = {
        "metric": f"poisson{N}_aij{tag}_cg_gamg_solve_s",
        "value": round(rep.t_solve, 6),
        "unit": "s",
        "vs_baseline": round(BASELINE_SOLVE_S / rep.t_solve, 3),
        "device": device,
    }
    print(rep.reference_block(), file=sys.stderr)
    print(rep.json_sidecar(), file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
