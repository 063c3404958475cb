"""Timed record for the arbitrary-CSR (reorder + segmented executor) path.

Builds the verdict's acceptance case at benchmark scale: the manufactured
Poisson system RANDOMLY PERMUTED — no grid pattern (``infer_grid3d``
correctly refuses), thousands of occupied diagonals (DIA refuses) — then
solved through ``ksp.KSP`` with ``mat_reorder='auto'``: RCM bounds the
bandwidth, the container auto-selection lands on HybridDIA (below the
gather cap) or the segmented ``BandedELL`` (above it), and the solution is
unpermuted on the way out.  Compares against the natural-order solve of
the same system (iteration parity + solution agreement).

Run: python -m tpusparse.bench.reorderbench [N] [--pc gamg|jacobi] [--out F]
Emits one JSON record (the general-matrix record format of
``runs/general-matrix-bench.sh``).
"""

from __future__ import annotations

import argparse
import json
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=100)
    ap.add_argument("--pc", default="gamg", choices=["gamg", "jacobi"])
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument(
        "--skip-natural", action="store_true",
        help="skip the natural-order comparison solve (large n)",
    )
    args = ap.parse_args()

    import jax

    from tpusparse.utils.compile_cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from tpusparse.grid.grid3d import Grid3D
    from tpusparse.grid.poisson import assemble_poisson
    from tpusparse.ksp import KSP
    from tpusparse.sparse.reorder import (
        bandwidth,
        distinct_diagonals,
        permute_csr,
        rcm_permutation,
    )

    n = args.n
    rec: dict = {"n": n, "rows": n**3, "pc": args.pc, "seed": args.seed}

    t0 = time.perf_counter()
    grid = Grid3D(n, n, n)
    a, b, _exact = assemble_poisson(grid, pin=True)
    rng = np.random.default_rng(args.seed)
    p = rng.permutation(a.n_rows)
    ap_csr = permute_csr(a, p)
    bp = b[p]
    rec["t_build_permuted_system"] = round(time.perf_counter() - t0, 3)
    rec["bandwidth_scrambled"] = bandwidth(ap_csr)
    rec["diagonals_scrambled"] = distinct_diagonals(ap_csr)

    t0 = time.perf_counter()
    perm_probe = rcm_permutation(ap_csr)
    rec["t_rcm_seconds"] = round(time.perf_counter() - t0, 3)
    probe = permute_csr(ap_csr, perm_probe)
    rec["bandwidth_rcm"] = bandwidth(probe)
    rec["diagonals_rcm"] = distinct_diagonals(probe)
    del perm_probe, probe

    k = KSP(
        rtol=args.rtol, atol=1e-12, maxiter=args.maxiter,
        pc_type=args.pc, precision="mixed",
    )
    t0 = time.perf_counter()
    k.set_operators(ap_csr)  # re-runs RCM internally (t_init charge)
    rec["reordered"] = k._perm is not None
    rec["container"] = type(k._op_lo).__name__
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    k.setup()
    rec["container_level0"] = type(k._op_lo).__name__
    t_setup = time.perf_counter() - t0
    res = k.solve(jnp.asarray(bp))  # warm (compile charged outside)
    t0 = time.perf_counter()
    res = k.solve(jnp.asarray(bp))
    t_solve = time.perf_counter() - t0
    rec.update(
        iters=res.iters, reason=res.reason, resnorm=res.resnorm,
        t_init=round(t_init, 3), t_setup=round(t_setup, 3),
        t_solve=round(t_solve, 4),
    )

    if not args.skip_natural:
        k0 = KSP(
            rtol=args.rtol, atol=1e-12, maxiter=args.maxiter,
            pc_type=args.pc, precision="mixed",
        )
        k0.set_operators(a)
        r0 = k0.solve(jnp.asarray(b))
        t0 = time.perf_counter()
        r0 = k0.solve(jnp.asarray(b))
        rec["natural_t_solve"] = round(time.perf_counter() - t0, 4)
        rec["natural_iters"] = r0.iters
        rec["x_agreement_linf"] = float(
            np.abs(np.asarray(res.x) - np.asarray(r0.x)[p]).max()
        )

    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
