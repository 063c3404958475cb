"""Benchmark-scale record for the device-resident banded GAMG setup.

The round-4 verdict asked for committed evidence that
``gamg_setup_banded_device`` (amg/deviceagg.py) works at the scale the
reference's KSPSetUp runs at (``/root/reference/src/main_ksp.cpp:97``:
GAMG aggregation + MatPtAP on the 2.7e7-row system), not just the
16^3-class oracle tests.  This driver produces that record:

1. **At-scale solve** (default n = 27,000,000 — the benchmark row count):
   a periodic-wrap banded Laplacian (offsets 0, +-1, +-(n-1); the wrap
   bands defeat ``infer_grid3d``, so no structured shortcut exists) is
   built DIRECTLY on device as DIA bands — no host matrix ever — then
   ``gamg_setup_banded_device`` is timed (cold = with per-level jit
   compiles, warm = numeric re-execution) and the system is solved with
   mixed-precision CG+AMG to rtol 1e-8.

2. **Tentative-cap characterization** (--penalty): at n = 1e6 (the 100^3
   row count) and n = 8e6 (200^3), the same matrix is set up twice —
   default (prolongator smoothing ON below ``n_smooth_cap``) and with
   ``n_smooth_cap=0`` (forced tentative, what the cap does to levels
   above 8M rows) — and both iteration counts are recorded, quantifying
   the round-4 verdict's open question (does the tentative cap keep
   iterations bounded at scale?).

3. **Greedy-oracle parity** (--oracle N): at a host-feasible size the
   greedy-Vanek path sets up the same matrix and both iteration counts
   are recorded (the quality yardstick of tests/test_deviceagg.py, at a
   bigger n).

Run: python -m tpusparse.bench.deviceaggbench [n] [--out F] [--penalty]
     [--oracle N]
Emits one JSON record.
"""

from __future__ import annotations

import argparse
import json
import time


def _periodic_bands(n: int, dtype):
    """Periodic wrap 1-D Laplacian + pin as device DIA bands.

    bands[k, i] = A[i, i + offsets[k]]; A = 2 I - wrap-shifts, row/col 0
    zeroed except the kept diagonal (MatZeroRowsColumns parity,
    /root/reference/src/helper.cpp:274).  SPD.
    """
    import jax.numpy as jnp

    from tpusparse.sparse.dia import DIA

    offsets = (-(n - 1), -1, 0, 1, n - 1)
    i = jnp.arange(n, dtype=jnp.int32)
    one = jnp.ones((n,), dtype)

    def off_band(o):
        # in-frame: 0 <= i + o < n; pin: zero where i == 0 or i + o == 0
        inframe = ((i + o) >= 0) & ((i + o) < n)
        keep = inframe & (i != 0) & ((i + o) != 0)
        return jnp.where(keep, -one, jnp.zeros((), dtype))

    bands = jnp.stack([
        off_band(-(n - 1)), off_band(-1), 2.0 * one, off_band(1),
        off_band(n - 1),
    ])
    return DIA(bands=bands, offsets=offsets, shape=(n, n))


def _setup(d, params, **kw):
    from tpusparse.amg.deviceagg import gamg_setup_banded_device

    tm: dict = {}
    t0 = time.perf_counter()
    hier = gamg_setup_banded_device(d, params, timings=tm, **kw)
    import jax

    jax.block_until_ready(hier.levels[-1].rho)
    return hier, time.perf_counter() - t0, tm


def _solve(d64, hier, rtol, maxiter=600):
    """Mixed-precision refined solve; b from a manufactured solution."""
    import jax
    import jax.numpy as jnp

    from tpusparse.solve.refine import cg_refined

    n = d64.shape[0]
    key = jax.random.PRNGKey(0)
    x_true = jax.random.normal(key, (n,), jnp.float64)
    b = d64.mv(x_true)
    op32 = hier.levels[0].op

    from tpusparse.amg.hierarchy import vcycle

    t0 = time.perf_counter()
    res = cg_refined(
        d64.mv, op32.mv, b, rtol=rtol, atol=0.0,
        m_lo_mv=lambda r: vcycle(hier, r), inner_maxiter=maxiter,
    )
    err = float(jnp.max(jnp.abs(res.x - x_true)))
    dt = time.perf_counter() - t0
    return {
        "iters": int(res.iters),
        "outer_iters": int(res.outer_iters),
        "reason": int(res.reason),
        "resnorm": float(res.resnorm),
        "linf_vs_manufactured": err,
        "t_solve": round(dt, 3),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=27_000_000)
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--out", default="")
    ap.add_argument("--penalty", action="store_true",
                    help="tentative-cap iteration-penalty runs (1M, 8M)")
    ap.add_argument("--oracle", type=int, default=0,
                    help="greedy-Vanek comparison at this host-feasible n")
    args = ap.parse_args()

    import jax

    from tpusparse.utils.compile_cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    import numpy as np

    from tpusparse.amg.hierarchy import AMGParams

    rec: dict = {
        "matrix": "periodic_wrap_laplacian_pin",
        "offsets": [-(args.n - 1), -1, 0, 1, args.n - 1],
        "n": args.n,
        "rtol": args.rtol,
        "setup_path": "gamg_setup_banded_device",
    }

    params = AMGParams()
    d32 = _periodic_bands(args.n, np.float32)
    d64 = _periodic_bands(args.n, np.float64)

    # cold = per-level jit compiles included; warm = prebuilt programs
    # (the reference-protocol analogue: KSPSetUp runs prebuilt binaries)
    _h, t_cold, _tm = _setup(d32, params)
    hier, t_warm, tm = _setup(d32, params)
    rec["t_setup_cold"] = round(t_cold, 3)
    rec["t_setup_warm"] = round(t_warm, 3)
    rec["setup_breakdown"] = {k: round(v, 3) for k, v in tm.items()}
    rec["levels"] = len(hier.levels)
    rec["level_rows"] = [int(l.op.shape[0]) for l in hier.levels][:12]
    rec["level_bands"] = [int(l.op.bands.shape[0]) for l in hier.levels][:12]
    rec.update(_solve(d64, hier, args.rtol))

    if args.penalty:
        pen = {}
        for n_p, tag in ((1_000_000, "1M_rows_100cubed"),
                         (8_000_000, "8M_rows_200cubed")):
            p32 = _periodic_bands(n_p, np.float32)
            p64 = _periodic_bands(n_p, np.float64)
            h_sm, _, _ = _setup(p32, params)          # smoothed (default)
            h_tn, _, _ = _setup(p32, params, n_smooth_cap=0)  # forced tent.
            pen[tag] = {
                "smoothed_iters": _solve(p64, h_sm, args.rtol)["iters"],
                "tentative_iters": _solve(p64, h_tn, args.rtol)["iters"],
            }
        rec["tentative_cap_penalty"] = pen

    if args.oracle:
        import scipy.sparse as sp

        from tpusparse.amg.unstructured import gamg_setup_unstructured
        from tpusparse.sparse.csr import HostCSR

        n_o = args.oracle
        a = sp.diags(
            [2.0, -1.0, -1.0, -1.0, -1.0],
            [0, 1, -1, n_o - 1, -(n_o - 1)], shape=(n_o, n_o),
        ).tolil()
        a[0, 1:] = 0.0
        a[1:, 0] = 0.0
        csr = HostCSR.from_scipy(a.tocsr())
        o64 = _periodic_bands(n_o, np.float64)
        h_dev, _, _ = _setup(_periodic_bands(n_o, np.float32), params)
        t0 = time.perf_counter()
        h_gre = gamg_setup_unstructured(
            csr, params, dtype=np.float32, aggregation="greedy"
        )
        t_greedy = time.perf_counter() - t0
        rec["oracle"] = {
            "n": n_o,
            "banded_iters": _solve(o64, h_dev, args.rtol)["iters"],
            "greedy_iters": _solve(o64, h_gre, args.rtol)["iters"],
            "t_setup_greedy_host": round(t_greedy, 3),
        }

    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
