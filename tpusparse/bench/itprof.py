"""Per-component profile of one inner CG+GAMG iteration — the ledger
behind the single-device solve number.

Times each piece of the solve's hot path (the plain XLA layout, chebyshev
degree-2 smoother — the bench.py configuration) as chained in-jit
applications on the GPU, so the 300^3 solve time can be attributed
pass-by-pass: the fine-level mv, the transfer contractions, the coarse
hierarchy, the whole V-cycle and the CG vector shell.  Host-clock times of
chained programs; a profiler trace is the finer source.

Run: python -m tpusparse.bench.itprof [N] [reps]
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp


def timeit(name, fn, *args, reps=20, bytes_=None):
    """Chained in-jit timing (see bench/spmv.bench_op for rationale)."""

    @jax.jit
    def run(*a):
        def body(i, v):
            out = fn(*a[:-1], v)
            # keep a data dependency on a field-shaped output
            return jax.tree.leaves(out)[0]

        return jax.lax.fori_loop(0, reps, body, a[-1])

    jax.block_until_ready(run(*args))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(run(*args))
    dt = (time.perf_counter() - t0) / reps
    gbs = (bytes_ / dt / 1e9) if bytes_ else float("nan")
    print(f"{name:34s} {dt * 1e3:8.3f} ms   {gbs:7.1f} GB/s-effective")
    return dt


def main():
    from tpusparse.bench.device import require_gpu

    dev = require_gpu("itprof")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 20

    import numpy as np

    from tpusparse.amg.hierarchy import (
        AMGParams,
        gamg_setup_compiled,
        vcycle,
    )
    from tpusparse.grid.grid3d import Grid3D
    from tpusparse.grid.poisson import poisson_stencil

    grid = Grid3D(n, n, n)
    op, b, _ = poisson_stencil(grid, dtype=np.float32)
    b = b.astype(jnp.float32)
    hier = gamg_setup_compiled(op, AMGParams())
    jax.block_until_ready(hier.levels[-1].rho)

    field = n * n * n * 4  # one f32 field in bytes
    print(f"# {n}^3 on {dev['kind']}, one f32 field ="
          f" {field / 1e6:.1f} MB, reps={reps}")

    # --- ceilings -----------------------------------------------------------
    timeit("axpy (3-pass ceiling probe)",
           lambda a, x: a + 1.5 * x, b, b, reps=reps, bytes_=3 * field)
    timeit("dot <x,x> (1-pass probe)",
           lambda x: jnp.vdot(x.reshape(-1), x.reshape(-1)) + x,
           b, reps=reps, bytes_=field)

    # --- fine level ---------------------------------------------------------
    timeit("mv (XLA, 3-pass)",
           lambda o, x: o.mv(x), op, b, reps=reps, bytes_=3 * field)
    tr = hier.levels[0].transfer
    timeit("tT + t contractions (2 fine passes)",
           lambda t, s: t.t_apply(t.tT_apply(s)), tr, b, reps=reps,
           bytes_=2 * field)

    # --- coarse hierarchy (levels >= 1 only) ---------------------------------
    e_c = jnp.ones(tr.c_shape, jnp.float32)
    timeit("coarse vcycle (levels 1+)",
           lambda h, r: vcycle(h, r, level=1), hier, e_c, reps=reps)

    # --- whole preconditioner -----------------------------------------------
    timeit("vcycle (full M^-1 r)",
           lambda h, r: vcycle(h, r), hier, b, reps=reps)

    # --- one full inner CG iteration (production body) -----------------------
    def cg_iter(o, h, st):
        x, r, z, p, rz = st
        ap = o.mv(p)
        alpha = rz / jnp.vdot(p.reshape(-1), ap.reshape(-1))
        x = x + alpha * p
        r = r - alpha * ap
        z = vcycle(h, r)
        rz_new = jnp.vdot(r.reshape(-1), z.reshape(-1))
        beta = rz_new / rz
        p = z + beta * p
        rnorm = jnp.sqrt(jnp.vdot(r.reshape(-1), r.reshape(-1)))
        return (x, r, z, p, rz_new + 0 * rnorm)

    @jax.jit
    def run_cg(o, h, b):
        st = (b, b, b, b, jnp.float32(1.0))
        return jax.lax.fori_loop(
            0, reps, lambda i, st: cg_iter(o, h, st), st
        )[0]

    jax.block_until_ready(run_cg(op, hier, b))
    t0 = time.perf_counter()
    jax.block_until_ready(run_cg(op, hier, b))
    dt = (time.perf_counter() - t0) / reps
    print(f"{'FULL CG+AMG iteration':34s} {dt * 1e3:8.3f} ms")


if __name__ == "__main__":
    main()
