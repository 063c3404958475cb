"""SpMV microbenchmark — per-chip GB/s and nnz/s (BASELINE.json metric).

Benchmarks both storage strategies on the 7-point Poisson operator:
- padded-ELL (general sparse; MatMult_SeqAIJ-style row kernel), and
- the structured stencil form (gather-free),
reporting achieved bandwidth against the pessimistic traffic models in
``utils/metrics.py``.  Run on the GPU:

    python -m tpusparse.bench.spmv [N] [reps]
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp


def bench_op(name, fn, *args, flops, bytes_, nnz, reps=20):
    """Time ``reps`` chained applications inside ONE jitted program.

    Per-dispatch latency is comparable to the kernels being measured, so
    timing eager dispatches per rep would measure dispatch, not the device.
    Chaining y -> fn(y) inside a fori_loop amortizes dispatch and keeps
    data dependencies so XLA cannot elide iterations.
    """
    from tpusparse.utils.metrics import KernelStats

    op, x = args

    @jax.jit
    def run(op, x):
        return jax.lax.fori_loop(0, reps, lambda i, v: fn(op, v), x)

    jax.block_until_ready(run(op, x))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(run(op, x))
    dt = (time.perf_counter() - t0) / reps
    return KernelStats(name=name, seconds=dt, flops=flops, bytes=bytes_, nnz=nnz)


def run(n: int = 300, reps: int = 20, dtype=jnp.float64):
    from tpusparse.grid.grid3d import Grid3D
    from tpusparse.grid.poisson import assemble_poisson, poisson_stencil
    from tpusparse.sparse.ell import ELL
    from tpusparse.utils.metrics import (
        ell_mv_traffic,
        spmv_flops,
        stencil_mv_traffic,
    )

    grid = Grid3D(n, n, n)
    vb = jnp.dtype(dtype).itemsize
    stats = []

    # stencil form
    op, b, _ = poisson_stencil(grid, dtype=jnp.dtype(dtype).type)
    mv = jax.jit(lambda o, x: o.mv(x))
    nnz7 = 7 * grid.n - 2 * (  # interior entries actually stored
        grid.ny * grid.nz + grid.nx * grid.nz + grid.nx * grid.ny
    )
    stats.append(
        bench_op(
            f"stencil7_mv_{n}^3_{jnp.dtype(dtype).name}", mv, op, b,
            flops=spmv_flops(nnz7, grid.n),
            bytes_=stencil_mv_traffic(grid.n, vb),
            nnz=nnz7, reps=reps,
        )
    )

    # DIA form: the gather-free GENERAL-matrix container (sparse/dia.py)
    from tpusparse.sparse.dia import DIA

    a, bh, _ = assemble_poisson(grid, dtype=jnp.dtype(dtype).type)
    dia = DIA.from_csr(a)
    xd = jnp.asarray(bh)
    stats.append(
        bench_op(
            f"dia{len(dia.offsets)}_mv_{n}^3_{jnp.dtype(dtype).name}",
            lambda d, x: d.mv(x), dia, xd,
            flops=spmv_flops(a.nnz, grid.n),
            # traffic: K band reads + K shifted x streams + y write
            bytes_=(2 * len(dia.offsets) + 1) * grid.n * vb,
            nnz=a.nnz, reps=reps,
        )
    )

    # ELL form (width 8)
    ell = ELL.from_csr(a, width=8)
    x = jnp.asarray(bh)
    mv_ell = jax.jit(lambda e, x: e.mv(x))
    stats.append(
        bench_op(
            f"ell8_mv_{n}^3_{jnp.dtype(dtype).name}", mv_ell, ell, x,
            flops=spmv_flops(a.nnz, grid.n),
            bytes_=ell_mv_traffic(grid.n, 8, vb),
            nnz=a.nnz, reps=reps,
        )
    )
    return stats


def main():
    from tpusparse.bench.device import require_gpu

    jax.config.update("jax_enable_x64", True)
    require_gpu("spmv")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    for dtype in (jnp.float32, jnp.float64):
        for s in run(n, reps, dtype):
            print(s.line())


if __name__ == "__main__":
    main()
