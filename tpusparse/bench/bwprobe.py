"""Raw device-memory bandwidth probes — the GPU's real elementwise ceiling.

Run: python -m tpusparse.bench.bwprobe
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def timeit(name, fn, *args, reps=30, bytes_=None):
    @jax.jit
    def run(*a):
        return jax.lax.fori_loop(
            0, reps, lambda i, v: fn(*a[:-1], v), a[-1]
        )

    jax.block_until_ready(run(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(run(*args))
    dt = (time.perf_counter() - t0) / reps
    gbs = (bytes_ / dt / 1e9) if bytes_ else float("nan")
    print(f"{name:44s} {dt * 1e3:8.3f} ms   {gbs:7.1f} GB/s")
    return dt


def main():
    from tpusparse.bench.device import require_gpu

    dev = require_gpu("bwprobe")
    print(f"# {dev['kind']}")
    for mb in (64, 143, 512):
        nrows = mb * 1024 * 1024 // (4 * 512)
        a = jnp.ones((nrows, 512), jnp.float32)
        sz = a.size * 4
        timeit(f"copy-ish x+1 ({mb} MB, 2-pass)",
               lambda x: x + 1.0, a, bytes_=2 * sz)
        timeit(f"axpy a+1.5x ({mb} MB, 3-pass)",
               lambda c, x: c + 1.5 * x, a * 2, a, bytes_=3 * sz)
        timeit(f"triad a+b*x ({mb} MB, 4-pass)",
               lambda c, d, x: c + d * x, a * 2, a * 3, a, bytes_=4 * sz)
        timeit(f"reduce sum ({mb} MB, 1-pass)",
               lambda x: x * 0 + jnp.sum(x), a, bytes_=sz)

    # the solver's 300^3 field
    for shape in ((300, 300, 300),):
        a = jnp.ones(shape, jnp.float32)
        sz = a.size * 4
        timeit(f"axpy 3-D {shape} (3-pass)",
               lambda c, x: c + 1.5 * x, a * 2, a, bytes_=3 * sz)

    # bf16
    nrows = 512 * 1024 * 1024 // (2 * 512)
    a16 = jnp.ones((nrows, 512), jnp.bfloat16)
    timeit("axpy bf16 (512 MB, 3-pass)",
           lambda c, x: c + jnp.bfloat16(1.5) * x, a16 * 2, a16,
           bytes_=3 * a16.size * 2)


if __name__ == "__main__":
    main()
