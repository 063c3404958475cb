#!/usr/bin/env python
"""Bring-up check: the 300^3 CG+GAMG solve and its kernels on one GPU.

Runs the main path once at the reference's size (300^3 = 27M unknowns)
through the entry points a user calls, checks each kernel on that path
against a float64 numpy reference built from ``--seed``, and prints one
line per phase.  Any failed check raises, so the script exits non-zero
before its last line, which on success is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

    python chip_smoke.py           # phases a-e on one GPU
    python chip_smoke.py --four    # the 4-GPU solve and the 1-GPU solve
                                   # it is compared with, nothing else

With no GPU it exits non-zero and prints no result.  It runs in one
process; its only child is ``nvidia-smi``, which does not touch the card's
memory.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

jax.config.update("jax_enable_x64", True)

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-8, 1e-12          # bench.py's headline tolerances
MV_TOL = {np.float32: 2e-6, np.float64: 1e-14}
TRANSFER_TOL = 1e-6


class SmokeFailure(AssertionError):
    """A phase's check did not hold."""


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def linf_limit(n: int) -> float:
    """Linf error bound for an n^3 solve: 1e-4 at the reference's 300^3,
    scaled by h^2 (the discretization error is O(h^2))."""
    return 1e-4 * (300.0 / n) ** 2


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# --- (a) device --------------------------------------------------------------

def phase_device() -> dict:
    """Print what JAX runs on; exit non-zero unless it is a GPU."""
    from tpusparse.bench.device import describe_device, require_gpu

    dev = describe_device()
    _say("a", f"platform={dev['platform']} kind={dev['kind']!r}"
              f" count={dev['count']}")
    require_gpu("chip_smoke")
    return dev


def card_line() -> str:
    """``name, power.limit`` of the card(s), as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _peak(tag: str) -> None:
    from tpusparse.bench.device import peak_bytes_in_use

    peak = peak_bytes_in_use()
    _say(tag, "peak_bytes_in_use="
              + ("not available" if peak is None else str(peak)))


def _report_line(tag: str, rep, card: str) -> None:
    from tpusparse.solve.cg import ConvergedReason

    try:
        reason = ConvergedReason(rep.reason).name
    except ValueError:
        reason = str(rep.reason)
    _say(tag, f"{rep.nx}x{rep.ny}x{rep.nz} mat={rep.mat_type} reason={reason}"
              f" inner={rep.iters} outer={rep.outer_iters}"
              f" linf={rep.linf_error:.6e} t_init={rep.t_init:.6f}"
              f" t_setup={rep.t_setup:.6f} t_solve={rep.t_solve:.6f}"
              f" devices={rep.devices} on {card}")


# --- (b) headline solve ------------------------------------------------------

def phase_headline(n: int, card: str):
    """bench.py's solve: CG+GAMG, rtol 1e-8, mixed precision."""
    from tpusparse.bench.driver import solve_poisson

    rep = solve_poisson(n, rtol=RTOL, atol=ATOL, pc="gamg")
    _report_line("b", rep, card)
    _peak("b")
    _check(rep.reason > 0, f"headline solve did not converge: {rep.reason}")
    _check(rep.linf_error <= linf_limit(n),
           f"headline Linf {rep.linf_error} > {linf_limit(n)}")
    return rep


# --- (c) reference option file ----------------------------------------------

def phase_reference_config(n: int, card: str) -> dict:
    """``python -m tpusparse -config configs/SolverOptions_GAMG.info`` in
    this process; rtol 1e-14 may end CONVERGED_STALLED (reason 100 > 0)."""
    from tpusparse.__main__ import main as cli_main

    argv = ["-da_grid_x", str(n), "-da_grid_y", str(n), "-da_grid_z", str(n),
            "-config", str(ROOT / "configs" / "SolverOptions_GAMG.info")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    text = buf.getvalue()
    _check(rc == 0, f"CLI returned {rc}")
    side = [ln for ln in text.splitlines() if ln.startswith("JSON:")]
    _check(len(side) == 1, "CLI printed no JSON sidecar")
    rep = json.loads(side[0][len("JSON:"):])
    _say("c", f"{n}^3 reference config: reason={rep['reason']}"
              f" inner={rep['iters']} outer={rep['outer_iters']}"
              f" linf={rep['linf_error']:.6e} t_init={rep['t_init']:.6f}"
              f" t_setup={rep['t_setup']:.6f} t_solve={rep['t_solve']:.6f}"
              f" on {card}")
    _check(rep["reason"] > 0, f"reference config: reason {rep['reason']}")
    _check(rep["linf_error"] <= linf_limit(n),
           f"reference config Linf {rep['linf_error']}")
    return rep


# --- (d) kernels against numpy float64 --------------------------------------

def star_mv_host(diag, cx, cy, cz, x, pinned):
    """The 7-point star apply in float64 numpy: zero outside the domain;
    a pinned row/column 0 keeps only its diagonal."""
    x = np.asarray(x, np.float64)
    diag = np.asarray(diag, np.float64)
    xn = x.copy()
    if pinned:
        xn[0, 0, 0] = 0.0
    y = diag * x
    for axis, c in ((2, cx), (1, cy), (0, cz)):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        y[tuple(lo)] += c * xn[tuple(hi)]
        y[tuple(hi)] += c * xn[tuple(lo)]
    if pinned:
        y[0, 0, 0] = diag[0, 0, 0] * x[0, 0, 0]
    return y


def star7_offsets(n: int) -> tuple[int, ...]:
    return (-n * n, -n, -1, 0, 1, n, n * n)


def host_csr_from_bands(bands: np.ndarray, offsets):
    """HostCSR of the DIA matrix bands[k, r] = A[r, r + offsets[k]]
    (``offsets`` ascending, so each row's entries come out column-sorted)."""
    from tpusparse.sparse.csr import HostCSR

    n = bands.shape[1]
    cols = np.arange(n, dtype=np.int64)[:, None] + np.asarray(offsets)[None]
    inside = (cols >= 0) & (cols < n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(inside.sum(axis=1), out=indptr[1:])
    return HostCSR(indptr=indptr, indices=cols[inside].astype(np.int32),
                   data=bands.T[inside].astype(np.float64), shape=(n, n))


def _rel_err(got, ref, scale) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / scale)


def device_time(fn, operand, x, reps: int = 20, trials: int = 5) -> float:
    """Seconds per ``fn(operand, x)`` call on the device: one jitted chain
    of ``reps`` calls, each output materialised (optimization barrier),
    best of ``trials`` chains; host clock around ``block_until_ready``.
    The operand is a jit argument, so XLA cannot fold its data into the
    program as a constant."""

    @jax.jit
    def chain(o, v):
        for _ in range(reps):
            v = lax.optimization_barrier(fn(o, v))
        return v

    jax.block_until_ready(chain(operand, x))
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(operand, x))
        best = min(best, time.perf_counter() - t0)
    return best / reps


def phase_kernels(n: int, seed: int, card: str) -> dict:
    """Each kernel of the solve path at n^3 against float64 numpy on the
    same data, plus device bandwidth of the XLA applies."""
    from tpusparse.amg.transfer import (
        StructuredTransfer,
        block_sum3,
        coarse_shape,
        expand3,
    )
    from tpusparse.sparse.dia import DIA
    from tpusparse.sparse.stencil import StarStencil3D

    rng = np.random.default_rng(seed)
    shape = (n, n, n)
    out: dict = {}

    # StarStencil3D.mv
    diag64 = -6.0 + rng.uniform(-0.5, 0.5, shape)
    x64 = rng.uniform(-1.0, 1.0, shape)
    cx, cy, cz = (float(c) for c in rng.uniform(0.5, 1.5, 3))
    for dt in (np.float32, np.float64):
        d, x = diag64.astype(dt), x64.astype(dt)
        op = StarStencil3D(diag=jnp.asarray(d), cx=jnp.asarray(cx, dt),
                           cy=jnp.asarray(cy, dt), cz=jnp.asarray(cz, dt),
                           pinned=True)
        ref = star_mv_host(d, dt(cx), dt(cy), dt(cz), x, pinned=True)
        got = jax.jit(lambda o, v: o.mv(v))(op, jnp.asarray(x))
        err = _rel_err(got, ref, np.abs(d).max() * np.abs(x).max())
        out[f"stencil_{np.dtype(dt).name}"] = err
        _say("d", f"StarStencil3D.mv {np.dtype(dt).name} {n}^3:"
                  f" err/(|diag|*|x|)={err:.3e} (limit {MV_TOL[dt]:.0e})")
        _check(err <= MV_TOL[dt], f"stencil mv {np.dtype(dt).name} err {err}")
    del diag64

    # 7-band DIA.mv against HostCSR.mv
    offsets = star7_offsets(n)
    bands64 = rng.uniform(-1.0, 1.0, (len(offsets), n ** 3))
    xf64 = x64.reshape(-1)
    for dt in (np.float32, np.float64):
        b, x = bands64.astype(dt), xf64.astype(dt)
        ref = host_csr_from_bands(b, offsets).mv(x.astype(np.float64))
        dia = DIA(bands=jnp.asarray(b), offsets=offsets, shape=(n ** 3,) * 2)
        got = jax.jit(lambda o, v: o.mv(v))(dia, jnp.asarray(x))
        err = _rel_err(got, ref, np.abs(b).max() * np.abs(x).max())
        out[f"dia_{np.dtype(dt).name}"] = err
        _say("d", f"DIA.mv 7-band {np.dtype(dt).name} {n}^3:"
                  f" err/(|bands|*|x|)={err:.3e} (limit {MV_TOL[dt]:.0e})")
        _check(err <= MV_TOL[dt], f"DIA mv {np.dtype(dt).name} err {err}")
        del ref, got, dia
    del bands64

    # StructuredTransfer T / T^T, n^3 <-> (n/3)^3, float32 (the V-cycle's)
    tr = StructuredTransfer.build(shape, 0.5, jnp.float32)
    c_shape = coarse_shape(shape)
    ec = rng.uniform(-1.0, 1.0, c_shape).astype(np.float32)
    r = x64.astype(np.float32)
    tnorm = np.asarray(tr.tnorm, np.float64)
    ref_t = _expand_host(ec * tnorm, shape)
    ref_tt = _block_sum_host(r.astype(np.float64), c_shape) * tnorm
    for name, fn, arg, ref in (
        ("t_apply", tr.t_apply, ec, ref_t),
        ("tT_apply", tr.tT_apply, r, ref_tt),
    ):
        got = jax.jit(fn)(jnp.asarray(arg))
        err = _rel_err(got, ref, np.abs(ref).max())
        out[name] = err
        _say("d", f"StructuredTransfer.{name} {n}^3<->{c_shape[0]}^3 f32"
                  f" HIGHEST: rel err={err:.3e} (limit {TRANSFER_TOL:.0e})")
        _check(err <= TRANSFER_TOL, f"{name} err {err}")
    sz, sy, sx = tr.sz, tr.sy, tr.sx
    dflt = lax.Precision.DEFAULT
    got_t = jax.jit(lambda e: expand3(e * tr.tnorm, sz, sy, sx, dflt))(ec)
    got_tt = jax.jit(lambda v: block_sum3(v, sz, sy, sx, dflt) * tr.tnorm)(r)
    out["t_apply_default"] = _rel_err(got_t, ref_t, np.abs(ref_t).max())
    out["tT_apply_default"] = _rel_err(got_tt, ref_tt, np.abs(ref_tt).max())
    _say("d", "transfers at precision=DEFAULT (documentation only):"
              f" t_apply rel err={out['t_apply_default']:.3e},"
              f" tT_apply rel err={out['tT_apply_default']:.3e}")
    del got_t, got_tt, ref_t, ref_tt

    out.update(_bandwidth(n, seed, card))
    return out


def _expand_host(ec, shape):
    x = ec
    for ax in range(3):
        x = np.repeat(x, 3, axis=ax)
    return x[: shape[0], : shape[1], : shape[2]]


def _block_sum_host(r, c_shape):
    pad = [(0, 3 * c - s) for c, s in zip(c_shape, r.shape)]
    x = np.pad(r, pad).reshape(c_shape[0], 3, c_shape[1], 3, c_shape[2], 3)
    return x.sum(axis=(1, 3, 5))


def _bandwidth(n: int, seed: int, card: str) -> dict:
    """GB/s of a field copy, the star mv and the 7-band DIA mv (float32,
    random data), each also as a share of the copy's rate.  Bytes are
    each apply's compulsory traffic: the copy reads x and writes y; the
    star mv reads x and diag and writes y; the DIA mv reads x and the K
    bands and writes y."""
    from tpusparse.sparse.dia import DIA
    from tpusparse.sparse.stencil import StarStencil3D

    rng = np.random.default_rng(seed + 1)
    f = 4
    nn = n ** 3
    offsets = star7_offsets(n)
    x = jnp.asarray(rng.uniform(-1.0, 1.0, (n, n, n)), jnp.float32)
    op = StarStencil3D(
        diag=jnp.asarray(rng.uniform(-6.5, -5.5, (n, n, n)), jnp.float32),
        cx=jnp.float32(1.0), cy=jnp.float32(1.0), cz=jnp.float32(1.0),
        pinned=True)
    dia = DIA(bands=jnp.asarray(rng.uniform(-1.0, 1.0, (len(offsets), nn))
                                / len(offsets), jnp.float32),
              offsets=offsets, shape=(nn, nn))
    cases = (
        ("copy", lambda c, v: v * c, jnp.float32(0.999), x, 2 * nn * f),
        ("stencil_mv", lambda o, v: o.mv(v) * jnp.float32(1 / 12), op, x,
         3 * nn * f),
        ("dia_mv", lambda o, v: o.mv(v), dia, x.reshape(-1),
         (len(offsets) + 2) * nn * f),
    )
    rates = {}
    for name, fn, operand, arg, nbytes in cases:
        sec = device_time(fn, operand, arg)
        rates[name] = nbytes / sec
        share = rates[name] / rates["copy"]
        _say("d", f"{name} f32 {n}^3: {sec * 1e3:.4f} ms,"
                  f" {rates[name] / 1e9:.1f} GB/s,"
                  f" {100 * share:.1f}% of copy rate (on {card})")
    return {f"{k}_GBps": v / 1e9 for k, v in rates.items()}


# --- (e) general matrix path -------------------------------------------------

def phase_general(n: int, card: str):
    """``bench_aij.py --nodetect``: the assembled matrix through the general
    banded executor and unstructured GAMG, no structure detection."""
    from tpusparse.bench.driver import solve_poisson

    rep = solve_poisson(n, rtol=RTOL, atol=ATOL, pc="gamg", mat_type="aij",
                        structure_detect=False)
    _report_line("e", rep, card)
    _say("e", f"setup breakdown: {rep.setup_breakdown}")
    _peak("e")
    _check(rep.reason > 0, f"general-matrix solve: reason {rep.reason}")
    _check(rep.linf_error <= linf_limit(n),
           f"general-matrix Linf {rep.linf_error}")
    return rep


# --- --four: 4-device solve against the 1-device solve ----------------------

def phase_four(n: int, card: str):
    """The GSPMD (z, y) 2x2 solve against the single-device solve."""
    from tpusparse.bench.driver import solve_poisson

    rep4 = solve_poisson(n, rtol=RTOL, atol=ATOL, pc="gamg", n_devices=4)
    _report_line("four", rep4, card)
    rep1 = solve_poisson(n, rtol=RTOL, atol=ATOL, pc="gamg")
    _report_line("four", rep1, card)
    _check(rep4.devices == 4, f"solution spans {rep4.devices} devices")
    _check(rep4.reason > 0 and rep1.reason > 0,
           f"reasons {rep4.reason} / {rep1.reason}")
    _check(abs(rep4.iters - rep1.iters) <= 2,
           f"inner iterations {rep4.iters} vs {rep1.iters}")
    lim = linf_limit(n)
    _check(rep4.linf_error <= lim and rep1.linf_error <= lim,
           f"Linf {rep4.linf_error} / {rep1.linf_error} > {lim}")
    _check(abs(rep4.linf_error - rep1.linf_error)
           <= 0.01 * max(rep4.linf_error, rep1.linf_error),
           f"Linf differ by more than 1%: {rep4.linf_error} vs"
           f" {rep1.linf_error}")
    _say("four", f"4-device vs 1-device: inner {rep4.iters} vs {rep1.iters},"
                 f" linf {rep4.linf_error:.6e} vs {rep1.linf_error:.6e}")
    return rep4, rep1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU solve and its 1-GPU comparison")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel checks' random data")
    args = ap.parse_args(argv)
    n = 300   # the reference's grid, uncut

    from tpusparse.utils.compile_cache import enable_compile_cache

    dev = phase_device()
    enable_compile_cache()
    card = card_line()
    _say("a", f"card: {card}")
    if args.four:
        _check(dev["count"] >= 4, f"--four needs 4 GPUs, found {dev['count']}")
        phases = (("four", lambda: phase_four(n, card)),)
    else:
        phases = (
            ("b", lambda: phase_headline(n, card)),
            ("c", lambda: phase_reference_config(n, card)),
            ("d", lambda: phase_kernels(n, args.seed, card)),
            ("e", lambda: phase_general(n, card)),
        )
    for tag, run in phases:
        t0 = time.perf_counter()
        run()
        _say(tag, f"passed; wall {time.perf_counter() - t0:.1f} s"
                  " including compilation")
    print(card)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
