"""Block (multi-right-hand-side) solves — PETSc ``KSPMatSolve`` parity.

PETSc grew ``KSPMatSolve`` (solve A X = B for a dense block of right-hand
sides) because solving k systems one at a time wastes the operator's
memory traffic: every CG iteration re-streams the matrix for a single
vector.  Here the batched form is structurally better still — one
batched apply streams the stencil/band coefficients ONCE for all k
columns (operator memory traffic amortized k-fold) and
the per-column scalar recurrences become (k,)-vector ops.

The iteration here is per-column MASKED independent CG — not a shared-
Krylov-space "block CG" — so each column converges in exactly the
iterations the single-RHS solver would take, and converged columns are
frozen (their updates masked out) while the rest finish.  That masking is
what a naive ``jax.vmap(cg)`` does NOT give you: a batched
``while_loop`` keeps executing the body for already-converged columns,
which (a) corrupts their iteration counts and (b) risks 0/0 breakdown
once a column's residual underflows.

``cg_multi`` is the uniform-precision block solver; ``refined_multi`` is
the block form of mixed-precision defect correction (``solve/refine.py``)
with per-column outer gates, stall detection, and adaptive inner
tolerances (``rtol``/``atol`` may be per-column (k,) arrays throughout).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from tpusparse.solve.cg import ConvergedReason

__all__ = ["MultiResult", "cg_multi", "refined_multi"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["x", "iters", "outer_iters", "resnorm", "reason", "bnorm"],
    meta_fields=[],
)
@dataclasses.dataclass
class MultiResult:
    """Per-column results: every field's leading axis is the k columns."""

    x: jax.Array         # (k, ...) solutions
    iters: jax.Array     # (k,) int32 — per-column (inner) iterations
    outer_iters: jax.Array  # (k,) int32 — refinement sweeps (0 for cg_multi)
    resnorm: jax.Array   # (k,) final residual 2-norms
    reason: jax.Array    # (k,) int32 ConvergedReason values
    bnorm: jax.Array     # (k,)

    def all_converged(self) -> bool:
        return bool(jnp.all(self.reason > 0))


def _bdot(u: jax.Array, v: jax.Array) -> jax.Array:
    """Per-column dot: reduce every axis but the leading k."""
    k = u.shape[0]
    return jnp.sum(u.reshape(k, -1) * v.reshape(k, -1), axis=1)


def _bc(m: jax.Array, ref: jax.Array) -> jax.Array:
    """Broadcast a (k,) column mask/scalar onto ref's (k, ...) shape."""
    return m.reshape(m.shape + (1,) * (ref.ndim - 1))


def _classify_cols(rnorm, it, tol, atol, maxiter, dt, dgate):
    """Elementwise ConvergedReason over the k columns (the single-RHS
    solver's chain incl. the divtol branch, broadcast)."""
    return jnp.where(
        ~jnp.isfinite(rnorm),
        jnp.int32(ConvergedReason.DIVERGED_NANORINF),
        jnp.where(
            rnorm <= jnp.asarray(atol, dt),
            jnp.int32(ConvergedReason.CONVERGED_ATOL),
            jnp.where(
                rnorm <= tol,
                jnp.int32(ConvergedReason.CONVERGED_RTOL),
                jnp.where(
                    rnorm >= dgate,
                    jnp.int32(ConvergedReason.DIVERGED_DTOL),
                    jnp.where(
                        it >= maxiter,
                        jnp.int32(ConvergedReason.DIVERGED_ITS),
                        jnp.int32(ConvergedReason.ITERATING),
                    ),
                ),
            ),
        ),
    )


def cg_multi(
    a_mv: Callable,
    b: jax.Array,
    *,
    rtol=1e-5,
    atol=1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    batched_ops: bool = False,
    divtol: float = 1e5,
) -> MultiResult:
    """Masked block CG: solve A x_i = b_i for every column b = B[i].

    ``a_mv``/``m_mv`` apply to ONE column (they are vmapped here);
    pass ``batched_ops=True`` if they already accept the (k, ...) stack.
    ``rtol``/``atol`` may be scalars or per-column (k,) arrays.
    Convergence per column: ||r_i|| <= max(rtol_i*||b_i||, atol_i), the
    single-RHS solver's KSPConvergedDefault semantics.  Jit-compatible.
    """
    mv = a_mv if batched_ops else jax.vmap(a_mv)
    if m_mv is None:
        pc = lambda r: r
    else:
        pc = m_mv if batched_ops else jax.vmap(m_mv)

    dt = b.dtype
    bnorm = jnp.sqrt(_bdot(b, b)).astype(dt)
    rtol = jnp.asarray(rtol, dt)
    atol_a = jnp.asarray(atol, dt)
    tol = jnp.maximum(rtol * bnorm, atol_a)
    dgate = (
        jnp.asarray(divtol, dt) * bnorm if divtol and divtol > 0
        else jnp.full_like(bnorm, jnp.inf)
    )

    r0 = b  # x0 = 0 (the reference zeroes the guess, helper.cpp:48)
    z0 = pc(r0)
    rz0 = _bdot(r0, z0)
    rnorm0 = jnp.sqrt(_bdot(r0, r0))

    classify = lambda rn, it: _classify_cols(
        rn, it, tol, atol_a, maxiter, dt, dgate
    )

    def cond(state):
        rnorm, it = state[5], state[6]
        return jnp.any(
            classify(rnorm, it) == jnp.int32(ConvergedReason.ITERATING)
        )

    def body(state):
        x, r, z, p, rz, rnorm, it = state
        act = classify(rnorm, it) == jnp.int32(ConvergedReason.ITERATING)
        ap = mv(p)
        pap = _bdot(p, ap)
        # frozen columns get alpha = 0 (state provably unchanged) and a
        # non-zero denominator (their true pap may underflow to 0/0)
        alpha = jnp.where(act, rz / jnp.where(act, pap, 1.0), 0.0).astype(dt)
        x = x + _bc(alpha, x) * p
        r = r - _bc(alpha, r) * ap
        z_new = pc(r)
        rz_new = _bdot(r, z_new)
        beta = jnp.where(act, rz_new / jnp.where(act, rz, 1.0), 0.0).astype(dt)
        actn = _bc(act, p)
        p = jnp.where(actn, z_new + _bc(beta, p) * p, p)
        z = jnp.where(actn, z_new, z)
        rz = jnp.where(act, rz_new, rz)
        rnorm = jnp.where(act, jnp.sqrt(_bdot(r, r)), rnorm)
        it = it + act.astype(jnp.int32)
        return (x, r, z, p, rz, rnorm, it)

    k = b.shape[0]
    state = (
        jnp.zeros_like(b), r0, z0, z0, rz0, rnorm0,
        jnp.zeros((k,), jnp.int32),
    )
    x, _, _, _, _, rnorm, it = jax.lax.while_loop(cond, body, state)
    return MultiResult(
        x=x,
        iters=it,
        outer_iters=jnp.zeros((k,), jnp.int32),
        resnorm=rnorm,
        reason=classify(rnorm, it),
        bnorm=bnorm,
    )


def refined_multi(
    a_hi_mv: Callable,
    a_lo_mv: Callable,
    b: jax.Array,
    *,
    rtol=1e-14,
    atol=1e-12,
    max_outer: int = 12,
    inner_rtol: float = 1e-5,
    inner_maxiter: int = 200,
    m_lo_mv: Callable | None = None,
    lo_dtype=jnp.float32,
    batched_ops: bool = False,
    divtol: float = 1e5,
) -> MultiResult:
    """Block mixed-precision defect correction (``cg_refined`` per column,
    masked): f32 block-CG inners under per-column f64 outer gates, with the
    single-RHS path's adaptive inner tolerance and stall detection.

    Apply functions are single-column unless ``batched_ops``.
    """
    mv_hi = a_hi_mv if batched_ops else jax.vmap(a_hi_mv)

    from tpusparse.solve.refine import _norm_fast

    bnorm_fast = jax.vmap(_norm_fast)

    dt = b.dtype
    k = b.shape[0]
    bnorm = bnorm_fast(b)
    rtol = jnp.asarray(rtol, dt)
    atol_a = jnp.asarray(atol, dt)
    tol = jnp.maximum(rtol * bnorm, atol_a)
    dgate = (
        jnp.asarray(divtol, dt) * bnorm if divtol and divtol > 0
        else jnp.full_like(bnorm, jnp.inf)
    )

    def classify(rnorm, prev, outer):
        stalled = (outer >= 2) & (rnorm > 0.5 * prev)
        return jnp.where(
            ~jnp.isfinite(rnorm),
            jnp.int32(ConvergedReason.DIVERGED_NANORINF),
            jnp.where(
                rnorm <= atol_a,
                jnp.int32(ConvergedReason.CONVERGED_ATOL),
                jnp.where(
                    rnorm <= tol,
                    jnp.int32(ConvergedReason.CONVERGED_RTOL),
                    jnp.where(
                        # a genuine blow-up must NOT be mislabeled as the
                        # attainable-accuracy stall: dtol outranks it
                        # (same ordering as cg_refined)
                        rnorm >= dgate,
                        jnp.int32(ConvergedReason.DIVERGED_DTOL),
                        jnp.where(
                            stalled,
                            jnp.int32(ConvergedReason.CONVERGED_STALLED),
                            jnp.where(
                                outer >= max_outer,
                                jnp.int32(ConvergedReason.DIVERGED_ITS),
                                jnp.int32(ConvergedReason.ITERATING),
                            ),
                        ),
                    ),
                ),
            ),
        )

    def cond(state):
        rnorm, prev, outer = state[2], state[3], state[4]
        return jnp.any(
            classify(rnorm, prev, outer)
            == jnp.int32(ConvergedReason.ITERATING)
        )

    def body(state):
        x, r, rnorm, prev, outer, tot = state
        act = classify(rnorm, prev, outer) == jnp.int32(
            ConvergedReason.ITERATING
        )
        r_lo = (r / _bc(rnorm, r)).astype(lo_dtype)
        # adaptive per-column inner tolerance (solve/refine.py rule);
        # frozen columns solve to the loosest gate so they cost ~nothing
        need = jnp.clip(0.25 * tol / rnorm, inner_rtol, 0.5)
        need = jnp.where(act, need, 0.5).astype(jnp.float32)
        res = cg_multi(
            a_lo_mv, r_lo, rtol=need, maxiter=inner_maxiter,
            m_mv=m_lo_mv, batched_ops=batched_ops,
        )
        e = res.x.astype(dt) * _bc(rnorm, res.x)
        x = jnp.where(_bc(act, x), x + e, x)
        r_new = b - mv_hi(x)  # one high-precision block apply per sweep
        r = jnp.where(_bc(act, r), r_new, r)
        rn = jnp.where(act, bnorm_fast(r), rnorm)
        prev = jnp.where(act, rnorm, prev)
        outer = outer + act.astype(jnp.int32)
        tot = tot + jnp.where(act, res.iters, 0)
        return (x, r, rn, prev, outer, tot)

    x0 = jnp.zeros_like(b)
    state = (
        x0, b, bnorm_fast(b), jnp.full((k,), jnp.inf, dt),
        jnp.zeros((k,), jnp.int32), jnp.zeros((k,), jnp.int32),
    )
    x, _, rnorm, prev, outer, tot = jax.lax.while_loop(cond, body, state)
    return MultiResult(
        x=x,
        iters=tot,
        outer_iters=outer,
        resnorm=rnorm,
        reason=classify(rnorm, prev, outer),
        bnorm=bnorm,
    )
