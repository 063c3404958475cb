"""Pipelined preconditioned CG (Ghysels & Vanroose) — one fused reduction
per iteration.

Why it exists: classic PCG pays two dependent reduction points per iteration
((r,z) then (p,Ap)); on a large device mesh each is an allreduce on
the critical path.  The reference pays the same cost as two MPI_Allreduce
calls inside every KSPSolve iteration (SURVEY.md section 5.8, traffic class
2).  The pipelined recurrence computes gamma = (r,u), delta = (w,u) and
||r||^2 from the *same* vectors, so XLA can fuse all three into a single
collective round, and the operator/preconditioner applies (m = M w,
n = A m) are data-independent of the reduction results — the compiler can
overlap them with the collective.

Trade-off (same as PETSc's KSPPIPECG): one extra operator + preconditioner
apply per iteration worth of recurrence bookkeeping (n = A M w), and weaker
numerical stability — the extra recurrences drift from the true quantities as
iterations accumulate (measured on the chip: 2-3x extra iterations at ~500+
unpreconditioned iterations).  The standard cure, implemented here, is
periodic **residual replacement** (Ghysels & Vanroose section 4): every
``replace_every`` iterations recompute r, u, w, s, q, z from their
definitions.  The amortized cost is ~3/replace_every extra operator applies
per iteration; with AMG preconditioning (tens of iterations) replacement
rarely triggers at all.

Caveat (an inherited measurement, not repeated on the GPU): *unpreconditioned*
many-hundred-iteration pipelined runs can stagnate where classic CG
converges.  Use pipelined CG in its intended regime — preconditioned solves
with few dozen iterations — or classic ``cg`` for long unpreconditioned
runs.

Reference: Ghysels & Vanroose, "Hiding global synchronization latency in the
preconditioned Conjugate Gradient algorithm", Parallel Computing 40 (2014).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from tpusparse.solve.cg import CGResult, ConvergedReason, _dot


def cg_pipelined(
    a_mv: Callable,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    replace_every: int = 50,
    history: bool = False,
    scalar_dtype=None,
    divtol: float = 1e5,
) -> CGResult:
    """Solve A x = b with pipelined PCG.  Same contract as ``cg``:
    convergence on ||r||_2 <= max(rtol*||b||_2, atol), PETSc-style
    converged-reason codes, jit-compatible with static tolerances.

    ``replace_every``: residual-replacement period (0 disables).
    ``history=True`` additionally returns the ``(maxiter+1,)`` f32 residual
    norm history (KSPMonitor data, as in ``cg``).
    ``scalar_dtype``: dtype for the RECURRENCE SCALARS (gamma/delta/alpha/
    beta) — the pipelined algorithm's extra recurrences amplify rounding in
    exactly these quantities (the ``delta - beta*gamma/alpha`` denominator
    cancels catastrophically in f32), so an f32 solve can carry f64 scalars
    at negligible cost (a handful of scalar ops per iteration; the vectors
    and dots stay f32).  Default: b's dtype."""
    if m_mv is None:
        m_mv = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)

    dt = b.dtype
    sdt = jnp.dtype(scalar_dtype) if scalar_dtype is not None else dt

    bnorm = jnp.sqrt(_dot(b, b)).astype(dt)
    tol = jnp.maximum(jnp.asarray(rtol, dt) * bnorm, jnp.asarray(atol, dt))
    dgate = (
        jnp.asarray(divtol, dt) * bnorm if divtol and divtol > 0
        else jnp.asarray(jnp.inf, dt)
    )

    r0 = b - a_mv(x0)
    u0 = m_mv(r0)
    w0 = a_mv(u0)
    gamma0 = _dot(r0, u0).astype(sdt)
    rnorm0 = jnp.sqrt(_dot(r0, r0))

    def classify(rnorm, it):
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

    zeros = jnp.zeros_like(b)
    one = jnp.ones((), sdt)

    def cond(state):
        rnorm, it = state[10], state[11]
        return classify(rnorm, it) == jnp.int32(ConvergedReason.ITERATING)

    def body(state):
        (x, r, u, w, z, q, p, s, gamma, alpha_old, _rnorm, it,
         first) = state[:13]
        # the two applies are independent of this iteration's reductions
        m = m_mv(w)
        n = a_mv(m)
        # ONE fused reduction round: gamma_new, delta (and ||r|| below) all
        # reduce over vectors available now — a single collective when sharded
        delta = _dot(w, u).astype(sdt)
        gamma_new = _dot(r, u).astype(sdt)  # state's gamma = previous iter's
        beta = jnp.where(first, jnp.zeros((), sdt), gamma_new / gamma)
        alpha = gamma_new / jnp.where(
            first, delta, delta - beta * gamma_new / alpha_old
        )
        beta_v = beta.astype(dt)
        alpha_v = alpha.astype(dt)
        z = n + beta_v * z
        q = m + beta_v * q
        p = u + beta_v * p
        s = w + beta_v * s
        x = x + alpha_v * p
        r = r - alpha_v * s
        u = u - alpha_v * q
        w = w - alpha_v * z

        if replace_every:
            # periodic residual replacement (Ghysels & Vanroose section 4):
            # re-anchor every recurrence-maintained vector on its definition,
            # killing the drift that otherwise costs extra iterations
            def replaced(args):
                x, p = args
                r = b - a_mv(x)
                u = m_mv(r)
                w = a_mv(u)
                s = a_mv(p)
                q = m_mv(s)
                z = a_mv(q)
                return r, u, w, s, q, z

            do = (it + 1) % replace_every == 0
            r, u, w, s, q, z = jax.lax.cond(
                do,
                replaced,
                lambda args: (r, u, w, s, q, z),
                (x, p),
            )
        rnorm = jnp.sqrt(_dot(r, r))
        new = (x, r, u, w, z, q, p, s, gamma_new, alpha,
               rnorm, it + 1, jnp.bool_(False))
        if history:
            new += (state[13].at[it + 1].set(rnorm.astype(jnp.float32)),)
        return new

    state = (
        x0, r0, u0, w0, zeros, zeros, zeros, zeros,
        gamma0, one, rnorm0, jnp.int32(0), jnp.bool_(True),
    )
    if history:
        hist0 = jnp.zeros((maxiter + 1,), jnp.float32)
        state += (hist0.at[0].set(rnorm0.astype(jnp.float32)),)
    out = jax.lax.while_loop(cond, body, state)
    x, rnorm, it = out[0], out[10], out[11]
    result = CGResult(
        x=x, iters=it, resnorm=rnorm, reason=classify(rnorm, it), bnorm=bnorm
    )
    if history:
        return result, out[13]
    return result
