"""MINRES — PETSc ``KSPMINRES`` parity (symmetric, possibly INDEFINITE A).

CG (the reference's solver, ``configs/PETSc_SolverOptions_GAMG.info:1``)
requires SPD A; PETSc users reach for MINRES when the operator is
symmetric but indefinite (Helmholtz shifts, saddle points, interior
eigenproblem shifts) — minimizing ``||b - A x||`` over the Krylov space
instead of the A-norm error.  This is the Paige–Saunders algorithm with an
SPD preconditioner M: one A-apply + one M-apply per iteration, a 3-term
Lanczos recurrence, and a Givens-QR update of the solution — all
fixed-shape vector ops, so the whole loop jits to a single device program
like ``cg``.

Convergence follows PETSc's KSPMINRES norm convention
(KSP_NORM_PRECONDITIONED): the recurrence scalar ``phibar`` equals the
M-inner-product residual norm sqrt(<r, M r>), gated against
``max(rtol * phibar0, atol)``.  The returned ``resnorm`` is the TRUE
unpreconditioned ``||b - A x||_2`` (one extra apply after the loop), so
callers gate on honest numbers.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from tpusparse.solve.cg import CGResult, ConvergedReason, _dot

__all__ = ["minres"]


def minres(
    a_mv: Callable,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    history: bool = False,
    divtol: float = 1e5,
) -> CGResult:
    """Solve A x = b, A symmetric (indefinite allowed), M SPD.

    Same contract as ``cg``: jit-compatible, ``CGResult`` with PETSc
    converged reasons.  ``m_mv`` must be symmetric DEFINITE (the Lanczos
    inner product is <., M .>): a negative-definite M — the framework's
    GAMG V-cycle on the reference's A = nabla^2 sign convention — is
    auto-negated (see the body note); a genuinely indefinite M surfaces
    as DIVERGED_NANORINF from the sqrt of a sign-flipped <r, Mr>.

    ``history=True`` additionally returns the ``(maxiter+1,)`` f32 per-
    iteration PRECONDITIONED residual norms (``phibar`` — what PETSc's
    ``-ksp_monitor`` prints for MINRES' norm type), index 0 = initial.
    """
    if m_mv is None:
        m_mv = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)

    dt = b.dtype
    eps = jnp.asarray(jnp.finfo(dt).tiny * 16, dt)
    bnorm = jnp.sqrt(_dot(b, b)).astype(dt)

    r1 = b - a_mv(x0)
    y_raw = m_mv(r1)
    beta1_sq_raw = _dot(r1, y_raw)
    # A NEGATIVE-definite M is auto-negated: the reference assembles
    # A = nabla^2 (diag = -sum of neighbors, src/helper.cpp:229-233), so A
    # and its GAMG V-cycle preconditioner are both negative definite — CG's
    # alpha/beta ratios cancel the signs, but Lanczos needs sqrt(<r, Mr>).
    # -M is SPD there and preconditioned MINRES with -M solves the same
    # system (M only shapes the Lanczos inner product).  Only a genuinely
    # INDEFINITE M (sign flips mid-iteration) is an error, as in PETSc
    # (KSP_DIVERGED_INDEFINITE_PC).
    msign = jnp.where(beta1_sq_raw < 0, -1.0, 1.0).astype(dt)
    pc = lambda v: msign * m_mv(v)
    y0 = msign * y_raw
    beta1_sq = msign * beta1_sq_raw
    beta1 = jnp.sqrt(jnp.maximum(beta1_sq, 0.0)).astype(dt)
    # gate on the preconditioned norm (PETSc KSP_NORM_PRECONDITIONED)
    tol = jnp.maximum(jnp.asarray(rtol, dt) * beta1, jnp.asarray(atol, dt))
    dgate = (
        jnp.asarray(divtol, dt) * beta1 if divtol and divtol > 0
        else jnp.asarray(jnp.inf, dt)
    )

    def classify(phibar, it):
        # indefinite M surfaces as phibar = NaN (set where <r, Mr> < 0)
        return jnp.where(
            ~jnp.isfinite(phibar),
            jnp.int32(ConvergedReason.DIVERGED_NANORINF),
            jnp.where(
                phibar <= jnp.asarray(atol, dt),
                jnp.int32(ConvergedReason.CONVERGED_ATOL),
                jnp.where(
                    phibar <= tol,
                    jnp.int32(ConvergedReason.CONVERGED_RTOL),
                    jnp.where(
                        phibar >= dgate,
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

    def cond(state):
        phibar, it = state[12], state[13]
        return classify(phibar, it) == jnp.int32(ConvergedReason.ITERATING)

    def body(state):
        (x, r1_, r2, y, w, w2, oldb, beta, dbar, epsln,
         cs, sn, phibar, it) = state[:14]
        # Lanczos step: v = y/beta; y <- M (A v - (beta/oldb) r1 -
        # (alfa/beta) r2) via the numerically-stable two-stage form
        v = y / beta
        ay = a_mv(v)
        ay = ay - jnp.where(it > 0, beta / oldb, 0.0) * r1_
        alfa = _dot(v, ay).astype(dt)
        ay = ay - (alfa / beta) * r2
        r1n, r2n = r2, ay
        yn = pc(r2n)
        oldbn = beta
        beta_sq = _dot(r2n, yn).astype(dt)
        betan = jnp.sqrt(jnp.maximum(beta_sq, 0.0))
        nanb = beta_sq < 0  # indefinite M mid-iteration

        # previous rotation applied to the new Lanczos column
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsn = sn * betan
        dbarn = -cs * betan
        # current rotation
        gamma = jnp.maximum(jnp.sqrt(gbar * gbar + betan * betan), eps)
        csn = gbar / gamma
        snn = betan / gamma
        phi = csn * phibar
        phibarn = snn * phibar
        # solution update
        w1 = w2
        wn = (v - oldeps * w1 - delta * w) / gamma
        xn = x + phi * wn
        phibarn = jnp.where(nanb, jnp.asarray(jnp.nan, dt), phibarn)
        new = (xn, r1n, r2n, yn, wn, w, oldbn, betan, dbarn, epsn,
               csn, snn, phibarn, it + 1)
        if history:
            new += (state[14].at[it + 1].set(phibarn.astype(jnp.float32)),)
        return new

    zero = jnp.asarray(0.0, dt)
    state = (
        x0, r1, r1, y0, jnp.zeros_like(b), jnp.zeros_like(b),
        zero, beta1, zero, zero,
        jnp.asarray(-1.0, dt), zero, beta1, jnp.int32(0),
    )
    if history:
        hist0 = jnp.zeros((maxiter + 1,), jnp.float32)
        state += (hist0.at[0].set(beta1.astype(jnp.float32)),)
    # beta1 == 0 means r0 = 0 (or M r0 = 0): already converged; guard the
    # division inside the body by skipping the loop entirely
    state = jax.lax.while_loop(
        lambda s: cond(s) & (beta1 > 0), body, state
    )
    x, phibar, it = state[0], state[12], state[13]
    rnorm_true = jnp.sqrt(_dot(b - a_mv(x), b - a_mv(x))).astype(dt)
    result = CGResult(
        x=x,
        iters=it,
        resnorm=rnorm_true,
        reason=classify(phibar, it),
        bnorm=bnorm,
    )
    if history:
        return result, state[14]
    return result
