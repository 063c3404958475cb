"""KSPCHEBYSHEV — Chebyshev semi-iteration as a top-level KSP.

PETSc exposes the Chebyshev polynomial iteration both as the standard MG
smoother (our ``amg/hierarchy._smooth``) and as a KSP type in its own
right: dot-product-free per iteration (one A-apply + one M-apply + vector
updates), which makes it the latency-free alternative to CG when
collective reductions dominate — on a multi-GPU mesh, an iteration with NO
``psum`` on the critical path.  The convergence-check norm here is
computed every iteration for the PETSc ``KSPConvergedDefault`` contract
(costing the dot back); a production latency-sensitive caller can raise
``check_every`` to amortize it.

Eigenvalue bounds: Chebyshev needs ``[lo, hi]`` enclosing the spectrum of
M A.  When not given, a power iteration estimates rho(M A) and PETSc's
default transform is applied (``KSPChebyshevEstEig`` hint ``0.1, 1.1``:
lo = 0.1 rho, hi = 1.1 rho) — the same bounds recipe the AMG smoother
uses.  Both A and M may be negative definite together (the reference's
A = nabla^2 sign convention): the iteration only sees M A, whose spectrum
is positive for a definite pair.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from tpusparse.solve.cg import CGResult, ConvergedReason, _dot

__all__ = ["chebyshev"]


def chebyshev(
    a_mv: Callable,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    emin: float | None = None,
    emax: float | None = None,
    est_iters: int = 25,
    divtol: float = 1e5,
    history: bool = False,
) -> CGResult:
    """Solve A x = b with the preconditioned Chebyshev iteration.

    ``emin``/``emax``: spectrum bounds of M A.  Omitted => a deterministic
    ``est_iters``-step power iteration estimates rho(M A), then
    lo = 0.1 rho, hi = 1.1 rho (PETSc's KSPChebyshevEstEig default
    transform).  Same contract as ``cg`` otherwise (CGResult, PETSc
    converged reasons, jit-compatible, optional residual ``history``).
    """
    if m_mv is None:
        m_mv = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)

    dt = b.dtype
    bnorm = jnp.sqrt(_dot(b, b)).astype(dt)
    tol = jnp.maximum(jnp.asarray(rtol, dt) * bnorm, jnp.asarray(atol, dt))
    dgate = (
        jnp.asarray(divtol, dt) * bnorm if divtol and divtol > 0
        else jnp.asarray(jnp.inf, dt)
    )

    if emax is None and emin is not None:
        raise ValueError(
            "emin without emax: the auto-estimate would silently discard"
            " the supplied lower bound — give both bounds or neither"
        )
    if emax is None:
        # rho(M A) by power iteration — deterministic non-smooth start
        # (estimate_rho_dinv_a's recipe, generalized to any SPD/negative-
        # definite pair via the Rayleigh quotient <v, M A v>/<v, v>)
        n = b.size
        v0 = jnp.sin(
            jnp.arange(n, dtype=dt) * 0.7 + 0.3
        ).reshape(b.shape)

        def pbody(_, v):
            w = m_mv(a_mv(v))
            return w / jnp.sqrt(_dot(w, w))

        v = jax.lax.fori_loop(
            0, est_iters, pbody, v0 / jnp.sqrt(_dot(v0, v0))
        )
        rho = _dot(v, m_mv(a_mv(v))).astype(dt)  # v normalized
        lo = 0.1 * rho
        hi = 1.1 * rho
    else:
        lo = jnp.asarray(emin if emin is not None else 0.1 * emax, dt)
        hi = jnp.asarray(emax, dt)

    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma1 = theta / delta

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

    def cond(state):
        rnorm, it = state[4], state[5]
        return classify(rnorm, it) == jnp.int32(ConvergedReason.ITERATING)

    def body(state):
        x, r, d, rho_k, _rn, it = state[:6]
        # first step: d = M r / theta; later: the two-term recurrence
        rho_new = jnp.where(
            it == 0, 1.0 / sigma1, 1.0 / (2.0 * sigma1 - rho_k)
        ).astype(dt)
        z = m_mv(r)
        d = jnp.where(
            it == 0,
            z / theta,
            rho_new * rho_k * d + (2.0 * rho_new / delta) * z,
        )
        x = x + d
        r = r - a_mv(d)
        rnorm = jnp.sqrt(_dot(r, r))
        new = (x, r, d, rho_new, rnorm, it + 1)
        if history:
            new += (state[6].at[it + 1].set(rnorm.astype(jnp.float32)),)
        return new

    r0 = b - a_mv(x0)
    rnorm0 = jnp.sqrt(_dot(r0, r0))
    state = (
        x0, r0, jnp.zeros_like(b), jnp.asarray(1.0, dt), rnorm0,
        jnp.int32(0),
    )
    if history:
        hist0 = jnp.zeros((maxiter + 1,), jnp.float32)
        state += (hist0.at[0].set(rnorm0.astype(jnp.float32)),)
    out = jax.lax.while_loop(cond, body, state)
    x, rnorm, it = out[0], out[4], out[5]
    result = CGResult(
        x=x, iters=it, resnorm=rnorm, reason=classify(rnorm, it),
        bnorm=bnorm,
    )
    if history:
        return result, out[6]
    return result
