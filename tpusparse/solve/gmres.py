"""Restarted GMRES — KSPGMRES parity, jit-native.

PETSc's default KSP type; the reference's own config selects CG (its
operator is SPD), but a general-matrix framework needs the nonsymmetric
workhorse (``-ksp_type gmres -ksp_gmres_restart k``) — the DIA/ELL general
containers (``sparse/dia.py``) make nonsymmetric operators first-class here.

Design decisions:

- the Krylov basis is ONE dense (restart+1, n) array, so orthogonalization
  is two matrix products per step, at full float32 precision (CGS2 —
  classical Gram-Schmidt applied twice) instead of the j-length sequential
  dot chain of modified Gram-Schmidt: numerically equivalent to MGS for
  practical purposes and far better shaped for the hardware;
- the Hessenberg least-squares problem is carried as Givens rotations
  updated per step (all O(restart^2) scalars — negligible), giving the
  per-iteration residual estimate |g[j+1]| without forming Q or R;
- the whole solve is one ``lax.while_loop`` over restart cycles with a
  ``lax.fori_loop`` over the inner steps, masked after convergence — no
  host round-trips (PETSc pays per-iteration reductions + control flow).

Preconditioning is LEFT (PETSc's GMRES default): convergence is gated on
the PRECONDITIONED residual norm (KSP_NORM_PRECONDITIONED semantics).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from tpusparse.solve.cg import CGResult, ConvergedReason, _dot

# basis products at full precision: a float32 product may otherwise run in
# TF32 on a GPU, which would spoil the orthogonalization
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def gmres(
    a_mv: Callable,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    restart: int = 30,
    m_mv: Callable | None = None,
    divtol: float = 1e5,
    history: bool = False,
) -> CGResult:
    """Solve A x = b with left-preconditioned restarted GMRES(restart).

    Same result contract as ``cg``.  ``history=True`` additionally returns
    the ``(maxiter+1,)`` f32 preconditioned-residual norm history.
    """
    if m_mv is None:
        m_mv = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)

    dt = b.dtype
    shape = b.shape
    n = b.size
    m = int(restart)

    def pres(x):
        return m_mv(b - a_mv(x))  # preconditioned residual M(b - Ax)

    bnorm = jnp.sqrt(_dot(m_mv(b), m_mv(b))).astype(dt)
    tol = jnp.maximum(jnp.asarray(rtol, dt) * bnorm, jnp.asarray(atol, dt))
    dgate = (
        jnp.asarray(divtol, dt) * bnorm if divtol and divtol > 0
        else jnp.asarray(jnp.inf, dt)
    )

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

    hist0 = (
        jnp.zeros((maxiter + 1,), jnp.float32) if history else jnp.zeros((0,))
    )

    def cycle(carry):
        x, rnorm, it, hist = carry
        r = pres(x)
        beta = jnp.sqrt(_dot(r, r)).astype(dt)
        safe = jnp.where(beta > 0, beta, jnp.ones((), dt))
        v = jnp.zeros((m + 1, n), dt)
        v = v.at[0].set((r / safe).reshape(-1))
        h = jnp.zeros((m + 1, m), dt)
        cs = jnp.zeros((m,), dt)
        sn = jnp.zeros((m,), dt)
        g = jnp.zeros((m + 1,), dt).at[0].set(beta)

        def step(j, st):
            v, h, cs, sn, g, rn, it, hist, filled, active = st
            # skip the operator + preconditioner applies once converged —
            # with a heavyweight M the masked-but-executed tail of a cycle
            # would otherwise cost up to a full extra cycle of dead work
            w = jax.lax.cond(
                active,
                lambda vj: m_mv(a_mv(vj.reshape(shape))).reshape(-1),
                lambda vj: jnp.zeros((n,), dt),
                v[j],
            )
            # CGS2: two rounds of classical Gram-Schmidt as matrix
            # products.  Unfilled basis rows are zero, so masking is
            # automatic.
            c1 = _mm(v, w)
            w = w - _mm(v.T, c1)
            c2 = _mm(v, w)
            w = w - _mm(v.T, c2)
            hj = c1 + c2                          # (m+1,) coefficients
            wnorm = jnp.sqrt(jnp.vdot(w, w)).astype(dt)
            hj = hj.at[j + 1].set(wnorm)
            wsafe = jnp.where(wnorm > 0, wnorm, jnp.ones((), dt))
            v = v.at[j + 1].set(w / wsafe)

            # apply the accumulated Givens rotations to the new column
            def rot(i, col):
                a_, b_ = col[i], col[i + 1]
                return col.at[i].set(cs[i] * a_ + sn[i] * b_).at[i + 1].set(
                    -sn[i] * a_ + cs[i] * b_
                )

            hj = jax.lax.fori_loop(0, j, rot, hj)
            denom = jnp.sqrt(hj[j] ** 2 + hj[j + 1] ** 2)
            dsafe = jnp.where(denom > 0, denom, jnp.ones((), dt))
            c_new = jnp.where(denom > 0, hj[j] / dsafe, jnp.ones((), dt))
            s_new = jnp.where(denom > 0, hj[j + 1] / dsafe, jnp.zeros((), dt))
            hj = hj.at[j].set(c_new * hj[j] + s_new * hj[j + 1]).at[
                j + 1].set(0.0)
            g_j = g[j]
            g_new = g.at[j].set(c_new * g_j).at[j + 1].set(-s_new * g_j)
            rn_new = jnp.abs(g_new[j + 1])

            cs = jnp.where(active, cs.at[j].set(c_new), cs)
            sn = jnp.where(active, sn.at[j].set(s_new), sn)
            h = jnp.where(active, h.at[:, j].set(hj), h)
            g = jnp.where(active, g_new, g)
            rn = jnp.where(active, rn_new, rn)
            it = jnp.where(active, it + 1, it)
            filled = jnp.where(active, filled.at[j].set(True), filled)
            if history:
                hist = jnp.where(
                    active, hist.at[it].set(rn.astype(jnp.float32)), hist
                )
            still = classify(rn, it) == jnp.int32(ConvergedReason.ITERATING)
            return (v, h, cs, sn, g, rn, it, hist, filled, active & still)

        st = (v, h, cs, sn, g, rnorm, it, hist,
              jnp.zeros((m,), jnp.bool_),
              classify(rnorm, it) == jnp.int32(ConvergedReason.ITERATING))
        v, h, cs, sn, g, rnorm, it, hist, filled, _ = jax.lax.fori_loop(
            0, m, step, st
        )

        # back-substitute R y = g on the m x m triangle (tiny, on device).
        # Column validity is tracked EXPLICITLY (the per-step filled mask):
        # unfilled columns AND filled columns whose rotated diagonal is
        # exactly zero (lucky breakdown at step j — indistinguishable from
        # unfilled by inspecting h alone) get a unit diagonal injected and
        # their y entries masked out, so no spurious v_j coefficient can
        # enter the update.
        diag = jnp.diagonal(h[:m, :])
        valid = filled & (jnp.abs(diag) > 0)
        # zero invalid columns entirely (their above-diagonal entries must
        # not couple into other y entries) and give them a unit diagonal
        hs = jnp.where(valid[None, :], h[:m, :], jnp.zeros((), dt)) + jnp.diag(
            jnp.where(valid, 0.0, 1.0).astype(dt)
        )
        y = jax.scipy.linalg.solve_triangular(hs, g[:m], lower=False)
        y = jnp.where(valid, y, jnp.zeros((), dt))
        x = x + _mm(v[:m].T, y).reshape(shape)
        return (x, rnorm, it, hist)

    def cond(carry):
        _x, rnorm, it, _h = carry
        return classify(rnorm, it) == jnp.int32(ConvergedReason.ITERATING)

    r0 = pres(x0)
    rn0 = jnp.sqrt(_dot(r0, r0)).astype(dt)
    if history:
        hist0 = hist0.at[0].set(rn0.astype(jnp.float32))
    x, rnorm, it, hist = jax.lax.while_loop(
        cond, cycle, (x0, rn0, jnp.int32(0), hist0)
    )
    result = CGResult(
        x=x, iters=it, resnorm=rnorm, reason=classify(rnorm, it),
        bnorm=bnorm,
    )
    if history:
        return result, hist
    return result
