"""Preconditioned conjugate-gradient solver — KSP/CG parity, jit-native.

Parity target: the reference's solver setup (``src/main_ksp.cpp:92-117``):
KSPCG with atol/rtol/max_it from the options file
(``configs/PETSc_SolverOptions_GAMG.info:1-4``), a converged-reason API that
distinguishes rtol/atol convergence from iteration-limit/NaN divergence, and
iteration-count + final-residual reporting.

Design: the whole solve is ONE ``lax.while_loop`` inside ``jit`` — no
per-iteration host round-trips (the reference pays a kernel launch + MPI
allreduce per dot; here XLA fuses the axpy/dot chains and keeps everything in
device memory).  The operator and preconditioner are passed as pytrees + apply
functions, so the same solver body serves stencil, ELL, and sharded operators.

Sign note: the reference assembles a *negative*-definite Laplacian
(``src/helper.cpp:229-233``).  CG's recurrences are sign-symmetric (alpha and
beta stay positive when both A and M are definite with matching sign), so we
solve the system exactly as assembled, like PETSc does.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp


class ConvergedReason(enum.IntEnum):
    """Mirrors PETSc's KSPConvergedReason sign convention (> 0 converged,
    < 0 diverged) for the codes the reference checks
    (``src/main_ksp.cpp:109-111``)."""

    CONVERGED_RTOL = 2
    CONVERGED_ATOL = 3
    # no PETSc counterpart: defect correction reached the attainable
    # true-residual floor (~ eps * ||A|| ||x|| / ||b||) before rtol.  PETSc's
    # CG at the same config keeps iterating on the RECURRENCE residual, which
    # falls below the floor the true residual cannot cross — this reason
    # makes the distinction explicit instead of mislabeling it divergence.
    # Value 100 is deliberately OUTSIDE PETSc's KSPConvergedReason range
    # (1..10) so it can never be confused with a PETSc code (6 would collide
    # with KSP_CONVERGED_STEP_LENGTH).  Note it is still positive: callers
    # gating on reason > 0 accept a stalled solve; callers that require
    # rtol/atol to have been MET must check for this value explicitly.
    CONVERGED_STALLED = 100
    CONVERGED_ITS = 4       # -ksp_norm_type none: ran the requested its
    ITERATING = 0
    DIVERGED_ITS = -3
    DIVERGED_DTOL = -4
    DIVERGED_NANORINF = -9


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["x", "iters", "resnorm", "reason", "bnorm"],
    meta_fields=[],
)
@dataclasses.dataclass
class CGResult:
    x: jax.Array
    iters: jax.Array     # int32
    resnorm: jax.Array   # final true-residual 2-norm
    reason: jax.Array    # int32, ConvergedReason value
    bnorm: jax.Array

    def converged(self) -> bool:
        return int(self.reason) > 0


def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Flattened dot — deterministic XLA reduction (one psum when sharded)."""
    return jnp.vdot(a.reshape(-1), b.reshape(-1))


def cg(
    a_mv: Callable,
    b: jax.Array,
    x0: jax.Array | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    state0: tuple | None = None,
    return_state: bool = False,
    history: bool = False,
    check_every: int = 1,
    spectrum: bool = False,
    divtol: float = 1e5,
    norm_type: str = "unpreconditioned",
) -> CGResult:
    """Solve A x = b with (preconditioned) CG.

    ``a_mv(x)`` applies the operator; ``m_mv(r)`` applies the preconditioner
    (defaults to identity).  Convergence: ||r||_2 <= max(rtol*||b||_2, atol)
    on the *unpreconditioned* residual, checked every iteration, and
    ||r||_2 >= divtol*||b||_2 reports DIVERGED_DTOL — the full PETSc
    KSPConvergedDefault test (divtol default 1e5 = PETSc's; <= 0 disables;
    the reference ratio is against rnorm0, which equals ||b|| for the
    zero initial guess every entry point uses — warm starts solve the
    defect system, where the defect norm IS rnorm0).

    ``return_state=True`` additionally returns the full Krylov state tuple;
    passing it back as ``state0`` resumes the iteration *exactly* (same
    conjugacy history — used by solve/checkpoint.py).  The state's iteration
    counter is chunk-local, so a resumed call runs up to ``maxiter`` MORE
    iterations.

    ``history=True`` additionally returns a ``(maxiter+1,)`` f32 array of
    per-iteration residual 2-norms (index 0 = initial residual; entries past
    ``result.iters`` are zero) — the KSPMonitor data
    (PETSc ``-ksp_monitor``); incompatible with ``state0``.

    ``norm_type`` (-ksp_norm_type): "unpreconditioned" (the default —
    KSPConvergedDefault on ||r||_2, matching the reference's residual
    reporting), "preconditioned" (||r||_{M} = sqrt(<r, z>) — PETSc CG's
    own default norm; one fewer reduction per iteration since <r, z> is
    already computed), or "none" (no convergence tests: run exactly
    ``maxiter`` iterations and report CONVERGED_ITS, PETSc KSP_NORM_NONE).

    ``check_every`` runs that many CG iterations per convergence check
    (PETSc checks every iteration = the default 1).  Each dynamic-loop
    trip carries a fixed cost on the device, which a larger value
    amortizes; the solve may then run up to check_every-1 iterations past
    the tolerance
    (harmless for CG: extra iterations only reduce the residual; NaN/dtol
    states propagate unchanged) and past ``maxiter`` by the same margin.

    ``spectrum=True`` additionally returns the ``(maxiter,)`` per-iteration
    CG scalars ``(alphas, betas)`` — the Lanczos tridiagonal data PETSc's
    ``-ksp_compute_eigenvalues`` uses (``solve/spectrum.py`` turns them
    into Ritz values of the preconditioned operator M A); incompatible
    with ``state0``/``return_state``/``history``.

    Jit-compatible: call under ``jax.jit``; ``maxiter`` must be static,
    ``rtol``/``atol`` may be python floats or traced scalars (the adaptive
    inner tolerances in solve/refine.py pass traced values).
    """
    if m_mv is None:
        m_mv = lambda r: r
    if history and state0 is not None:
        raise ValueError("history=True is incompatible with state0 resume")
    if history and return_state:
        raise ValueError(
            "history=True is incompatible with return_state=True (the"
            " state tuple would be returned where the caller expects the"
            " history array)"
        )
    if spectrum and (history or return_state or state0 is not None):
        raise ValueError(
            "spectrum=True is incompatible with history/return_state/"
            "state0 (each changes what the extra return slot carries)"
        )
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if norm_type not in ("unpreconditioned", "preconditioned", "none"):
        raise ValueError(f"unknown norm_type {norm_type!r}")
    if check_every > 1 and (history or spectrum):
        raise ValueError(
            "check_every > 1 is incompatible with history/spectrum (the"
            " per-iteration trace arrays are sized by maxiter, which an"
            " unchecked sub-iteration may overrun)"
        )

    if x0 is None:
        x0 = jnp.zeros_like(b)  # reference zeroes the initial guess (helper.cpp:48)

    dt = b.dtype
    bnorm = jnp.sqrt(_dot(b, b)).astype(dt)
    tol = jnp.maximum(jnp.asarray(rtol, dt) * bnorm, jnp.asarray(atol, dt))
    dgate = (
        jnp.asarray(divtol, dt) * bnorm if divtol and divtol > 0
        else jnp.asarray(jnp.inf, dt)
    )

    if state0 is None:
        r0 = b - a_mv(x0)
        z0 = m_mv(r0)
        rz0 = _dot(r0, z0)
        rnorm0 = jnp.sqrt(_dot(r0, r0))
        if norm_type == "preconditioned":
            rnorm0 = jnp.sqrt(jnp.abs(rz0))

    def classify(rnorm, it):
        if norm_type == "none":
            # KSP_NORM_NONE: no residual tests at all — the solve runs its
            # budget and reports it (NaN still surfaces via the state)
            return jnp.where(
                ~jnp.isfinite(rnorm),
                jnp.int32(ConvergedReason.DIVERGED_NANORINF),
                jnp.where(
                    it >= maxiter,
                    jnp.int32(ConvergedReason.CONVERGED_ITS),
                    jnp.int32(ConvergedReason.ITERATING),
                ),
            )
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
        rnorm, it = state[5], state[6]
        return classify(rnorm, it) == jnp.int32(ConvergedReason.ITERATING)

    def body(state):
        x, r, z, p, rz, _rnorm, it = state[:7]
        ap = a_mv(p)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = m_mv(r)
        rz_new = _dot(r, z)
        rnorm = jnp.sqrt(_dot(r, r))
        if norm_type == "preconditioned":
            rnorm = jnp.sqrt(jnp.abs(rz_new))
        beta = rz_new / rz
        p = z + beta * p
        new = (x, r, z, p, rz_new, rnorm, it + 1)
        if history:
            new += (state[7].at[it + 1].set(rnorm.astype(jnp.float32)),)
        if spectrum:
            al, be = state[7], state[8]
            new += (
                al.at[it].set(alpha.astype(jnp.float64)),
                be.at[it].set(beta.astype(jnp.float64)),
            )
        return new

    if state0 is None:
        state = (x0, r0, z0, z0, rz0, rnorm0, jnp.int32(0))
        if history:
            hist0 = jnp.zeros((maxiter + 1,), jnp.float32)
            state += (hist0.at[0].set(rnorm0.astype(jnp.float32)),)
        if spectrum:
            state += (
                jnp.zeros((maxiter,), jnp.float64),
                jnp.zeros((maxiter,), jnp.float64),
            )
    else:
        state = state0

    if check_every > 1:
        def body_many(state):
            for _ in range(check_every):
                state = body(state)
            return state

        out = jax.lax.while_loop(cond, body_many, state)
    else:
        out = jax.lax.while_loop(cond, body, state)
    x, rnorm, it = out[0], out[5], out[6]

    result = CGResult(
        x=x,
        iters=it,
        resnorm=rnorm,
        reason=classify(rnorm, it),
        bnorm=bnorm,
    )
    if return_state:
        return result, out[:7]
    if history:
        return result, out[7]
    if spectrum:
        return result, (out[7], out[8])
    return result


def cg_hostloop(
    a_apply: Callable,
    op,
    b: jax.Array,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_apply: Callable | None = None,
    m_state=None,
    chunk: int = 64,
) -> CGResult:
    """CG as fixed-trip ``fori_loop`` chunks with host-side convergence checks.

    ``a_apply(op, x)`` applies the operator; ``m_apply(m_state, r)`` the
    preconditioner (identity when None).  Operator/preconditioner state is
    passed as explicit pytree ARGUMENTS (never closures — closed-over device
    arrays get baked into the HLO as literal constants).

    Same math and convergence contract as ``cg`` (the chunks carry the exact
    Krylov state, so the iteration sequence is identical up to the check
    granularity).  Written for the accelerator this was first built for,
    whose runtime failed on gather-based operators (ELL/COO/BSR mv) inside
    a ``lax.while_loop`` at >= ~2M rows while fixed-trip ``fori_loop``
    bodies ran (an inherited limit, not measured on the GPU); no entry
    point routes here any more.  Costs
    one dispatch per ``chunk`` iterations and may run up to chunk-1 extra
    iterations past convergence.

    NOT jit-compatible as a whole (it IS the host loop); each chunk is one
    jitted program, cached across calls via the usual jit cache.
    """
    import numpy as _np

    if m_apply is None:
        m_apply = lambda _ms, r: r
        m_state = jnp.zeros(())

    dt = b.dtype
    bnorm = jnp.sqrt(_dot(b, b)).astype(dt)
    tol = jnp.maximum(jnp.asarray(rtol, dt) * bnorm, jnp.asarray(atol, dt))

    @jax.jit
    def start(op, m_state, b):
        x0 = jnp.zeros_like(b)
        r0 = b
        z0 = m_apply(m_state, r0)
        return (x0, r0, z0, z0, _dot(r0, z0), jnp.sqrt(_dot(r0, r0)))

    @partial(jax.jit, static_argnames=("n",))
    def run_chunk(op, m_state, state, n: int):
        def body(_i, st):
            x, r, z, p, rz, _rn = st
            ap = a_apply(op, p)
            alpha = rz / _dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            z = m_apply(m_state, r)
            rz_new = _dot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            return (x, r, z, p, rz_new, jnp.sqrt(_dot(r, r)))

        return jax.lax.fori_loop(0, n, body, state)

    state = start(op, m_state, b)
    it = 0
    rnorm = state[5]
    while it < maxiter:
        n = min(chunk, maxiter - it)
        rn = float(rnorm)
        if not _np.isfinite(rn) or rn <= float(tol):
            break
        state = run_chunk(op, m_state, state, n)
        rnorm = state[5]
        it += n

    rn = float(rnorm)
    if not _np.isfinite(rn):
        reason = jnp.int32(ConvergedReason.DIVERGED_NANORINF)
    elif rn <= float(jnp.asarray(atol, dt)):
        reason = jnp.int32(ConvergedReason.CONVERGED_ATOL)
    elif rn <= float(tol):
        reason = jnp.int32(ConvergedReason.CONVERGED_RTOL)
    else:
        reason = jnp.int32(ConvergedReason.DIVERGED_ITS)
    return CGResult(
        x=state[0],
        iters=jnp.int32(it),
        resnorm=rnorm,
        reason=reason,
        bnorm=bnorm,
    )
