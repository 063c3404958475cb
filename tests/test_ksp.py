"""KSP object API (PETSc KSPCreate/SetOperators/SetUp/Solve parity,
src/main_ksp.cpp:92-117) — the reusable-solver surface, including
KSPSetReusePreconditioner semantics (:95)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse import KSP, Grid3D
from tpusparse.grid.poisson import assemble_poisson, poisson_stencil_device


def _system(n=24):
    grid = Grid3D(n, n, n)
    op, b, exact = poisson_stencil_device(grid)
    return grid, op, b, exact


@pytest.mark.slow
def test_structured_solve_and_accessors():
    """CG+GAMG through the object API reaches the manufactured solution,
    and the Get* accessors mirror the result."""
    _, op, b, exact = _system()
    ksp = KSP(rtol=1e-8)
    ksp.set_operators(op)
    res = ksp.solve(b)
    assert res.converged and res.reason > 0
    assert float(jnp.abs(res.x - exact).max()) < 6e-2  # O(h^2) at 24^3
    assert ksp.iterations == res.iters
    assert ksp.residual_norm == res.resnorm
    assert ksp.converged_reason == res.reason


def test_reuse_across_rhs():
    """Second solve with a different RHS reuses the hierarchy (no second
    setup) and the compiled program; linearity checks the answer."""
    _, op, b, _ = _system()
    ksp = KSP(rtol=1e-10)
    ksp.set_operators(op).setup()
    pc_first = ksp._pc_state
    x1 = ksp.solve(b).x
    x2 = ksp.solve(2.0 * b).x
    assert ksp._pc_state is pc_first  # KSPSetReusePreconditioner(TRUE)
    assert float(jnp.abs(x2 - 2.0 * x1).max()) <= 1e-6 * float(
        jnp.abs(x1).max()
    )


@pytest.mark.slow
def test_reuse_preconditioner_across_operators():
    """PETSc semantics: with reuse on, set_operators keeps the old PC; with
    reuse off, the next solve rebuilds it."""
    _, op, b, _ = _system()
    ksp = KSP(rtol=1e-8)
    ksp.set_operators(op).setup()
    pc_first = ksp._pc_state
    ksp.set_operators(op)  # re-attach: PC must survive (reuse on)
    assert ksp._pc_state is pc_first
    res = ksp.solve(b)
    assert res.converged

    ksp_fresh = KSP(rtol=1e-8, reuse_preconditioner=False)
    ksp_fresh.set_operators(op).setup()
    pc_a = ksp_fresh._pc_state
    ksp_fresh.set_operators(op)
    assert ksp_fresh._pc_state is None  # dropped; next solve rebuilds
    res = ksp_fresh.solve(b)
    assert res.converged and ksp_fresh._pc_state is not pc_a


@pytest.mark.slow
def test_initial_guess_nonzero():
    """x0 support (KSPSetInitialGuessNonzero): starting at the answer takes
    ~0 work; starting anywhere still converges to it."""
    _, op, b, exact = _system()
    ksp = KSP(rtol=1e-8)
    ksp.set_operators(op)
    x_ref = ksp.solve(b).x
    # warm start from the solution: immediate convergence
    res = ksp.solve(b, x0=x_ref)
    assert res.converged
    assert res.outer_iters <= 1 and res.iters <= 2
    assert float(jnp.abs(res.x - x_ref).max()) < 1e-8
    # warm start from garbage: same answer
    res2 = ksp.solve(b, x0=jnp.ones_like(b))
    assert float(jnp.abs(res2.x - x_ref).max()) < 1e-6


@pytest.mark.slow
def test_flat_vectors_roundtrip():
    """Structured operators apply on the field view; flat RHS in -> flat
    solution out."""
    grid, op, b, exact = _system(16)
    ksp = KSP(rtol=1e-8)
    ksp.set_operators(op)
    x = ksp.solve(b.reshape(-1)).x
    assert x.ndim == 1 and x.shape[0] == 16**3
    assert float(jnp.abs(x.reshape(grid.shape) - exact).max()) < 2e-1


@pytest.mark.slow
def test_host_csr_general_path():
    """A HostCSR (or scipy matrix) routes through the unstructured GAMG
    setup + DIA containers and solves to the same answer."""
    grid = Grid3D(16, 16, 16)
    a, b_np, exact_np = assemble_poisson(grid, dtype=np.float64)
    ksp = KSP(rtol=1e-8)
    ksp.set_operators(a)
    res = ksp.solve(jnp.asarray(b_np))
    assert res.converged
    assert float(jnp.abs(res.x - jnp.asarray(exact_np)).max()) < 2e-1


def test_from_options():
    """KSPSetFromOptions parity: an Options built from CLI words configures
    the object."""
    from tpusparse.config import load_options

    opts = load_options(
        ["-ksp_type", "cg", "-ksp_rtol", "1e-7", "-pc_type", "jacobi",
         "-precision", "f64"]
    )
    ksp = KSP.from_options(opts)
    assert ksp.ksp_type == "cg" and ksp.pc_type == "jacobi"
    assert ksp.rtol == 1e-7 and ksp.precision == "f64"
    _, op, b, _ = _system(12)
    import jax

    op64 = jax.tree.map(
        lambda l: l.astype(jnp.float64)
        if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.floating)
        else l,
        op,
    )
    res = ksp.set_operators(op64).solve(b.astype(jnp.float64))
    assert res.converged


def test_error_if_not_converged():
    """-ksp_error_if_not_converged parity: negative reason raises."""
    from tpusparse.bench.driver import DivergedError

    _, op, b, _ = _system(12)
    ksp = KSP(
        rtol=1e-12, maxiter=3, precision="f64", pc_type="none",
        error_if_not_converged=True,
    )
    ksp.set_operators(op)
    with pytest.raises(DivergedError):
        ksp.solve(b)


def test_requires_operator_and_solve():
    ksp = KSP()
    with pytest.raises(RuntimeError, match="set_operators"):
        ksp.setup()
    with pytest.raises(RuntimeError, match="no solve"):
        _ = ksp.iterations


@pytest.mark.slow
def test_reuse_swap_keeps_preconditioner():
    """KSPSetReusePreconditioner + operator swap: the kept hierarchy
    preconditions the swapped-in (scaled, same-grid) operator."""
    import numpy as np

    from tpusparse.grid.poisson import poisson_stencil

    import jax

    g = Grid3D(16, 16, 16)
    op, b, _ = poisson_stencil(g)
    ksp = KSP(rtol=1e-7)
    ksp.set_operators(op)
    r1 = ksp.solve(b)
    assert r1.converged
    # swap in a scaled twin (same grid): PC kept
    op_scaled = jax.tree.map(
        lambda x: 1.5 * x if hasattr(x, "dtype") and x.dtype.kind == "f"
        else x, op,
    )
    ksp.set_operators(op_scaled)
    r2 = ksp.solve(1.5 * b)           # same solution, scaled system
    assert r2.converged
    np.testing.assert_allclose(
        np.asarray(r2.x), np.asarray(r1.x), rtol=3e-4, atol=1e-6
    )  # two independent rtol-1e-7 solves of the scaled pair


@pytest.mark.slow
def test_no_reuse_swap_invalidates_mat_solve_twin():
    """reuse_preconditioner=False + operator swap must not leave mat_solve
    preconditioning the new operator with the OLD operator's hierarchy."""
    import jax.numpy as jnp
    import numpy as np

    from tpusparse.grid.poisson import poisson_stencil

    g = Grid3D(12, 12, 12)
    op, b, _ = poisson_stencil(g)
    import jax

    ksp = KSP(rtol=1e-8, precision="f64", reuse_preconditioner=False)
    ksp.set_operators(op)
    res1 = ksp.mat_solve(jnp.stack([b.reshape(-1)]))
    assert bool(res1.reason[0] > 0)
    op_scaled = jax.tree.map(
        lambda x: 3.0 * x if hasattr(x, "dtype") and x.dtype.kind == "f"
        else x, op,
    )
    ksp.set_operators(op_scaled)
    assert ksp._pc_state is None  # PC dropped with the operator
    res2 = ksp.mat_solve(jnp.stack([(3.0 * b).reshape(-1)]))
    assert bool(res2.reason[0] > 0)
    np.testing.assert_allclose(
        np.asarray(res2.x[0]), np.asarray(res1.x[0]), rtol=1e-6, atol=1e-8
    )
