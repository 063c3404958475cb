"""bf16 V-cycle preconditioning: same convergence behavior, half the bytes."""

import jax
import jax.numpy as jnp
import numpy as np

from tpusparse.amg import AMGParams, gamg_setup, vcycle
from tpusparse.amg.hierarchy import cast_hierarchy
from tpusparse.grid.grid3d import Grid3D
from tpusparse.grid.poisson import poisson_stencil
from tpusparse.solve import cg
import pytest


@pytest.mark.slow
def test_bf16_vcycle_preconditions():
    grid = Grid3D(24, 24, 24)
    op, b, exact = poisson_stencil(grid, dtype=np.float32)
    hier = gamg_setup(op, AMGParams(coarse_eq_limit=64))
    hier16 = cast_hierarchy(hier, jnp.bfloat16)
    assert hier16.levels[0].dinv.dtype == jnp.bfloat16

    r32 = cg(op.mv, b, rtol=1e-5, maxiter=200, m_mv=lambda r: vcycle(hier, r))
    r16 = cg(
        op.mv, b, rtol=1e-5, maxiter=200,
        m_mv=lambda r: vcycle(hier16, r.astype(jnp.bfloat16)).astype(r.dtype),
    )
    assert r32.converged() and r16.converged()
    # a low-precision approximate inverse costs at most a few extra iterations
    assert int(r16.iters) <= int(r32.iters) + 6
    np.testing.assert_allclose(
        np.asarray(r16.x), np.asarray(r32.x), rtol=1e-3, atol=1e-4
    )


@pytest.mark.slow
def test_driver_bf16_default_end_to_end():
    from tpusparse.bench.driver import solve_poisson

    rep16 = solve_poisson(
        18, rtol=1e-8, pc="gamg", precision="mixed", warmup=False,
        pc_dtype="bf16",
    )
    rep32 = solve_poisson(
        18, rtol=1e-8, pc="gamg", precision="mixed", warmup=False,
        pc_dtype="f32",
    )
    assert rep16.reason > 0 and rep32.reason > 0
    # identical discretization error; the bf16 preconditioner only changes
    # the Krylov path, not the answer
    assert abs(rep16.linf_error - rep32.linf_error) < 1e-6
    assert rep16.iters <= rep32.iters + 8


def test_cast_coarse_coefs_keeps_fine_level_and_convergence():
    """cast_coarse_coefs stores only the coarse levels' 27-point
    coefficient stacks in bf16: the fine level, every vector-facing field
    and the CG iteration count stay as built."""
    from tpusparse.amg.hierarchy import cast_coarse_coefs

    op, b, _ = poisson_stencil(Grid3D(18, 18, 18), dtype=np.float32)
    hier = gamg_setup(op, AMGParams(coarse_eq_limit=30))
    hier_b = cast_coarse_coefs(hier)
    assert hier_b.levels[0].op.diag.dtype == jnp.float32
    for lev in hier_b.levels[1:]:
        assert lev.op.coef.dtype == jnp.bfloat16
        assert lev.dinv.dtype == jnp.float32
    r32 = cg(op.mv, b, rtol=1e-6, maxiter=200, m_mv=lambda r: vcycle(hier, r))
    rb = cg(op.mv, b, rtol=1e-6, maxiter=200,
            m_mv=lambda r: vcycle(hier_b, r))
    assert r32.converged() and rb.converged()
    assert abs(int(rb.iters) - int(r32.iters)) <= 2
