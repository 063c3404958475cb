"""Multicolor SOR/SSOR level smoother (PETSc PCSOR parity in its standard
parallel-machine form): masked simultaneous updates over stencil colorings
are exact Gauss-Seidel orderings, and the reversed-color post-smooth keeps
the V-cycle a symmetric CG preconditioner.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse.amg import AMGParams, gamg_setup, vcycle
from tpusparse.amg.hierarchy import _smooth
from tpusparse.grid.grid3d import Grid3D
from tpusparse.grid.poisson import poisson_stencil
from tpusparse.solve import cg


def _dense(op):
    n = op.shape[0]
    cols = []
    for j in range(n):
        e = jnp.zeros(n).at[j].set(1.0)
        cols.append(np.asarray(op.mv(e.reshape(op.grid_shape))).reshape(-1))
    return np.stack(cols, axis=1)


def test_colors_decouple_star_and_27pt():
    """Within one color no two points couple: A restricted to a color
    block is diagonal — the property that makes the masked simultaneous
    update a true GS ordering."""
    op, _, _ = poisson_stencil(Grid3D(5, 4, 3))
    hier = gamg_setup(op, AMGParams(coarse_eq_limit=6))
    for lev in hier.levels:
        if not hasattr(lev.op, "gs_color_masks"):
            continue
        a = _dense(lev.op)
        for m in lev.op.gs_color_masks():
            idx = np.flatnonzero(np.asarray(m).reshape(-1))
            block = a[np.ix_(idx, idx)]
            np.testing.assert_array_equal(
                block - np.diag(np.diag(block)), 0.0
            )


def test_sor_sweep_matches_sequential_gauss_seidel():
    """One forward multicolor sweep == sequential GS in color-major
    order, verified against a numpy row-by-row GS on the dense matrix."""
    op, b, _ = poisson_stencil(Grid3D(4, 3, 3))
    hier = gamg_setup(op, AMGParams(smoother="sor", degree=1))
    lev = hier.levels[0]
    a = _dense(op)
    bf = np.asarray(b).reshape(-1)
    masks = [np.asarray(m).reshape(-1) for m in op.gs_color_masks()]
    order = np.concatenate([np.flatnonzero(m) for m in masks])
    x_ref = np.zeros_like(bf)
    for p in order:
        x_ref[p] += (bf[p] - a[p] @ x_ref) / a[p, p]
    x = _smooth(hier, lev, b.reshape(op.grid_shape), None)
    np.testing.assert_allclose(
        np.asarray(x).reshape(-1), x_ref, rtol=1e-12
    )


@pytest.mark.slow
def test_ssor_vcycle_is_a_symmetric_preconditioner():
    """B = vcycle(. ) with forward pre-smooth / reversed post-smooth must
    be symmetric (dense check) — the property CG needs."""
    op, _, _ = poisson_stencil(Grid3D(4, 4, 4))
    hier = gamg_setup(op, AMGParams(smoother="sor", coarse_eq_limit=6))
    n = op.shape[0]
    cols = []
    for j in range(n):
        e = jnp.zeros(n).at[j].set(1.0)
        cols.append(
            np.asarray(vcycle(hier, e.reshape(op.grid_shape))).reshape(-1)
        )
    bmat = np.stack(cols, axis=1)
    np.testing.assert_allclose(bmat, bmat.T, rtol=1e-10, atol=1e-13)


@pytest.mark.slow
def test_sor_amg_cg_converges_comparable_to_chebyshev():
    grid = Grid3D(24, 24, 24)
    op, b, _ = poisson_stencil(grid)

    def run(params):
        hier = gamg_setup(op, params)
        res = cg(op.mv, b.reshape(op.grid_shape), rtol=1e-8, maxiter=200,
                 m_mv=lambda r: vcycle(hier, r))
        assert int(res.reason) > 0, int(res.reason)
        return int(res.iters)

    it_sor = run(AMGParams(smoother="sor"))
    it_cheb = run(AMGParams())
    # same ballpark: SSOR(2) vs chebyshev(2) on Poisson
    assert it_sor <= 2 * it_cheb, (it_sor, it_cheb)


def test_sor_rejected_where_uncolorable():
    from tpusparse.amg.unstructured import gamg_setup_unstructured
    from tpusparse.grid.poisson import assemble_poisson

    a, _, _ = assemble_poisson(Grid3D(8, 8, 8), dtype=np.float64)
    with pytest.raises(ValueError, match="sor"):
        gamg_setup_unstructured(
            a, AMGParams(smoother="sor"), aggregation="greedy"
        )
    op, _, _ = poisson_stencil(Grid3D(8, 8, 8), dtype=np.float32)
    with pytest.raises(ValueError, match="bjacobi"):
        gamg_setup(op, AMGParams(smoother="sor", bjacobi_bs=4))


@pytest.mark.slow
def test_sor_options_and_driver_e2e():
    from tpusparse.bench.driver import solve_poisson
    from tpusparse.config.options import load_options

    opts = load_options(
        ["-da_grid_x", "16", "-mg_levels_pc_type", "sor"]
    ).validate()
    assert opts.amg_params().smoother == "sor"
    import warnings

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        o2 = load_options(["-mg_levels_pc_type", "eisenstat"]).validate()
    assert o2.mg_levels_pc_type == "jacobi"
    assert any("mg_levels_pc_type" in str(x.message) for x in w)

    rep = solve_poisson(
        16, rtol=1e-8, amg_params=AMGParams(smoother="sor")
    )
    assert rep.reason > 0 and rep.linf_error < 0.03


def test_explicit_chebyshev_plus_sor_warns_and_degrades():
    """PETSc's chebyshev-wrapped SOR is not implemented: explicitly
    combining the two warns and degrades to SSOR sweeps; plain
    '-mg_levels_pc_type sor' (ksp_type left at its default) stays
    silent."""
    import warnings

    from tpusparse.config.options import load_options

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        o = load_options(["-mg_levels_ksp_type", "chebyshev",
                          "-mg_levels_pc_type", "sor"])
    assert o.mg_levels_ksp_type == "richardson"
    assert any("chebyshev" in str(x.message) for x in w)
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        o2 = load_options(["-mg_levels_pc_type", "sor"])
    assert o2.amg_params().smoother == "sor"
    assert not any("chebyshev" in str(x.message) for x in w2)
