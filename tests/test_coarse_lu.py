"""Dense direct coarse solve (-mg_coarse_pc_type lu — PETSc GAMG's own
default coarse PC; the reference config picks preonly+bjacobi, which
stays our default)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse.amg import AMGParams, gamg_setup, vcycle
from tpusparse.amg.hierarchy import dense_coarse_inverse
from tpusparse.grid.grid3d import Grid3D
from tpusparse.grid.poisson import assemble_poisson, poisson_stencil_device


def _op(n=6, dtype=np.float32):
    grid = Grid3D(n, n, n)
    op, b, exact = poisson_stencil_device(grid, dtype=dtype)
    return grid, op, b, exact


def test_dense_inverse_matches_scipy():
    """dense_coarse_inverse is the true inverse of the assembled matrix."""
    grid, op, _, _ = _op(5, np.float64)
    a, _, _ = assemble_poisson(grid, dtype=np.float64)
    inv = np.asarray(dense_coarse_inverse(op))
    dense = a.to_dense()
    err = np.abs(inv @ dense - np.eye(dense.shape[0])).max()
    assert err < 1e-9


def test_single_level_lu_is_exact_solve():
    """With the whole problem below coarse_eq_limit, the lu 'V-cycle' IS
    one exact dense solve."""
    grid, op, b, _ = _op(5, np.float64)
    hier = gamg_setup(op, AMGParams(
        coarse_solve="lu", coarse_eq_limit=1000,
    ))
    assert hier.n_levels == 1
    assert hier.levels[0].coarse_inv is not None
    x = vcycle(hier, b)
    r = b - op.mv(x)
    assert float(jnp.abs(r).max()) < 1e-9 * float(jnp.abs(b).max())


@pytest.mark.slow
def test_lu_cuts_or_matches_jacobi_iterations():
    """CG+GAMG with the lu coarse solve converges in <= the iterations of
    the jacobi coarse solve (exact coarsest correction)."""
    from tpusparse.solve import cg

    grid, op, b, _ = _op(18, np.float64)
    runs = {}
    for mode in ("jacobi", "lu"):
        hier = gamg_setup(op, AMGParams(coarse_solve=mode))
        assert hier.n_levels >= 2
        m = lambda r, h=hier: vcycle(h, r)
        res = cg(op.mv, b, rtol=1e-8, m_mv=m, maxiter=200)
        assert res.reason > 0
        runs[mode] = int(res.iters)
    assert runs["lu"] <= runs["jacobi"]
    # the lu hierarchy really is lu at the coarsest
    hier = gamg_setup(op, AMGParams(coarse_solve="lu"))
    assert hier.levels[-1].coarse_inv is not None
    assert all(l.coarse_inv is None for l in hier.levels[:-1])


@pytest.mark.slow
def test_unstructured_lu():
    """The aij/geo hierarchy honors coarse_solve='lu' too."""
    from tpusparse.amg.unstructured import gamg_setup_unstructured
    from tpusparse.solve import cg

    grid = Grid3D(12, 12, 12)
    a, b_np, _ = assemble_poisson(grid, dtype=np.float64)
    hier = gamg_setup_unstructured(
        a, AMGParams(coarse_solve="lu"), dtype=np.float64
    )
    assert hier.levels[-1].coarse_inv is not None
    op = hier.levels[0].op
    b = jnp.asarray(b_np)
    m = lambda r: vcycle(hier, r)
    res = cg(op.mv, b, rtol=1e-8, m_mv=m, maxiter=200)
    assert res.reason > 0


def test_option_wiring():
    """-mg_coarse_pc_type lu reaches AMGParams; unknown values degrade."""
    from tpusparse.config import load_options

    opts = load_options(["-mg_coarse_pc_type", "lu"])
    assert opts.amg_params().coarse_solve == "lu"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        opts = load_options(["-mg_coarse_pc_type", "cholesky"])
        assert opts.mg_coarse_pc_type == "jacobi"
        assert any("mg_coarse_pc_type" in str(x.message) for x in w)


def test_dense_lu_capped_on_early_stopped_hierarchy():
    """Review finding: max_levels (or stalled coarsening) can leave a big
    'coarsest' level; the dense inverse must refuse instead of OOM."""
    import pytest

    from tpusparse.grid.poisson import poisson_stencil

    op, _, _ = poisson_stencil(Grid3D(64, 64, 64))
    with pytest.raises(ValueError, match="dense-inverse cap"):
        gamg_setup(op, AMGParams(coarse_solve="lu", max_levels=2))


def test_aij_setups_validate_coarse_solve():
    import pytest

    from tpusparse.amg.unstructured import gamg_setup_unstructured
    from tpusparse.grid.poisson import assemble_poisson

    a, _, _ = assemble_poisson(Grid3D(12, 12, 12))
    with pytest.raises(ValueError, match="unknown coarse_solve"):
        gamg_setup_unstructured(a, AMGParams(coarse_solve="cholesky"))
