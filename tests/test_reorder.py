"""Arbitrary-sparsity CSR support: RCM reordering + the segmented
banded-ELL executor (round-4 verdict item 3).

The reference's patched kernel is general-CSR SpMV — any row structure
(its src/openacc-step1/MatMult_SeqAIJ.patch:19-30).  The equivalent here:
``sparse/reorder.py`` RCM bounds the graph bandwidth,
``sparse/bandell.py`` executes bounded-bandwidth CSR with window-local
gathers only, and ``ksp.KSP`` carries the permutation (solve in permuted
space, unpermute x).  The acceptance case from the verdict: a RANDOMLY
PERMUTED Poisson matrix — defeats ``infer_grid3d`` (no grid pattern) AND
raw DIA (thousands of occupied diagonals) — must solve on the general
path with iteration parity.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse.grid.grid3d import Grid3D
from tpusparse.grid.poisson import assemble_poisson
from tpusparse.ksp import KSP
from tpusparse.sparse.bandell import BandedELL
from tpusparse.sparse.csr import HostCSR
from tpusparse.sparse.reorder import (
    bandwidth,
    distinct_diagonals,
    inverse_permutation,
    permute_csr,
    rcm_permutation,
)


def _permuted_poisson(n=14, seed=0):
    grid = Grid3D(n, n, n)
    a, b, exact = assemble_poisson(grid, pin=True)
    rng = np.random.default_rng(seed)
    p = rng.permutation(a.n_rows)
    return a, b, exact, permute_csr(a, p), b[p], exact[p], p


def test_rcm_is_valid_permutation_and_reduces_bandwidth():
    a, _b, _e, ap, _bp, _ep, _p = _permuted_poisson()
    n = a.n_rows
    assert bandwidth(ap) > 5 * bandwidth(a)          # scrambled
    perm = rcm_permutation(ap)
    assert sorted(perm.tolist()) == list(range(n))   # a real permutation
    ar = permute_csr(ap, perm)
    # RCM must land in the same bandwidth class as the natural ordering
    assert bandwidth(ar) <= 2 * bandwidth(a)
    assert distinct_diagonals(ar) <= 4 * bandwidth(a)


def test_rcm_native_matches_scipy_bandwidth():
    """The C++ rcm_order and scipy's reverse_cuthill_mckee need not agree
    node-for-node, but must land in the same bandwidth class."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from tpusparse import native

    _a, _b, _e, ap, _bp, _ep, _p = _permuted_poisson(n=10)
    if not native.available():
        pytest.skip("native library unavailable")
    bw_native = bandwidth(permute_csr(ap, native.rcm(ap)))
    sp_perm = np.asarray(
        reverse_cuthill_mckee(ap.to_scipy(), symmetric_mode=True), np.int64
    )
    bw_scipy = bandwidth(permute_csr(ap, sp_perm))
    assert bw_native <= 1.5 * bw_scipy + 8


def test_permute_csr_is_similarity_transform():
    a, _b, _e, ap, _bp, _ep, p = _permuted_poisson(n=8)
    x = np.random.default_rng(1).standard_normal(a.n_rows)
    np.testing.assert_allclose(ap.mv(x[p]), a.mv(x)[p], rtol=1e-12)
    ip = inverse_permutation(p)
    np.testing.assert_array_equal(p[ip], np.arange(a.n_rows))


@pytest.mark.parametrize("window_cap", [800, 10**7])
def test_bandell_matches_scipy(window_cap):
    """Multi-segment and single-segment BandedELL vs the scipy oracle."""
    _a, _b, _e, ap, _bp, _ep, _p = _permuted_poisson(n=12)
    perm = rcm_permutation(ap)
    ar = permute_csr(ap, perm)
    be = BandedELL.from_csr(ar, window_cap=window_cap)
    if window_cap == 800:
        assert be.n_segments >= 2  # exercise the window stitching
    x = np.random.default_rng(2).standard_normal(ar.n_rows)
    y_ref = ar.to_scipy() @ x
    y = np.asarray(be.mv(jnp.asarray(x)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(be.diagonal()), ar.to_scipy().diagonal()
    )
    d = be.to_scipy() - ar.to_scipy()
    d.eliminate_zeros()
    assert d.nnz == 0


def test_bandell_refuses_unbounded_bandwidth():
    """A scattered matrix whose bandwidth needs windows beyond the crash
    cap must be refused with the reorder hint, never built."""
    import scipy.sparse as sp

    n = 4000
    rng = np.random.default_rng(3)
    rows = np.arange(n)
    cols = rng.permutation(n)
    m = sp.csr_matrix(
        (np.ones(n), (rows, cols)), shape=(n, n)
    ) + sp.identity(n)
    with pytest.raises(ValueError, match="RCM-reorder"):
        BandedELL.from_csr(HostCSR.from_scipy(m.tocsr()), window_cap=800)


@pytest.mark.slow
def test_ksp_auto_reorder_solves_permuted_poisson():
    """The verdict acceptance case: a randomly-permuted Poisson system
    through KSP with mat_reorder='auto' — solves on the general path,
    matches the permuted exact solution, and (CG on a similarity
    transform) needs a comparable iteration count to natural order."""
    a, b, exact, ap, bp, ep, _p = _permuted_poisson()

    nat = KSP(rtol=1e-8, atol=1e-12, precision="mixed")
    nat.set_operators(a)
    r0 = nat.solve(jnp.asarray(b))
    assert r0.converged

    k = KSP(rtol=1e-8, atol=1e-12, precision="mixed")
    k.set_operators(ap)
    assert k._perm is not None           # auto detected the scrambled order
    res = k.solve(jnp.asarray(bp))
    assert res.converged
    # against the DISCRETE solution (the analytic `exact` differs by the
    # O(h^2) discretization error, ~0.03 at 14^3): the permuted solve must
    # reproduce the natural-order solve's answer, permuted
    _a2, _b2, _e2, _ap2, _bp2, _ep2, p = _permuted_poisson()
    err = np.abs(np.asarray(res.x) - np.asarray(r0.x)[p]).max()
    assert err < 1e-6, err
    # the hierarchy differs (greedy aggregation on the reordered graph) but
    # the problem is the same — iteration counts must be the same class
    assert res.iters <= 2 * r0.iters + 5


def test_ksp_reorder_iteration_parity_jacobi():
    """With a permutation-equivariant preconditioner (point Jacobi), CG on
    the reordered system is the SAME iteration sequence: exact parity."""
    a, b, _e, ap, bp, _ep, _p = _permuted_poisson(n=10)
    k0 = KSP(pc_type="jacobi", rtol=1e-8, precision="f64", maxiter=3000)
    k0.set_operators(a)
    r0 = k0.solve(jnp.asarray(b))
    k1 = KSP(
        pc_type="jacobi", rtol=1e-8, precision="f64", maxiter=3000,
        mat_reorder="rcm",
    )
    k1.set_operators(ap)
    assert k1._perm is not None
    r1 = k1.solve(jnp.asarray(bp))
    assert r0.converged and r1.converged
    assert abs(r0.iters - r1.iters) <= 2
    x0 = np.asarray(r0.x)
    _a, _b2, _e2, _ap2, _bp2, _ep2, p = _permuted_poisson(n=10)
    np.testing.assert_allclose(np.asarray(r1.x), x0[p], rtol=1e-6, atol=1e-8)


def test_ksp_reorder_none_keeps_natural_order():
    """mat_reorder='none' never permutes: the scrambled matrix lands on the
    segmented executor in its GIVEN order (tiny n: windows still fit; a
    large-bandwidth matrix would fail in BandedELL.from_csr with the
    reorder hint — test_bandell_refuses_unbounded_bandwidth)."""
    _a, _b, _e, ap, bp, _ep, _p = _permuted_poisson(n=8)
    k = KSP(mat_reorder="none", pc_type="jacobi", rtol=1e-8,
            precision="f64", maxiter=2000)
    k.set_operators(ap)
    assert k._perm is None
    assert isinstance(k._op, BandedELL)
    res = k.solve(jnp.asarray(bp))
    assert res.converged


def test_auto_container_falls_back_to_bandell():
    """auto_container above the gather cap with infeasible widened-DIA
    storage returns the segmented executor instead of raising."""
    from tpusparse.sparse.dia import auto_container

    _a, _b, _e, ap, _bp, _ep, _p = _permuted_poisson(n=12)
    perm = rcm_permutation(ap)
    ar = permute_csr(ap, perm)
    out = auto_container(
        ar, max_bands=8, gather_row_cap=64, dia_budget_bytes=1000
    )
    assert isinstance(out, BandedELL)
    x = np.random.default_rng(4).standard_normal(ar.n_rows)
    np.testing.assert_allclose(
        np.asarray(out.mv(jnp.asarray(x))), ar.to_scipy() @ x, rtol=1e-12
    )


def test_options_mat_reorder():
    from tpusparse.config.options import load_options

    o = load_options(["-mat_reorder", "rcm"])
    assert o.mat_reorder == "rcm"
    k = KSP.from_options(o)
    assert k.mat_reorder == "rcm"
    # unknown value: PETSc-style degradation to the default, with a warning
    with pytest.warns(UserWarning, match="mat_reorder"):
        o2 = load_options(["-mat_reorder", "bogus"])
    assert o2.mat_reorder == "auto"


@pytest.mark.slow
def test_chunked_solve_matches_jitted():
    """The host-loop chunked driver (KSP._solve_chunked, library code kept
    beside cg_hostloop) produces the same solution as the jitted
    while_loop path."""
    a, b, _e, ap, bp, _ep, _p = _permuted_poisson(n=10)
    k = KSP(rtol=1e-8, atol=1e-12, precision="mixed")
    k.set_operators(ap)
    r_jit = k.solve(jnp.asarray(bp))

    k2 = KSP(rtol=1e-8, atol=1e-12, precision="mixed")
    k2.set_operators(ap)
    k2.setup()
    b_perm = jnp.take(jnp.asarray(bp), k2._perm)
    r_chk = k2._solve_chunked(b_perm, None)
    x_chk = np.asarray(jnp.take(r_chk.x.reshape(-1), k2._iperm))
    assert r_chk.reason > 0
    np.testing.assert_allclose(
        x_chk, np.asarray(r_jit.x), rtol=1e-6, atol=1e-8
    )


def test_chunked_solve_uniform_precision():
    a, b, _e, ap, bp, _ep, _p = _permuted_poisson(n=8)
    k = KSP(rtol=1e-8, precision="f64", pc_type="jacobi", maxiter=3000)
    k.set_operators(ap)
    k.setup()
    b_perm = jnp.take(jnp.asarray(bp), k._perm)
    r = k._solve_chunked(b_perm, None)
    assert r.reason > 0
    x = np.asarray(jnp.take(r.x.reshape(-1), k._iperm))
    r_ref = k.solve(jnp.asarray(bp))
    np.testing.assert_allclose(x, np.asarray(r_ref.x), rtol=1e-6, atol=1e-8)
