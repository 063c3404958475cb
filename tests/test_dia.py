"""DIA (banded) container — the gather-free general-matrix path.

Oracle: scipy.  Also checks the unstructured AMG with DIA operators +
factored transfers matches the ELL + explicit-transfer path
iteration-for-iteration (cross-variant consistency, SURVEY.md section 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from tpusparse import Grid3D, HostCSR
from tpusparse.amg import AMGParams, vcycle
from tpusparse.amg.unstructured import gamg_setup_unstructured
from tpusparse.grid.poisson import assemble_poisson
from tpusparse.solve import cg
from tpusparse.sparse.dia import DIA


def _poisson_csr(n=10):
    return assemble_poisson(Grid3D(n, n, n))[0]


def test_dia_roundtrip_and_mv():
    a = _poisson_csr(8)
    d = DIA.from_csr(a)
    assert len(d.offsets) == 7  # 7-point star
    s = a.to_scipy()
    assert (d.to_scipy() != s).nnz == 0
    rng = np.random.default_rng(0)
    x = rng.standard_normal(a.n_rows)
    np.testing.assert_allclose(np.asarray(d.mv(jnp.asarray(x))), s @ x,
                               rtol=1e-12)


@pytest.mark.slow
def test_dia_rectangular_and_rmv():
    rng = np.random.default_rng(1)
    s = sp.random(40, 23, density=0.2, random_state=3, format="csr")
    d = DIA.from_csr(HostCSR.from_scipy(s))
    x = rng.standard_normal(23)
    y = rng.standard_normal(40)
    np.testing.assert_allclose(np.asarray(d.mv(jnp.asarray(x))), s @ x,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d.rmv(jnp.asarray(y))), s.T @ y,
                               rtol=1e-12, atol=1e-12)


def test_dia_mm_matches_mv():
    a = _poisson_csr(6)
    d = DIA.from_csr(a)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((a.n_cols, 3)))
    got = np.asarray(d.mm(x))
    for j in range(3):
        np.testing.assert_allclose(got[:, j], np.asarray(d.mv(x[:, j])),
                                   rtol=1e-12)


def test_dia_diagonal():
    a = _poisson_csr(6)
    d = DIA.from_csr(a)
    np.testing.assert_allclose(np.asarray(d.diagonal()),
                               a.to_scipy().diagonal())


def test_dia_refuses_wide_matrices():
    s = sp.random(300, 300, density=0.3, random_state=0, format="csr")
    with pytest.raises(ValueError, match="diagonals"):
        DIA.from_csr(HostCSR.from_scipy(s), max_offsets=32)


def test_dia_cg_inside_while_loop():
    """The whole point: DIA mv inside a jitted while_loop CG — gather-free,
    so no gather cap applies."""
    a = _poisson_csr(10)
    d = DIA.from_csr(a)
    rng = np.random.default_rng(3)
    x_true = rng.standard_normal(a.n_rows)
    b = jnp.asarray(a.to_scipy() @ x_true)
    import jax

    res = jax.jit(
        lambda op, b: cg(op.mv, b, rtol=1e-10, maxiter=3000)
    )(d, b)
    assert res.converged()
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6,
                               atol=1e-7)


def test_hybrid_dia_matches_scipy():
    from tpusparse.sparse.dia import HybridDIA

    s = sp.random(400, 400, density=0.05, random_state=5, format="csr")
    s = (s + s.T + 10 * sp.identity(400)).tocsr()
    h = HybridDIA.from_csr(HostCSR.from_scipy(s), max_bands=16)
    assert h.rem is not None  # genuinely split
    assert len(h.dia.offsets) <= 17
    rng = np.random.default_rng(0)
    x = rng.standard_normal(400)
    np.testing.assert_allclose(np.asarray(h.mv(jnp.asarray(x))), s @ x,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(h.diagonal()), s.diagonal(),
                               rtol=1e-12)
    assert (h.to_scipy() != s).nnz == 0


def test_hybrid_dia_no_remainder_when_banded():
    from tpusparse.sparse.dia import HybridDIA

    a = _poisson_csr(6)
    h = HybridDIA.from_csr(a, max_bands=16)
    assert h.rem is None
    x = jnp.asarray(np.random.default_rng(1).standard_normal(a.n_rows))
    np.testing.assert_allclose(np.asarray(h.mv(x)),
                               a.to_scipy() @ np.asarray(x), rtol=1e-12)


@pytest.mark.slow
def test_unstructured_auto_uses_hybrid_on_wide_levels():
    """The Galerkin coarse level at 16^3 occupies 273 diagonals — auto must
    pick HybridDIA there (was: full-ELL gather fallback)."""
    from tpusparse.sparse.dia import HybridDIA

    a = _poisson_csr(16)
    # aggressive coarsening off: keep the wide single-greedy level-1 shape
    # this test exists to exercise
    hier = gamg_setup_unstructured(
        a, AMGParams(coarse_eq_limit=40, aggressive_coarsening=0),
        device_format="auto", transfer_format="factored",
        aggregation="greedy",  # geometric aggregation would make every
        # level a narrow pure DIA — this test exists for the wide greedy
        # levels
    )
    kinds = [type(l.op).__name__ for l in hier.levels]
    assert kinds[0] == "DIA"
    assert "HybridDIA" in kinds
    b = jnp.asarray(np.sin(np.arange(a.n_rows) * 0.13))
    res = cg(hier.levels[0].op.mv, b, rtol=1e-8, maxiter=200,
             m_mv=lambda r: vcycle(hier, r))
    assert res.converged()


@pytest.mark.parametrize("fmt,tfmt", [("ell", "ell"), ("dia", "factored")])
def test_unstructured_amg_dia_matches_ell(fmt, tfmt):
    """DIA + factored transfers = same preconditioner as ELL + explicit P."""
    a = _poisson_csr(12)
    params = AMGParams(coarse_eq_limit=40)
    hier = gamg_setup_unstructured(
        a, params, device_format=fmt, transfer_format=tfmt
    )
    b = jnp.asarray(np.sin(np.arange(a.n_rows) * 0.13))
    z = vcycle(hier, b)
    res = cg(hier.levels[0].op.mv, b, rtol=1e-8, maxiter=200,
             m_mv=lambda r: vcycle(hier, r))
    assert res.converged()
    # store for cross-variant comparison via function attribute
    key = "results"
    store = getattr(test_unstructured_amg_dia_matches_ell, key, {})
    store[(fmt, tfmt)] = (int(res.iters), np.asarray(z))
    setattr(test_unstructured_amg_dia_matches_ell, key, store)
    if len(store) == 2:
        (it1, z1), (it2, z2) = store.values()
        assert abs(it1 - it2) <= 1
        np.testing.assert_allclose(z1, z2, rtol=1e-5, atol=1e-8)


def test_auto_container_gather_cap_fallback():
    """A level ABOVE the gather-row cap must not keep an ELL remainder:
    auto_container widens the bands to a pure DIA (no gather anywhere)
    instead of a gather past the cap."""
    from tpusparse.sparse.dia import HybridDIA, auto_container

    # 7-point Poisson plus a scattering of extra diagonals so the matrix
    # occupies more distinct offsets than max_bands
    a = _poisson_csr(12).to_scipy()
    n = a.shape[0]
    rng = np.random.default_rng(7)
    extra_offsets = rng.choice(np.arange(5, n // 2), size=24, replace=False)
    extras = sum(
        sp.diags(np.full(n - int(o), 1e-3), int(o), shape=(n, n))
        for o in extra_offsets
    )
    m = (a + extras + extras.T).tocsr()
    k_distinct = np.unique(
        m.indices - np.repeat(np.arange(n), np.diff(m.indptr))
    ).size
    assert k_distinct > 16

    # below the cap: HybridDIA with a gather remainder is fine
    small_ok = auto_container(m, max_bands=16, gather_row_cap=10 * n)
    assert isinstance(small_ok, HybridDIA) and small_ok.rem is not None

    # above the cap: pure DIA fallback, NO remainder
    big = auto_container(m, max_bands=16, gather_row_cap=n // 2)
    assert isinstance(big, DIA)
    assert (big.to_scipy() != m).nnz == 0

    # above the cap AND over the DIA storage budget: the segmented
    # banded-ELL executor takes over (round-5 arbitrary-CSR path —
    # window-local gathers only, O(nnz) storage)
    from tpusparse.sparse.bandell import BandedELL

    seg = auto_container(
        m, max_bands=16, gather_row_cap=n // 2, dia_budget_bytes=1024
    )
    assert isinstance(seg, BandedELL)
    assert (seg.to_scipy() != m).nnz == 0

    # ... and when the bandwidth exceeds even BandedELL's safe-window
    # region (4*bw > window_cap), the combined refusal is an informative
    # error naming both dead ends
    import scipy.sparse as _sp

    n_w = 200_002
    wide_offsets = [0, 1, -1] + [
        s * k * 9_000 for k in range(2, 9) for s in (1, -1)
    ] + [n_w - 1, -(n_w - 1)]
    w = _sp.diags(
        [1.0] * len(wide_offsets), wide_offsets, shape=(n_w, n_w)
    ).tocsr()
    with pytest.raises(ValueError, match="gather cap"):
        auto_container(
            w, max_bands=4, gather_row_cap=n_w // 2, dia_budget_bytes=1024
        )


def test_unstructured_setup_respects_gather_cap():
    """End-to-end: a hierarchy whose level-1 would cross the (artificially
    tiny) cap builds with gather-free operators and still solves."""
    a = _poisson_csr(10)
    hier = gamg_setup_unstructured(
        a, AMGParams(coarse_eq_limit=30), gather_row_cap=1
    )
    from tpusparse.sparse.dia import HybridDIA

    for lev in hier.levels:
        assert not (
            isinstance(lev.op, HybridDIA) and lev.op.rem is not None
        ), "gather remainder survived above the cap"
    b = jnp.asarray(np.random.default_rng(3).standard_normal(a.n_rows))
    res = cg(
        lambda x: hier.levels[0].op.mv(x), b, rtol=1e-8, maxiter=300,
        m_mv=lambda r: vcycle(hier, r),
    )
    assert int(res.reason) > 0


def test_dfdia_two_float_precision():
    """DFDIA (hi+lo f32) must apply A to ~2^-48 relative accuracy in f64,
    and detect exactly-f32-representable operators (lo is None — zero
    extra upload for e.g. the Poisson matrix)."""
    from tpusparse.sparse.dia import DFDIA

    # exactly representable: h^-2 multiples
    a = _poisson_csr(8)
    bands64, offs, shp = DIA.host_bands(a)
    df = DFDIA.from_host_bands(bands64, offs, shp)
    assert df.lo is None
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(a.n_rows))
    np.testing.assert_allclose(
        np.asarray(df.mv(x)), a.to_scipy() @ np.asarray(x), rtol=1e-13
    )

    # NOT representable: perturb with irrational-ish values
    s = a.to_scipy().astype(np.float64)
    s.data = s.data * (1.0 + 1e-9) + np.pi * 1e-7
    from tpusparse.sparse.csr import HostCSR

    h = HostCSR.from_scipy(s.tocsr())
    bands64, offs, shp = DIA.host_bands(h)
    df2 = DFDIA.from_host_bands(bands64, offs, shp)
    assert df2.lo is not None
    y = np.asarray(df2.mv(x))
    y_ref = s @ np.asarray(x)
    err = np.abs(y - y_ref).max() / np.abs(y_ref).max()
    assert err < 1e-12  # ~48-bit mantissa, far beyond plain f32 (~6e-8)
    # and the f32-only product would NOT reach this
    f32_err = np.abs(
        np.asarray(DIA.from_csr(h, dtype=np.float32).mv(x.astype(jnp.float32)),
                   np.float64) - y_ref
    ).max() / np.abs(y_ref).max()
    assert f32_err > 1e-9
    assert df2.diagonal().dtype == jnp.float64
