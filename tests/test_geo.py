"""Geometry-aware aggregation (amg/geo.py) — the gather-free transfer path.

Oracles: FactoredTransfer with identical aggregate ids/weights (the two
must agree to rounding), explicit scipy prolongator products, and the
structured driver's Linf gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse import Grid3D, HostCSR
from tpusparse.amg import AMGParams, vcycle
from tpusparse.amg.geo import (
    GeoTransfer,
    coarse_dims,
    geo_aggregate_ids,
    geo_block_sizes,
    infer_grid3d,
)
from tpusparse.amg.unstructured import FactoredTransfer, gamg_setup_unstructured
from tpusparse.grid.poisson import assemble_poisson
from tpusparse.solve import cg
from tpusparse.sparse.dia import DIA


@pytest.mark.parametrize(
    "shape",
    [(30, 30, 30), (4, 4, 4), (5, 7, 11), (1, 12, 9), (16, 1, 8)],
)
def test_infer_grid3d_star7(shape):
    nz, ny, nx = shape
    offs = {0}
    if nx > 1:
        offs |= {1, -1}
    if ny > 1:
        offs |= {nx, -nx}
    if nz > 1:
        offs |= {nx * ny, -(nx * ny)}
    got = infer_grid3d(tuple(sorted(offs)), nz * ny * nx)
    # degenerate axes can be absorbed differently but the product and the
    # fastest-varying dims must match
    assert got is not None
    assert np.prod(got) == nz * ny * nx
    assert got[2] == (nx if nx > 1 else got[2])


def test_infer_grid3d_27point():
    nz, ny, nx = 6, 5, 7
    offs = set()
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                offs.add(dz * nx * ny + dy * nx + dx)
    got = infer_grid3d(tuple(sorted(offs)), nz * ny * nx)
    assert got == (nz, ny, nx)


def test_infer_grid3d_rejects_solid_bands():
    """An RCM-reordered scattered matrix has a SOLID offset interval; a
    small-nx factorization decomposes every such offset "validly", so the
    clustering gate must reject it (regression: a false (56, 7, 7) on a
    reordered 14^3 Poisson crashed the geo setup)."""
    n = 2744  # 14^3 = 56*7*7
    band = tuple(range(-150, 151))
    assert infer_grid3d(band, n) is None


def test_infer_grid3d_rejects_non_grids():
    assert infer_grid3d((-1, 0, 1), 100) is None           # tridiagonal
    assert infer_grid3d((0, 5, -5, 1, -1), 99) is None     # 99 % 5 != 0
    assert infer_grid3d((0, 7, 1), 49) is None             # nonsymmetric


def test_geo_transfer_matches_factored():
    """GeoTransfer and FactoredTransfer with the same aggregates/weights
    are the same linear operators."""
    shape = (6, 5, 7)
    n = int(np.prod(shape))
    bs = geo_block_sizes(shape, 3)
    agg = geo_aggregate_ids(shape, bs)
    n_c = int(agg.max()) + 1
    sizes = np.bincount(agg, minlength=n_c).astype(np.float64)
    w = 1.0 / np.sqrt(sizes[agg])
    rng = np.random.default_rng(0)

    # an arbitrary banded SPD-ish operator on the grid
    g = Grid3D(*shape[::-1]) if False else None
    a, _, _ = assemble_poisson(Grid3D(shape[2], shape[1], shape[0]))
    op = DIA.from_csr(a)
    dinv = jnp.asarray(1.0 / a.diagonal())
    omega = jnp.asarray(0.7)

    geo = GeoTransfer.build(
        w=jnp.asarray(w), omega=omega, fine_shape=shape, bs=bs,
        dtype=jnp.float64,
    )
    fac = FactoredTransfer(
        agg=jnp.asarray(agg, jnp.int32), w=jnp.asarray(w), omega=omega,
        n_coarse=n_c,
    )
    e_c = jnp.asarray(rng.standard_normal(n_c))
    x = jnp.asarray(rng.standard_normal(n))
    np.testing.assert_allclose(
        np.asarray(geo.prolong(op, dinv, e_c)),
        np.asarray(fac.prolong(op, dinv, e_c)), rtol=1e-12, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(geo.restrict(op, dinv, x)),
        np.asarray(fac.restrict(op, dinv, x)), rtol=1e-12, atol=1e-12,
    )


@pytest.mark.slow
def test_geo_hierarchy_solves_and_is_pure_dia():
    """aggregation='auto' on a grid-shaped CSR: every level pure DIA (no
    gather anywhere), CG+GAMG converges with structured-like iteration
    counts, Linf = O(h^2)."""
    n = 24
    a, b_np, exact = assemble_poisson(Grid3D(n, n, n))
    hier = gamg_setup_unstructured(a, AMGParams(), dtype=np.float32)
    for lev in hier.levels:
        assert type(lev.op).__name__ in ("DIA", "GridDIA")
    for lev in hier.levels[:-1]:
        assert isinstance(lev.transfer, GeoTransfer)
    b = jnp.asarray(b_np, jnp.float32)
    res = cg(
        lambda x: hier.levels[0].op.mv(x), b, rtol=1e-6, maxiter=100,
        m_mv=lambda r: vcycle(hier, r),
    )
    assert int(res.reason) > 0
    assert int(res.iters) < 40


@pytest.mark.slow
def test_geo_nondivisible_dims():
    """Ragged edges (dims not divisible by the block size) still produce a
    correct transfer pair (pad + crop paths)."""
    shape = (7, 5, 10)
    a, b_np, _ = assemble_poisson(Grid3D(shape[2], shape[1], shape[0]))
    hier = gamg_setup_unstructured(
        a, AMGParams(coarse_eq_limit=8), aggregation="geometric"
    )
    b = jnp.asarray(b_np)
    res = cg(
        lambda x: hier.levels[0].op.mv(x), b, rtol=1e-8, maxiter=200,
        m_mv=lambda r: vcycle(hier, r),
    )
    assert int(res.reason) > 0


def test_geometric_demand_rejects_non_grid():
    import scipy.sparse as sp

    m = sp.diags(
        [np.full(99, -1.0), np.full(100, 2.0), np.full(99, -1.0)],
        [-1, 0, 1],
    ).tocsr()
    with pytest.raises(ValueError, match="geometric"):
        gamg_setup_unstructured(
            HostCSR.from_scipy(m), AMGParams(), aggregation="geometric"
        )


def test_galerkin_probe_matches_scipy_ptap():
    """On-device colored probing == host scipy P^T A P, band for band."""
    import scipy.sparse as sp

    from tpusparse.amg.geo import (
        block_weight_field,
        galerkin_probe_geo,
        up3,
    )

    shape = (6, 5, 7)
    n = int(np.prod(shape))
    a, _, _ = assemble_poisson(Grid3D(shape[2], shape[1], shape[0]))
    op = DIA.from_csr(a)
    dinv_np = 1.0 / a.diagonal()
    dinv = jnp.asarray(dinv_np)
    omega = 0.71
    bs = geo_block_sizes(shape, 3)
    w_c = block_weight_field(shape, bs, np.float64)
    tr = GeoTransfer.build(
        w=up3(jnp.asarray(w_c.reshape(-1)), shape, bs),
        omega=jnp.asarray(omega), fine_shape=shape, bs=bs,
        dtype=jnp.float64,
    )
    coarse = galerkin_probe_geo(op, dinv, tr)

    # host oracle
    agg = geo_aggregate_ids(shape, bs)
    n_c = int(agg.max()) + 1
    sizes = np.bincount(agg, minlength=n_c).astype(np.float64)
    t = sp.csr_matrix(
        (1.0 / np.sqrt(sizes[agg]), (np.arange(n), agg)), shape=(n, n_c)
    )
    a_sp = a.to_scipy()
    p = (t - omega * sp.diags(dinv_np) @ (a_sp @ t)).tocsr()
    ac = (p.T @ (a_sp @ p)).tocsr()
    got = coarse.to_scipy()
    diff = abs(got - ac)
    assert diff.max() < 1e-10 * abs(ac).max()


@pytest.mark.slow
def test_gamg_setup_geo_device_resident_solves():
    """The device-resident geometric setup (no host coarse matrices)
    produces a hierarchy that solves to discretization accuracy with
    structured-class iteration counts."""
    n = 30
    a, b_np, exact = assemble_poisson(Grid3D(n, n, n))
    tm = {}
    hier = gamg_setup_unstructured(
        a, AMGParams(), dtype=np.float32, timings=tm
    )
    assert all(
        type(l.op).__name__ in ("DIA", "GridDIA") for l in hier.levels
    )
    assert tm.get("galerkin", 0) >= 0 and "device_put" in tm
    b = jnp.asarray(b_np, jnp.float32)
    res = cg(
        lambda x: hier.levels[0].op.mv(x), b, rtol=1e-6, maxiter=100,
        m_mv=lambda r: vcycle(hier, r),
    )
    assert int(res.reason) > 0 and int(res.iters) < 40
    x = np.asarray(res.x, np.float64)
    linf = np.abs(x - exact).max()
    assert linf < 1e-2  # O(h^2) at 30^3 is ~7.2e-3 (the discretization
    # limit itself: 7.3e-5 at 300^3 x (300/30)^2)


def test_griddia_matches_flat_dia():
    """3-D field-shift mv == flat-shift mv, bit-for-bit in f64, including
    all grid edges (the wrap positions where the semantics COULD differ
    are validated zero)."""
    from tpusparse.sparse.dia import DIA
    from tpusparse.sparse.griddia import GridDIA, host_grid_view

    shape = (6, 5, 7)
    a, _, _ = assemble_poisson(Grid3D(shape[2], shape[1], shape[0]))
    bands, offs, shp = DIA.host_bands(a)
    d3s = host_grid_view(bands, offs, shape)
    assert d3s is not None
    import jax

    d = DIA.from_csr(a)
    g = GridDIA(bands=d.bands, offsets=offs, d3s=d3s, grid_shape=shape)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(a.n_rows))
    np.testing.assert_array_equal(
        np.asarray(g.mv(x)), np.asarray(d.mv(x))
    )
    np.testing.assert_array_equal(
        np.asarray(g.diagonal()), np.asarray(d.diagonal())
    )

    # a wrap-violating matrix must be REJECTED (flat entry (nx-1 -> next
    # row) has offset +1 but is not a grid coupling)
    import scipy.sparse as sp

    n = int(np.prod(shape))
    bad = a.to_scipy().tolil()
    r = shape[2] - 1  # x-edge cell (0,0,nx-1)
    bad[r, r + 1] = 99.0  # wraps to (0,1,0)
    from tpusparse import HostCSR

    bands_b, offs_b, _ = DIA.host_bands(HostCSR.from_scipy(bad.tocsr()))
    assert host_grid_view(bands_b, offs_b, shape) is None


def test_geo_hierarchy_with_griddia_fine_level_solves():
    """GridDIA (3-D-view container) as the FINE level solves identically —
    it is a correct, tested container even though production keeps the
    flat form (small-shape coarse instances also trip an XLA composition
    miscompile — sparse/griddia.py notes)."""
    from tpusparse.sparse.dia import DIA
    from tpusparse.sparse.griddia import GridDIA, host_grid_view

    n = 24
    a, b_np, exact = assemble_poisson(Grid3D(n, n, n))
    bands, offs, shp = DIA.host_bands(a, dtype=np.float32)
    d3s = host_grid_view(bands, offs, (n, n, n))
    fine = GridDIA(
        bands=jnp.asarray(bands), offsets=offs, d3s=d3s,
        grid_shape=(n, n, n),
    )
    hier = gamg_setup_unstructured(
        a, AMGParams(), dtype=np.float32, fine_op=fine
    )
    assert isinstance(hier.levels[0].op, GridDIA)
    b = jnp.asarray(b_np, jnp.float32)
    import jax as _jax

    res = _jax.jit(
        lambda h, b: cg(
            lambda x: h.levels[0].op.mv(x), b, rtol=1e-6, maxiter=100,
            m_mv=lambda r: vcycle(h, r),
        )
    )(hier, b)
    assert int(res.reason) > 0 and int(res.iters) < 40
