"""-pc_gamg_threshold on the STRUCTURED path (round-3 verdict item 7).

GAMG drops weak couplings from the strength graph (reference config knob:
configs/PETSc_SolverOptions_GAMG.info:8); anisotropic operators then
semicoarsen along strong axes.  The structured equivalent: an eager
per-axis strength fetch -> a static per-level factor schedule
(hierarchy.threshold_schedule), with the P-smoothing operator filtered on
dropped axes (transfer.fop) so the probed Galerkin product stays inside
the 27-point container."""

import jax.numpy as jnp
import numpy as np

from tpusparse.amg.hierarchy import (
    AMGParams,
    axis_strengths,
    gamg_setup,
    threshold_schedule,
    vcycle,
)
from tpusparse.grid.grid3d import Grid3D
from tpusparse.grid.poisson import poisson_stencil
from tpusparse.solve.cg import cg
import pytest


def _aniso_op(n=18, lz=0.1, dtype=np.float64):
    """Short z extent -> hz small -> strong z coupling (cz ~ 100x cx)."""
    grid = Grid3D(n, n, n, lz=lz)
    return poisson_stencil(grid, dtype=dtype)


def test_schedule_none_for_isotropic():
    op, _b, _e = poisson_stencil(Grid3D(12, 12, 12))
    assert threshold_schedule(op, 0.0) is None       # reference default
    assert threshold_schedule(op, 0.05) is None      # isotropic: all kept
    s = axis_strengths(op)
    assert max(s) / min(s) < 1.5


def test_schedule_semicoarsens_strong_axis():
    op, _b, _e = _aniso_op(lz=0.1)  # cz/cx = 100
    sched = threshold_schedule(op, 0.05)
    assert sched is not None
    # first level: coarsen z only; later levels recover isotropy
    assert sched[0] == (3, 1, 1), sched
    assert sched[-1] == (3, 3, 3), sched
    # z coupling weakens 9x per semicoarsened level: 100 -> ~11 -> ~1.2
    assert len(sched) in (2, 3, 4), sched


@pytest.mark.slow
def test_filtered_galerkin_matches_scipy():
    """Probed A_c with the filtered-smoothing transfer == scipy P^T A P
    with the same explicit (filtered-smoothed) P."""
    import scipy.sparse as sp

    from tpusparse.amg.galerkin import galerkin_coarse
    from tpusparse.amg.hierarchy import _filtered_op
    from tpusparse.amg.transfer import StructuredTransfer
    from tpusparse.grid.poisson import assemble_poisson

    n = 9
    grid = Grid3D(n, n, n, lz=0.1)
    op, _b, _e = poisson_stencil(grid, dtype=np.float64)
    a_csr, _b2, _e2 = assemble_poisson(grid, dtype=np.float64)
    factors = (3, 1, 1)
    fop = _filtered_op(op, factors)
    assert fop is not None and float(fop.cx) == 0.0 and float(fop.cz) != 0.0
    dinv = 1.0 / op.diagonal_field()
    omega = 0.7
    tr = StructuredTransfer.build(
        (n, n, n), omega, np.float64, factors, fop=fop
    )
    ac = galerkin_coarse(op, dinv, tr)

    # explicit oracle: T from the anisotropic blocks, P smoothed with the
    # FILTERED matrix, A_c = P^T A_full P
    a_sp = a_csr.to_scipy()
    K, J, I = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    cz, cy, cx = tr.c_shape
    agg = ((K // 3) * cy + (J // 1)) * cx + (I // 1)
    tnorm = np.asarray(tr.tnorm).reshape(-1)
    t = sp.csr_matrix(
        (tnorm[agg.reshape(-1)], (np.arange(n ** 3), agg.reshape(-1))),
        shape=(n ** 3, cz * cy * cx),
    )
    # filtered A for smoothing: zero the +-1 x and y bands
    lil = a_sp.tolil()
    rows, cols = a_sp.nonzero()
    span = cols - rows
    for r, c, d in zip(rows, cols, span):
        if d in (1, -1, n, -n):  # x and y neighbors in lex order
            lil[r, c] = 0.0
    a_filt = lil.tocsr()
    d = sp.diags(np.asarray(dinv).reshape(-1))
    p = (t - omega * (d @ (a_filt @ t))).tocsr()
    ac_ref = (p.T @ a_sp @ p).toarray()

    # materialize the probed VarStencil27 densely
    n_c = cz * cy * cx
    dense = np.zeros((n_c, n_c))
    eye = np.eye(n_c)
    for j in range(n_c):
        dense[:, j] = np.asarray(
            ac.mv(jnp.asarray(eye[:, j].reshape(cz, cy, cx)))
        ).reshape(-1)
    np.testing.assert_allclose(dense, ac_ref, rtol=1e-8, atol=1e-10)


def _iters(op, b, hier):
    res = cg(
        op.mv, b, rtol=1e-8, atol=0.0, maxiter=400,
        m_mv=lambda r: vcycle(hier, r),
    )
    assert int(res.reason) > 0, int(res.reason)
    return int(res.iters)


@pytest.mark.slow
def test_threshold_beats_isotropic_on_anisotropic():
    """Contrast-100 anisotropic Poisson: the threshold schedule's
    semicoarsening must not lose to (and should beat) isotropic 3^3
    aggregation in iteration count."""
    op, b, _e = _aniso_op(n=24, lz=0.1)
    sched = threshold_schedule(op, 0.05)
    assert sched is not None
    h_iso = gamg_setup(op, AMGParams())
    h_thr = gamg_setup(op, AMGParams(threshold=0.05),
                       factors_schedule=sched)
    it_iso = _iters(op, jnp.asarray(b), h_iso)
    it_thr = _iters(op, jnp.asarray(b), h_thr)
    assert it_thr <= it_iso + 2, (it_thr, it_iso)


@pytest.mark.slow
def test_threshold_zero_unchanged():
    """threshold=0 (the reference config) produces a byte-identical
    hierarchy with or without the schedule plumbing."""
    op, b, _e = poisson_stencil(Grid3D(12, 12, 12))
    h0 = gamg_setup(op, AMGParams())
    h1 = gamg_setup(op, AMGParams(), factors_schedule=None)
    assert len(h0.levels) == len(h1.levels)
    for l0, l1 in zip(h0.levels, h1.levels):
        if l0.transfer is not None:
            assert l0.transfer.factor == l1.transfer.factor


@pytest.mark.slow
def test_sharded_hierarchy_shards_fop():
    """A threshold>0 hierarchy carries a FINE-grid-sized filtered smoothing
    operator (transfer.fop); shard_hierarchy must shard it like lev0.op —
    replicating a VarStencil27 coef stack on every device is a memory
    blowup and forces GSPMD resharding inside restrict/prolong (ADVICE
    r4).  Sharded solve must still match single-device."""
    import jax

    from tpusparse.dist import field_sharding, make_mesh, shard_hierarchy
    from tpusparse.dist.mesh import _put
    from tpusparse.grid.diffusion import assemble_diffusion, default_kappa

    grid = Grid3D(16, 16, 16, lz=0.1)  # strong z coupling
    kappa = default_kappa(grid, contrast=10.0)
    op, _, b = assemble_diffusion(grid, kappa)
    sched = threshold_schedule(op, 0.05)
    assert sched is not None and sched[0] != (3, 3, 3), sched
    hier = gamg_setup(
        op, AMGParams(coarse_eq_limit=64, threshold=0.05),
        factors_schedule=sched,
    )
    fop = hier.levels[0].transfer.fop
    assert fop is not None and fop.coef.ndim == 4

    run = jax.jit(
        lambda op, h, b: cg(
            op.mv, b, rtol=1e-10, maxiter=500,
            m_mv=lambda r: vcycle(h, r),
        )
    )
    res0 = run(op, hier, jnp.asarray(b))

    mesh = make_mesh(8)
    hier_s = shard_hierarchy(hier, mesh)
    fop_s = hier_s.levels[0].transfer.fop
    spec = fop_s.coef.sharding.spec
    assert tuple(spec) == (None, "z", "y", None), spec
    res1 = run(
        _put(op, field_sharding(mesh)),
        hier_s,
        jax.device_put(jnp.asarray(b), field_sharding(mesh)),
    )
    assert int(res1.reason) > 0
    assert int(res0.iters) == int(res1.iters)
    np.testing.assert_allclose(
        np.asarray(res0.x), np.asarray(res1.x), atol=1e-9
    )
