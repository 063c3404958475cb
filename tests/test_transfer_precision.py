"""Grid-transfer contractions against float64 numpy, and the precision every
float32 contraction of the solve asks for.

On a GPU a float32 dot at default precision may run in TF32 (about three
decimal digits), so each contraction on the solve path pins
``Precision.HIGHEST``; the lowered program must say so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse.amg.transfer import (
    StructuredTransfer,
    block_sum3,
    coarse_shape,
    expand3,
    norm_factors,
)


def _expand_np(e, shape, factor):
    x = np.asarray(e, np.float64)
    for ax, f in enumerate(norm_factors(factor)):
        x = np.repeat(x, f, axis=ax)
    return x[: shape[0], : shape[1], : shape[2]]


def _block_sum_np(r, factor):
    f = norm_factors(factor)
    c = coarse_shape(r.shape, factor)
    x = np.pad(np.asarray(r, np.float64),
               [(0, ci * fi - s) for ci, fi, s in zip(c, f, r.shape)])
    x = x.reshape(c[0], f[0], c[1], f[1], c[2], f[2])
    return x.sum(axis=(1, 3, 5))


CASES = [((9, 9, 9), 3), ((10, 8, 7), 3), ((12, 7, 11), (3, 1, 1)),
         ((6, 9, 5), (1, 3, 2))]


@pytest.mark.parametrize("shape,factor", CASES)
def test_t_apply_matches_numpy(shape, factor):
    tr = StructuredTransfer.build(shape, 0.5, jnp.float32, factor)
    rng = np.random.default_rng(1)
    ec = rng.uniform(-1, 1, tr.c_shape).astype(np.float32)
    got = np.asarray(jax.jit(tr.t_apply)(jnp.asarray(ec)))
    ref = _expand_np(ec * np.asarray(tr.tnorm, np.float64), shape, factor)
    assert got.shape == shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("shape,factor", CASES)
def test_tT_apply_matches_numpy(shape, factor):
    tr = StructuredTransfer.build(shape, 0.5, jnp.float32, factor)
    rng = np.random.default_rng(2)
    r = rng.uniform(-1, 1, shape).astype(np.float32)
    got = np.asarray(jax.jit(tr.tT_apply)(jnp.asarray(r)))
    ref = _block_sum_np(r, factor) * np.asarray(tr.tnorm, np.float64)
    assert got.shape == tr.c_shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_geo_transfer_up_down_match_numpy():
    from tpusparse.amg.geo import GeoTransfer

    shape, bs = (7, 8, 9), (2, 3, 3)
    w = jnp.ones(int(np.prod(shape)), jnp.float32)
    tr = GeoTransfer.build(w, jnp.float32(0.0), shape, bs)
    rng = np.random.default_rng(3)
    ec = rng.uniform(-1, 1, tr.n_coarse).astype(np.float32)
    v = rng.uniform(-1, 1, int(np.prod(shape))).astype(np.float32)
    up = np.asarray(jax.jit(tr._up)(jnp.asarray(ec)))
    down = np.asarray(jax.jit(tr._down)(jnp.asarray(v)))
    ref_up = _expand_np(ec.reshape(tr.coarse_shape), shape, bs).reshape(-1)
    ref_down = _block_sum_np(v.reshape(shape), bs).reshape(-1)
    np.testing.assert_allclose(up, ref_up, atol=1e-6)
    np.testing.assert_allclose(down, ref_down,
                               atol=1e-6 * np.abs(ref_down).max())


def _dot_lines(fn, *args) -> list[str]:
    text = jax.jit(fn).lower(*args).as_text()
    return [ln for ln in text.splitlines() if "dot_general" in ln]


def _transfer_args():
    tr = StructuredTransfer.build((9, 9, 9), 0.5, jnp.float32)
    return tr, jnp.ones((9, 9, 9), jnp.float32), jnp.ones((3, 3, 3),
                                                          jnp.float32)


def _contractions():
    """(name, fn, args) of every float32 contraction on the solve path."""
    from tpusparse.amg.geo import GeoTransfer
    from tpusparse.amg.hierarchy import Level, _coarse_direct
    from tpusparse.grid.grid3d import Grid3D
    from tpusparse.grid.poisson import assemble_poisson, poisson_stencil
    from tpusparse.solve.bjacobi import BlockJacobi
    from tpusparse.sparse.bsr import BSR

    tr, fine, coarse = _transfer_args()
    geo = GeoTransfer.build(jnp.ones(9 ** 3, jnp.float32), jnp.float32(0.0),
                            (9, 9, 9), (3, 3, 3))
    a, _, _ = assemble_poisson(Grid3D(4, 4, 4), dtype=np.float32)
    bj = BlockJacobi.build(a, 4, dtype=np.float32)
    bsr = BSR.from_csr(a, 2, dtype=np.float32)
    op, _, _ = poisson_stencil(Grid3D(3, 3, 3), dtype=np.float32)
    lev = Level(op=op, dinv=op.diag, rho=jnp.float32(1.0), transfer=None,
                coarse_inv=jnp.eye(27, dtype=jnp.float32))
    v64 = jnp.ones(64, jnp.float32)
    return [
        ("t_apply", tr.t_apply, (coarse,)),
        ("tT_apply", tr.tT_apply, (fine,)),
        ("expand3", lambda e: expand3(e, tr.sz, tr.sy, tr.sx), (coarse,)),
        ("block_sum3", lambda r: block_sum3(r, tr.sz, tr.sy, tr.sx),
         (fine,)),
        ("geo_up", geo._up, (jnp.ones(27, jnp.float32),)),
        ("geo_down", geo._down, (jnp.ones(9 ** 3, jnp.float32),)),
        ("bjacobi_apply", bj.apply, (v64,)),
        ("bsr_mv", bsr.mv, (v64,)),
        ("bsr_mm", bsr.mm, (jnp.ones((64, 3), jnp.float32),)),
        ("coarse_direct", lambda b: _coarse_direct(lev, b),
         (jnp.ones((3, 3, 3), jnp.float32),)),
    ]


@pytest.mark.parametrize("idx", range(10))
def test_float32_contractions_lower_at_highest_precision(idx):
    name, fn, args = _contractions()[idx]
    lines = _dot_lines(fn, *args)
    assert lines, f"{name}: no dot_general in the lowered program"
    for ln in lines:
        assert "HIGHEST" in ln, f"{name}: {ln.strip()}"


def test_sharded_transfer_lowers_at_highest_precision():
    """The 4-device seam transfer (dist/seam.py) on a 2x2 (z, y) mesh."""
    from tpusparse.amg import AMGParams, gamg_setup
    from tpusparse.dist import make_mesh, shard_hierarchy, shard_system
    from tpusparse.dist.seam import ShardedTransfer
    from tpusparse.grid.grid3d import Grid3D
    from tpusparse.grid.poisson import poisson_stencil

    op, b, exact = poisson_stencil(Grid3D(12, 12, 12), dtype=np.float32)
    hier = gamg_setup(op, AMGParams(coarse_eq_limit=30))
    mesh = make_mesh(4)
    _, b_s, _ = shard_system(op, b, exact, mesh)
    tr = shard_hierarchy(hier, mesh).levels[0].transfer
    assert isinstance(tr, ShardedTransfer)
    for fn, arg in ((tr.tT_apply, b_s),
                    (tr.t_apply, jnp.ones(tr.c_shape, jnp.float32))):
        lines = _dot_lines(fn, arg)
        assert lines and all("HIGHEST" in ln for ln in lines), lines
