"""Explicit shard_map halo-exchange SpMV vs the GSPMD path and single-device.

Exercised on the 8-device virtual CPU mesh (tests/conftest.py) — the same
communication pattern that runs between GPUs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse.dist import make_mesh, shard_system
from tpusparse.dist.halo import halo_mv
from tpusparse.grid.grid3d import Grid3D
from tpusparse.grid.poisson import poisson_stencil
from tpusparse.solve import cg


@pytest.mark.slow
@pytest.mark.parametrize("pin", [True, False])
@pytest.mark.parametrize("mesh_shape", [None, (8, 1), (2, 4)])
def test_halo_mv_matches_single_device(pin, mesh_shape):
    grid = Grid3D(16, 16, 16)
    op, b, exact = poisson_stencil(grid, pin=pin)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(grid.shape))

    y_ref = np.asarray(op.mv(x))

    mesh = make_mesh(8, shape=mesh_shape)
    op_s, x_s, _ = shard_system(op, x, exact, mesh)
    y = halo_mv(op_s, x_s, mesh)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-13, atol=1e-13)


def test_halo_mv_matches_gspmd():
    grid = Grid3D(12, 16, 8)
    op, b, exact = poisson_stencil(grid)
    mesh = make_mesh(8, shape=(2, 4))
    op_s, b_s, _ = shard_system(op, b, exact, mesh)

    y_gspmd = jax.jit(lambda op, v: op.mv(v))(op_s, b_s)
    y_halo = jax.jit(lambda op, v: halo_mv(op, v, mesh))(op_s, b_s)
    np.testing.assert_allclose(
        np.asarray(y_halo), np.asarray(y_gspmd), rtol=1e-13, atol=1e-13
    )


def test_cg_with_halo_operator():
    """Full CG solve where every MatMult goes through the explicit halo path."""
    grid = Grid3D(16, 16, 16)
    op, b, exact = poisson_stencil(grid)
    mesh = make_mesh(8)
    op_s, b_s, exact_s = shard_system(op, b, exact, mesh)

    @jax.jit
    def solve(op, b):
        return cg(lambda v: halo_mv(op, v, mesh), b, rtol=1e-10, maxiter=2000)

    res = solve(op_s, b_s)
    assert res.converged()
    linf = float(jnp.max(jnp.abs(res.x - exact_s)))
    assert linf < 5e-2
