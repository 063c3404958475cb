"""The XLA operator applies the solve runs on every device, against HostCSR.

``StarStencil3D.mv`` (the fine-level apply of the structured path) and
``DIA.mv`` (the general-matrix path's banded apply) are checked against a
HostCSR assembled independently with scipy, on odd shapes and shapes that
are no multiple of 8 or 128, pinned and unpinned, in float32 and float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from tpusparse.sparse.csr import HostCSR
from tpusparse.sparse.dia import DIA
from tpusparse.sparse.stencil import StarStencil3D

# rounding of a 7-term sum, relative to |diag|*|x|
TOL = {np.float32: 2e-6, np.float64: 1e-14}


def _star_csr(diag, cx, cy, cz, pinned) -> HostCSR:
    """The star matrix from Kronecker products (natural ordering, x
    fastest), independent of the stencil code."""
    nz, ny, nx = diag.shape

    def path(n):
        return sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1])

    def eye(n):
        return sp.identity(n)

    a = (
        sp.diags(diag.reshape(-1))
        + cx * sp.kron(eye(nz), sp.kron(eye(ny), path(nx)))
        + cy * sp.kron(eye(nz), sp.kron(path(ny), eye(nx)))
        + cz * sp.kron(path(nz), sp.kron(eye(ny), eye(nx)))
    ).tolil()
    if pinned:
        d0 = a[0, 0]
        a[0, :] = 0
        a[:, 0] = 0
        a[0, 0] = d0
    return HostCSR.from_scipy(a.tocsr())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape", [(5, 7, 9), (13, 11, 3), (3, 9, 130),
                                   (2, 1, 17)])
def test_star_stencil_mv_matches_host_csr(shape, pinned, dtype):
    rng = np.random.default_rng(hash((shape, pinned)) % 2**32)
    diag = rng.uniform(-6.5, -5.5, shape).astype(dtype)
    x = rng.uniform(-1.0, 1.0, shape).astype(dtype)
    cx, cy, cz = (dtype(c) for c in rng.uniform(0.5, 1.5, 3))
    op = StarStencil3D(diag=jnp.asarray(diag), cx=jnp.asarray(cx),
                       cy=jnp.asarray(cy), cz=jnp.asarray(cz), pinned=pinned)
    got = np.asarray(jax.jit(lambda o, v: o.mv(v))(op, jnp.asarray(x)))
    assert got.dtype == dtype and got.shape == shape
    ref = _star_csr(diag.astype(np.float64), float(cx), float(cy),
                    float(cz), pinned).mv(x.astype(np.float64).reshape(-1))
    err = np.abs(got.reshape(-1) - ref).max()
    assert err <= TOL[dtype] * np.abs(diag).max() * np.abs(x).max(), err


def _banded_csr(n, offsets, rng):
    """A random banded CSR: bands[k, r] = A[r, r + offsets[k]]."""
    bands = rng.uniform(-1.0, 1.0, (len(offsets), n))
    rows, cols, vals = [], [], []
    for k, o in enumerate(offsets):
        r = np.arange(max(0, -o), min(n, n - o))
        rows.append(r)
        cols.append(r + o)
        vals.append(bands[k, r])
    a = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    return HostCSR.from_scipy(a), bands


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "n,offsets",
    [
        (17, (-1, 0, 1)),
        (130, (-100, -10, -1, 0, 1, 10, 100)),
        (343, (-49, -7, -1, 0, 1, 7, 49)),           # the 7^3 star
        (200, (-199, -3, 0, 5, 150)),                # sparse, lopsided
    ],
)
def test_dia_mv_matches_host_csr(n, offsets, dtype):
    rng = np.random.default_rng(n)
    a, _ = _banded_csr(n, offsets, rng)
    a32 = HostCSR(a.indptr, a.indices, a.data.astype(dtype), a.shape)
    dia = DIA.from_csr(a32)
    assert dia.offsets == tuple(sorted(offsets))
    x = rng.uniform(-1.0, 1.0, n).astype(dtype)
    got = np.asarray(jax.jit(lambda d, v: d.mv(v))(dia, jnp.asarray(x)))
    assert got.dtype == dtype
    ref = a32.mv(x.astype(np.float64))
    err = np.abs(got - ref).max()
    assert err <= TOL[dtype] * np.abs(a32.data).max() * np.abs(x).max(), err
