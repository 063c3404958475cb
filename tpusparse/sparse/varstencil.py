"""Variable-coefficient 27-point stencil operator — gather-free coarse-level
matrices for structured AMG.

Smoothed-aggregation Galerkin products P^T A P (the operators PETSc GAMG
builds by SpGEMM at ``KSPSetUp``, exercised from ``src/main_ksp.cpp:97``) stay
inside a 27-point neighborhood when aggregation is geometric 3x3x3 and the
prolongator is smoothed once: P's column support has infinity-norm radius
<= 2 fine cells (aggregate +-1, smoothing +-1), A couples at radius <= 1, so
two coarse cells interact only if their centers are <= 5 fine cells apart —
and coarse centers are 3 apart, so only the 27 immediate coarse neighbors
couple.  That invariant is preserved level-to-level (a 27-point operator has
radius 1, giving the same bound), so every AMG level is representable as
``coef[o] * x_shifted_by_o`` summed over the 27 offsets: pure shifted
multiply-adds, no column indices, no gathers — each shift a single
``lax.pad`` crop/pad.

This is the replacement for storing coarse Galerkin operators in
CSR/ELL: SpMV reads only dense coefficient planes at full HBM bandwidth.
"""

from __future__ import annotations

import dataclasses
import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# the 27 offsets in a fixed lexicographic order (dk, dj, di), each in {-1,0,1}
OFFSETS: tuple[tuple[int, int, int], ...] = tuple(
    itertools.product((-1, 0, 1), repeat=3)
)
CENTER = OFFSETS.index((0, 0, 0))  # = 13


def shift3(x: jax.Array, off: tuple[int, int, int]) -> jax.Array:
    """out[p] = x[p + off] with zero fill — one lax.pad (crop+pad per axis)."""
    cfg = tuple((-d, d, 0) for d in off)
    if all(d == 0 for d in off):
        return x
    return lax.pad(x, jnp.zeros((), x.dtype), cfg)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["coef"],
    meta_fields=[],
)
@dataclasses.dataclass
class VarStencil27:
    """y[p] = sum_o coef[o][p] * x[p + o], offsets o in OFFSETS order.

    ``coef`` has shape (27, nz, ny, nx).  Entries whose target p + o falls
    outside the grid are never read (zero-filled shift), so their coefficients
    are irrelevant; setup stores zeros there.
    """

    coef: jax.Array  # (27, nz, ny, nx)

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return self.coef.shape[1:]

    @property
    def shape(self) -> tuple[int, int]:
        n = int(np.prod(self.coef.shape[1:]))
        return (n, n)

    @property
    def dtype(self):
        return self.coef.dtype

    def mv(self, x: jax.Array) -> jax.Array:
        """y = A @ x on the 3D field view."""
        y = self.coef[CENTER] * x
        for o, off in enumerate(OFFSETS):
            if o == CENTER:
                continue
            y = y + self.coef[o] * shift3(x, off)
        return y

    def mv_flat(self, x: jax.Array) -> jax.Array:
        return self.mv(x.reshape(self.grid_shape)).reshape(-1)

    def diagonal_field(self) -> jax.Array:
        return self.coef[CENTER]

    def gs_color_masks(self) -> list:
        """2x2x2 octant (8-color) coloring: a 27-point stencil reaches at
        most one cell per axis, so points sharing (k%2, j%2, i%2) are
        mutually independent — each masked simultaneous update is a
        Gauss-Seidel ordering (multicolor SOR)."""
        shape = self.grid_shape
        k = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        i = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
        c = (k % 2) * 4 + (j % 2) * 2 + (i % 2)
        return [c == q for q in range(8)]

    def flat_band_fields(self, max_abs_offset: int) -> dict:
        """{flat offset o: field f with f[p] = A[p, p+o]} for every stencil
        offset with 0 < |flat o| < ``max_abs_offset``.  Stored coefficients
        whose shift target falls outside the grid are never read by ``mv``
        and may be arbitrary, so they are masked out here.  Distinct 3-D
        offsets can alias to one flat offset on tiny grids (e.g. nx == 2:
        (0,1,-1) and (0,0,1) both reach p+1) — aliases accumulate, exactly
        like the CSR assembly would sum duplicate (row, col) entries.
        Consumed by ``solve/bjacobi.py::BlockJacobi.from_bands``."""
        nz, ny, nx = self.grid_shape
        shape = self.grid_shape
        k = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        i = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
        zero = jnp.zeros((), self.dtype)
        out: dict = {}
        for o3, (dk, dj, di) in enumerate(OFFSETS):
            if (dk, dj, di) == (0, 0, 0):
                continue
            o = (dk * ny + dj) * nx + di
            if o == 0 or abs(o) >= max_abs_offset:
                continue
            valid = (
                (k + dk >= 0) & (k + dk < nz)
                & (j + dj >= 0) & (j + dj < ny)
                & (i + di >= 0) & (i + di < nx)
            )
            f = jnp.where(valid, self.coef[o3], zero)
            out[o] = out[o] + f if o in out else f
        return out

    def __matmul__(self, x):
        return self.mv(x) if x.ndim == 3 else self.mv_flat(x)

    # --- conversions (host, for tests / interop) ---------------------------
    @classmethod
    def from_csr(cls, csr, grid_shape: tuple[int, int, int]) -> "VarStencil27":
        """Bin a CSR matrix on the given grid into 27-offset planes.

        Raises if any entry falls outside the 27-point neighborhood.
        """
        nz, ny, nx = grid_shape
        n = nz * ny * nx
        if csr.shape != (n, n):
            raise ValueError(f"csr shape {csr.shape} != grid {grid_shape}")
        rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz())
        cols = csr.indices.astype(np.int64)
        rk, rj, ri = rows // (ny * nx), (rows // nx) % ny, rows % nx
        ck, cj, ci = cols // (ny * nx), (cols // nx) % ny, cols % nx
        dk, dj, di = ck - rk, cj - rj, ci - ri
        if np.any(np.abs(np.stack([dk, dj, di])) > 1):
            bad = np.abs(np.stack([dk, dj, di])).max()
            raise ValueError(f"entries beyond 27-point neighborhood (max |off|={bad})")
        o = (dk + 1) * 9 + (dj + 1) * 3 + (di + 1)
        coef = np.zeros((27, n), dtype=csr.data.dtype)
        coef[o, rows] = csr.data
        return cls(coef=jnp.asarray(coef.reshape(27, nz, ny, nx)))

    def to_csr(self):
        """Back to HostCSR (drops zero coefficients)."""
        import scipy.sparse as sp

        from tpusparse.sparse.csr import HostCSR

        nz, ny, nx = self.grid_shape
        n = nz * ny * nx
        coef = np.asarray(jax.device_get(self.coef)).reshape(27, n)
        rows_all, cols_all, vals_all = [], [], []
        K, J, I = np.meshgrid(
            np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
        )
        for o, (dk, dj, di) in enumerate(OFFSETS):
            kk, jj, ii = K + dk, J + dj, I + di
            valid = (
                (kk >= 0) & (kk < nz) & (jj >= 0) & (jj < ny)
                & (ii >= 0) & (ii < nx)
            ).reshape(-1)
            v = coef[o]
            keep = valid & (v != 0)
            rows_all.append(np.flatnonzero(keep))
            cols_all.append(((kk * ny + jj) * nx + ii).reshape(-1)[keep])
            vals_all.append(v[keep])
        m = sp.csr_matrix(
            (
                np.concatenate(vals_all),
                (np.concatenate(rows_all), np.concatenate(cols_all)),
            ),
            shape=(n, n),
        )
        m.sum_duplicates()
        m.sort_indices()
        return HostCSR.from_scipy(m)
