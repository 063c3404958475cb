"""Device-resident padded-ELL sparse matrix — fixed-width CSR replacement.

Why ELL and not CSR: CSR's ragged rows force dynamic shapes and scalar
indptr walks.  Padding every row to a fixed width turns SpMV
into dense, perfectly-tiled arrays — ``vals * x[cols]`` reduced along the
width axis — a vectorized gather + reduction with no dynamic shapes.  Padded
slots store ``col = 0, val = 0`` so the gather is always in-bounds and
mask-free.

Layout: arrays are stored **width-major**, shape ``(width, n_rows)`` — the
ELL "column-major" convention.  It was chosen on the accelerator this was
first built for, where a ``(n_rows, width)`` layout padded the small minor
dimension to 128 lanes (not measured on the GPU); width-major keeps n_rows
minor and the mv is ``width`` contiguous gathers of full rows.

Residency parity: the reference's step-2 optimization keeps the CSR arrays
resident on the GPU across MatMults and moves only x/y per call
(``src/openacc-step2/MatMult_SeqAIJ.patch:18-29``); here the ELL arrays are
ordinary jax device arrays living in HBM for the life of the object, and under
``jit`` x/y never leave the chip either — the whole residency/coherence
protocol of the reference's patched ``MatAssemblyEnd/MatDestroy`` dissolves.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cols", "vals"],
    meta_fields=["shape"],
)
@dataclasses.dataclass
class ELL:
    """Padded-ELL matrix: ``cols``/``vals`` of shape (width, n_rows)."""

    cols: jax.Array  # (width, n_rows) int32; padded entries = 0
    vals: jax.Array  # (width, n_rows) float; padded entries = 0
    shape: tuple[int, int]

    # --- properties --------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def width(self) -> int:
        return self.cols.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int | jax.Array:
        """Count of stored (non-padding) entries."""
        return jnp.sum(self.vals != 0).astype(jnp.int64)

    # --- construction -------------------------------------------------------
    @classmethod
    def from_csr(
        cls,
        csr,
        width: int | None = None,
        dtype=None,
        device=None,
    ) -> "ELL":
        """Convert a HostCSR (or scipy csr) into padded ELL.

        ``width`` defaults to the max row nnz.  Conversion is vectorized
        numpy; arrays are placed on ``device`` (default: jax default device).
        """
        from tpusparse.sparse.csr import HostCSR

        if not isinstance(csr, HostCSR):
            csr = HostCSR.from_scipy(csr)
        n = csr.n_rows
        row_nnz = csr.row_nnz()
        w = int(width) if width is not None else int(row_nnz.max(initial=0))
        w = max(w, 1)
        if row_nnz.max(initial=0) > w:
            raise ValueError(
                f"width {w} < max row nnz {int(row_nnz.max())}"
            )
        # entry e of row r lives at csr.indptr[r] + e; store WIDTH-MAJOR
        pos = csr.indptr[None, :-1] + np.arange(w, dtype=np.int64)[:, None]
        mask = np.arange(w, dtype=np.int64)[:, None] < row_nnz[None, :]
        pos = np.where(mask, pos, 0)
        cols = np.where(mask, csr.indices[pos], 0).astype(np.int32)
        data = csr.data.astype(dtype) if dtype is not None else csr.data
        vals = np.where(mask, data[pos], 0)
        put = partial(jax.device_put, device=device)
        return cls(cols=put(cols), vals=put(vals), shape=csr.shape)

    def to_csr(self):
        """Back to HostCSR (drops padding; for tests/round-trips)."""
        import scipy.sparse as sp

        from tpusparse.sparse.csr import HostCSR

        cols = np.asarray(jax.device_get(self.cols))
        vals = np.asarray(jax.device_get(self.vals))
        keep = vals != 0
        rows = np.broadcast_to(
            np.arange(self.n_rows)[None, :], cols.shape
        )[keep]
        m = sp.csr_matrix(
            (vals[keep], (rows, cols[keep])), shape=self.shape
        )
        m.sum_duplicates()
        m.sort_indices()
        return HostCSR.from_scipy(m)

    # --- operators ----------------------------------------------------------
    def mv(self, x: jax.Array) -> jax.Array:
        """y = A @ x.  MatMult_SeqAIJ parity (PETSc aij.c:1277-1335):
        ``width`` full-row gathers, fused multiply, reduce over width."""
        return jnp.sum(self.vals * x[self.cols], axis=0)

    def mm(self, x: jax.Array) -> jax.Array:
        """Y = A @ X for a dense block of right-hand sides X: (n_cols, k).

        SpMM in the MatMatMult sense: the multi-vector form amortizes the
        column-index traffic over k values.
        """
        # (width, n_rows, k): gather rows of X then scale by vals
        return jnp.einsum("wr,wrk->rk", self.vals, x[self.cols])

    def rmv(self, y: jax.Array) -> jax.Array:
        """x = A^T @ y via scatter-add (segment-sum over stored entries).

        Used for restriction R r = P^T r without materializing P^T.
        """
        contrib = (self.vals * y[None, :]).reshape(-1)
        segs = self.cols.reshape(-1)
        return jax.ops.segment_sum(contrib, segs, num_segments=self.n_cols)

    def diagonal(self) -> jax.Array:
        rows = jnp.arange(self.n_rows, dtype=self.cols.dtype)[None, :]
        on_diag = (self.cols == rows) & (self.vals != 0)
        return jnp.sum(jnp.where(on_diag, self.vals, 0), axis=0)

    def __matmul__(self, x):
        return self.mv(x)
