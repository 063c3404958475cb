"""Device-resident COO sparse matrix — assembly-order format.

Role parity: PETSc's ``MatSetValues`` accumulation stage before
``MatAssemblyEnd`` compaction (reference ``src/helper.cpp:236-243``):
coordinate triplets are the natural form while entries are being produced
(possibly with duplicates), before conversion to a compute layout (ELL /
stencil).  The mv is a ``segment_sum`` over row ids — static shapes,
no atomics — adequate for setup-path products and as the general container
for matrices too irregular for padded-ELL.

Duplicate entries ARE supported (they sum, matching ``ADD_VALUES``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rows", "cols", "vals"],
    meta_fields=["shape", "rows_sorted"],
)
@dataclasses.dataclass
class COO:
    """Coordinate-format sparse matrix on device."""

    rows: jax.Array  # (nnz,) int32
    cols: jax.Array  # (nnz,) int32
    vals: jax.Array  # (nnz,) float
    shape: tuple[int, int]
    rows_sorted: bool = False  # enables the faster sorted segment_sum

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    # --- construction -------------------------------------------------------
    @classmethod
    def from_csr(cls, csr, dtype=None, device=None) -> "COO":
        from tpusparse.sparse.csr import HostCSR

        if not isinstance(csr, HostCSR):
            csr = HostCSR.from_scipy(csr)
        rows = np.repeat(
            np.arange(csr.n_rows, dtype=np.int32), csr.row_nnz()
        )
        data = csr.data.astype(dtype) if dtype is not None else csr.data
        put = partial(jax.device_put, device=device)
        return cls(
            rows=put(rows),
            cols=put(csr.indices.astype(np.int32)),
            vals=put(data),
            shape=csr.shape,
            rows_sorted=True,
        )

    def to_csr(self):
        """Back to HostCSR (sums duplicates — MatAssemblyEnd parity)."""
        import scipy.sparse as sp

        from tpusparse.sparse.csr import HostCSR

        m = sp.csr_matrix(
            (
                np.asarray(jax.device_get(self.vals)),
                (
                    np.asarray(jax.device_get(self.rows)),
                    np.asarray(jax.device_get(self.cols)),
                ),
            ),
            shape=self.shape,
        )
        m.sum_duplicates()
        m.sort_indices()
        return HostCSR.from_scipy(m)

    # --- operators ----------------------------------------------------------
    def mv(self, x: jax.Array) -> jax.Array:
        """y = A @ x as a segment-sum of per-entry products."""
        contrib = self.vals * x[self.cols]
        return jax.ops.segment_sum(
            contrib,
            self.rows,
            num_segments=self.shape[0],
            indices_are_sorted=self.rows_sorted,
        )

    def mm(self, x: jax.Array) -> jax.Array:
        """Y = A @ X for X of shape (n_cols, k) (SpMM)."""
        contrib = self.vals[:, None] * x[self.cols]
        return jax.ops.segment_sum(
            contrib, self.rows, num_segments=self.shape[0],
            indices_are_sorted=self.rows_sorted,
        )

    def rmv(self, y: jax.Array) -> jax.Array:
        """x = A^T @ y (segment-sum over columns)."""
        contrib = self.vals * y[self.rows]
        return jax.ops.segment_sum(
            contrib, self.cols, num_segments=self.shape[1]
        )

    def diagonal(self) -> jax.Array:
        on_diag = self.rows == self.cols
        return jax.ops.segment_sum(
            jnp.where(on_diag, self.vals, 0),
            self.rows,
            num_segments=self.shape[0],
            indices_are_sorted=self.rows_sorted,
        )

    def __matmul__(self, x):
        return self.mv(x)
