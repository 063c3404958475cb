"""Device-resident BSR (block compressed sparse row) matrix.

Role parity: PETSc's BAIJ family — the format PETSc recommends for
multi-dof-per-node discretizations (the reference's Poisson has dof=1, but
BASELINE.json's config 3 exercises BSR explicitly).  Design: blocks are
stored as one dense (nnzb, bs, bs) array so y_block = B · x_block is a
*batched small matmul* (einsum, at full float32 precision), and block-row
accumulation is a segment-sum — no scalar indptr walks, static shapes
throughout.

For bs=1 this degenerates to COO-with-sorted-rows (scalar case covered by
ELL/stencil); the interesting regime is bs in {2..8} where each stored block
amortizes its column index over bs^2 values.

Inherited known issue (not measured on the GPU): on the accelerator this
was first built for, gather-based sparse mv inside a ``lax.while_loop``
failed at >= ~2M rows; ``solve/cg.cg_hostloop`` (fixed-trip fori_loop
chunks) was the workaround.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["brows", "bcols", "blocks"],
    meta_fields=["shape", "bs"],
)
@dataclasses.dataclass
class BSR:
    """Block-sparse matrix with square ``bs`` x ``bs`` blocks.

    ``brows``/``bcols``: (nnzb,) block coordinates (rows sorted);
    ``blocks``: (nnzb, bs, bs) values.  ``shape`` is the SCALAR shape.
    """

    brows: jax.Array   # (nnzb,) int32, sorted
    bcols: jax.Array   # (nnzb,) int32
    blocks: jax.Array  # (nnzb, bs, bs)
    shape: tuple[int, int]
    bs: int

    @property
    def nnzb(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnz(self) -> int:
        return self.nnzb * self.bs * self.bs

    @property
    def n_brows(self) -> int:
        return self.shape[0] // self.bs

    @property
    def dtype(self):
        return self.blocks.dtype

    # --- construction -------------------------------------------------------
    @classmethod
    def from_scipy_bsr(cls, m, dtype=None, device=None) -> "BSR":
        """From a ``scipy.sparse.bsr_matrix`` (or convertible)."""
        import scipy.sparse as sp

        if not sp.issparse(m):
            raise TypeError("expected a scipy sparse matrix")
        bs = m.blocksize[0] if hasattr(m, "blocksize") else 1
        m = m.tobsr(blocksize=(bs, bs)) if m.format != "bsr" else m
        m.sort_indices()
        bs = m.blocksize[0]
        if m.blocksize[0] != m.blocksize[1]:
            raise ValueError(f"square blocks only, got {m.blocksize}")
        nbrows = m.shape[0] // bs
        brows = np.repeat(
            np.arange(nbrows, dtype=np.int32), np.diff(m.indptr)
        )
        data = m.data.astype(dtype) if dtype is not None else m.data
        put = partial(jax.device_put, device=device)
        return cls(
            brows=put(brows),
            bcols=put(m.indices.astype(np.int32)),
            blocks=put(data),
            shape=tuple(m.shape),
            bs=bs,
        )

    @classmethod
    def from_csr(cls, csr, bs: int, dtype=None, device=None) -> "BSR":
        """Re-block a HostCSR/scipy CSR into bs x bs blocks."""
        from tpusparse.sparse.csr import HostCSR

        if isinstance(csr, HostCSR):
            csr = csr.to_scipy()
        return cls.from_scipy_bsr(csr.tobsr(blocksize=(bs, bs)), dtype, device)

    def to_csr(self):
        import scipy.sparse as sp

        from tpusparse.sparse.csr import HostCSR

        nbrows = self.n_brows
        indptr = np.zeros(nbrows + 1, np.int64)
        np.add.at(indptr[1:], np.asarray(jax.device_get(self.brows)), 1)
        np.cumsum(indptr, out=indptr)
        m = sp.bsr_matrix(
            (
                np.asarray(jax.device_get(self.blocks)),
                np.asarray(jax.device_get(self.bcols)),
                indptr,
            ),
            shape=self.shape,
        )
        c = m.tocsr()
        c.sum_duplicates()
        c.sort_indices()
        c.eliminate_zeros()
        return HostCSR.from_scipy(c)

    # --- operators ----------------------------------------------------------
    def mv(self, x: jax.Array) -> jax.Array:
        """y = A @ x: gather x blocks, batched bs x bs matmuls, segment-sum."""
        xb = x.reshape(-1, self.bs)                      # (nbcols, bs)
        contrib = jnp.einsum(
            "nij,nj->ni", self.blocks, xb[self.bcols],
            precision=jax.lax.Precision.HIGHEST,
        )                                                # (nnzb, bs)
        yb = jax.ops.segment_sum(
            contrib, self.brows, num_segments=self.n_brows,
            indices_are_sorted=True,
        )
        return yb.reshape(-1)

    def mm(self, x: jax.Array) -> jax.Array:
        """Y = A @ X for X of shape (n_cols, k) (SpMM over block rows)."""
        k = x.shape[1]
        xb = x.reshape(-1, self.bs, k)                   # (nbcols, bs, k)
        contrib = jnp.einsum(
            "nij,njk->nik", self.blocks, xb[self.bcols],
            precision=jax.lax.Precision.HIGHEST,
        )                                                # (nnzb, bs, k)
        yb = jax.ops.segment_sum(
            contrib, self.brows, num_segments=self.n_brows,
            indices_are_sorted=True,
        )
        return yb.reshape(-1, k)

    def diagonal(self) -> jax.Array:
        """Scalar diagonal (diagonal entries of diagonal blocks)."""
        on_diag = self.brows == self.bcols
        dblocks = jnp.where(
            on_diag[:, None, None], self.blocks, jnp.zeros((), self.dtype)
        )
        # sum the (at most one) diagonal block per block-row
        dsum = jax.ops.segment_sum(
            dblocks, self.brows, num_segments=self.n_brows,
            indices_are_sorted=True,
        )                                                # (nbrows, bs, bs)
        return jnp.diagonal(dsum, axis1=1, axis2=2).reshape(-1)

    def __matmul__(self, x):
        return self.mv(x)
