"""Host-side CSR container (numpy) — setup-time staging format.

Role parity: PETSc SeqAIJ's on-rank CSR triplet ``a->i / a->j / a->a``
(the arrays the reference's OpenACC kernels operate on, e.g.
``src/openacc-step1/MatMult_SeqAIJ.patch``).  Here CSR is a *host
staging* format only: assembly and AMG setup produce HostCSR, which is then
converted once into a device-resident layout (``dia.py``, ``ell.py``) —
the analogue of the reference's "upload matrix once, keep it resident"
step-2 optimization (``src/openacc-step2/MatMult_SeqAIJ.patch``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HostCSR:
    """Compressed sparse row matrix on the host (numpy arrays)."""

    indptr: np.ndarray   # (n_rows + 1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray     # (nnz,) float
    shape: tuple[int, int]

    # --- properties --------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def dtype(self):
        return self.data.dtype

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def max_row_nnz(self) -> int:
        return int(self.row_nnz().max(initial=0))

    # --- constructors -------------------------------------------------------
    @classmethod
    def from_scipy(cls, m) -> "HostCSR":
        m = m.tocsr()
        m.sort_indices()
        return cls(
            indptr=np.asarray(m.indptr, dtype=np.int64),
            indices=np.asarray(m.indices, dtype=np.int32),
            data=np.asarray(m.data),
            shape=tuple(m.shape),
        )

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )

    @classmethod
    def from_dense(cls, a: np.ndarray) -> "HostCSR":
        import scipy.sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(a)))

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    # --- reference ops (numpy oracles, not the hot path) --------------------
    def mv(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x.  Reference semantics of MatMult_SeqAIJ
        (PETSc aij.c:1277-1335 as extracted by the reference's
        ``scripts/petsc.sh:81-86``): per-row dot of stored entries."""
        x = np.asarray(x)
        y = np.zeros(self.n_rows, dtype=np.result_type(self.data, x))
        np.add.at(
            y,
            np.repeat(np.arange(self.n_rows), self.row_nnz()),
            self.data * x[self.indices],
        )
        return y

    def diagonal(self) -> np.ndarray:
        """MatGetDiagonal equivalent (reference ``src/helper.cpp:264``)."""
        d = np.zeros(self.n_rows, dtype=self.dtype)
        for_rows = np.repeat(np.arange(self.n_rows), self.row_nnz())
        on_diag = for_rows == self.indices
        d[for_rows[on_diag]] = self.data[on_diag]
        return d

    def transpose(self) -> "HostCSR":
        return HostCSR.from_scipy(self.to_scipy().T.tocsr())
