"""Bandwidth-reducing reordering — the bridge from arbitrary-sparsity CSR
to the bounded-band executors.

The reference's patched kernel is *general CSR* SpMV: any row structure,
straight off ``a->i/a->j/a->a`` (the reference's
``src/openacc-step1/MatMult_SeqAIJ.patch:19-30``).  This layer was built
for an accelerator that could not stream scattered gathers (its runtime
failed on >~1.5M-row gather operands inside solver loops,
``sparse/dia.py::GATHER_ROW_CAP``; an inherited limit, not measured on the
GPU), and DIA storage explodes when the matrix occupies many distinct
diagonals.  Its answer to "any CSR" is a *reordering layer*: Reverse
Cuthill-McKee bounds the graph bandwidth, after which every executor
ingredient is bounded-band — DIA when few diagonals remain, the segmented
``sparse/bandell.BandedELL`` (window-local gathers only) otherwise.

The permutation is carried by the solver shell (``ksp.KSP``): the system
is solved in permuted space (``P A P^T (P x) = P b``) and the solution
unpermuted on the way out — CG sees a similarity-transformed operator.
Unpreconditioned or point-Jacobi CG therefore takes the natural-order
iteration counts; GAMG aggregates the permuted graph differently, so its
counts can differ.
"""

from __future__ import annotations

import numpy as np

from tpusparse.sparse.csr import HostCSR


def bandwidth(a: HostCSR) -> int:
    """max |col - row| over stored entries (0 for diagonal/empty)."""
    if a.nnz == 0:
        return 0
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr))
    return int(np.abs(a.indices.astype(np.int64) - rows).max())


def distinct_diagonals(a: HostCSR) -> int:
    """Number of occupied diagonals (the DIA storage axis)."""
    if a.nnz == 0:
        return 0
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr))
    return int(np.unique(a.indices.astype(np.int64) - rows).size)


def rcm_permutation(a: HostCSR) -> np.ndarray:
    """RCM ordering of A's graph: ``perm[new] = old`` (int64[n]).

    Native (csrc/tpusparse_native.cpp::rcm_order) when built, else scipy's
    ``reverse_cuthill_mckee``.  The pattern is symmetrized first when it
    is not already structurally symmetric (RCM walks an undirected graph).
    """
    if not _pattern_symmetric(a):
        a = _symmetrize_pattern(a)
    from tpusparse import native

    return native.rcm(a)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


def permute_csr(a: HostCSR, perm: np.ndarray) -> HostCSR:
    """B = P A P^T with P the permutation matrix of ``perm`` (perm[new] =
    old): ``B[i, j] = A[perm[i], perm[j]]`` — the similarity transform that
    preserves symmetry, spectrum, and therefore CG iteration counts."""
    s = a.to_scipy()[perm][:, perm].tocsr()
    s.sort_indices()
    return HostCSR.from_scipy(s)


def _pattern_symmetric(a: HostCSR) -> bool:
    s = a.to_scipy()
    s2 = s.copy()
    s2.data = np.ones_like(s2.data)
    d = (s2 - s2.T).tocsr()
    d.eliminate_zeros()
    return d.nnz == 0


def _symmetrize_pattern(a: HostCSR) -> HostCSR:
    s = a.to_scipy()
    p = s.copy()
    p.data = np.ones_like(p.data)
    sym = (p + p.T).tocsr()
    sym.sort_indices()
    return HostCSR.from_scipy(sym)
