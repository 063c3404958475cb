"""Segmented banded-ELL — the gather-safe executor for bounded-bandwidth
general CSR at ANY row count.

Completes the general-matrix (MatMult_SeqAIJ) story: plain ELL's
``x[cols]`` gather failed on the accelerator this was first built for once
the gather operand exceeded ~1.5M rows inside solver loops
(``sparse/dia.py`` GATHER_ROW_CAP; an inherited limit, not measured on the
GPU), and DIA storage
is infeasible when the
matrix occupies thousands of distinct diagonals — exactly what an
RCM-reordered scattered matrix looks like (bounded bandwidth W, arbitrary
in-band structure; ``sparse/reorder.py``).

The fix is to make every gather SMALL: rows are split into static
segments of L rows; row i of segment s only references columns in
[s*L - W, (s+1)*L + W), so the segment's entire x window is one
**statically-sliced** (L + 2W)-vector and the per-entry gather indexes
only that window.  The segment loop is unrolled at trace time (S = n/L is
small), so the whole mv is ordinary fused XLA with S window-local gathers
— no gather operand ever exceeds L + 2W <= GATHER_ROW_CAP.

Layout is width-major (w, n_pad) like ``sparse/ell.py``.
Column indices are stored RELATIVE to the owning segment's window start,
so the apply needs no index arithmetic.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Keep every window comfortably under the inherited gather limit (not
# measured on the GPU).  Two hazards bounded the segment size there: the
# gather OPERAND (the window itself) and the per-gather INDEX COUNT
# (width * L) — plain ELL failed at >= ~2M rows = ~14M indices, so segments
# stay far below both (600k-row windows put a 7-wide matrix at ~4M indices
# per gather).
WINDOW_CAP = 600_000


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rel_cols", "vals", "diag"],
    meta_fields=["shape", "seg_rows", "half_bw"],
)
@dataclasses.dataclass
class BandedELL:
    """Bounded-bandwidth padded-ELL with segment-local gathers.

    ``rel_cols[k, i]`` = column of the k-th stored entry of row i, relative
    to row i's segment window start (``seg(i)*L - W``); padded slots carry
    ``rel = 0, val = 0``.  ``diag`` is the assembled diagonal (smoother
    fuel — extracting it from the relative layout would be a gather).
    """

    rel_cols: jax.Array      # (w, n_pad) int32
    vals: jax.Array          # (w, n_pad)
    diag: jax.Array          # (n,)
    shape: tuple[int, int]
    seg_rows: int            # L
    half_bw: int             # W

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def width(self) -> int:
        return int(self.rel_cols.shape[0])

    @property
    def n_segments(self) -> int:
        return int(self.vals.shape[1]) // self.seg_rows

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_csr(
        cls, csr, dtype=None, window_cap: int = WINDOW_CAP
    ) -> "BandedELL":
        """Build from a HostCSR/scipy CSR.  Raises ValueError when the
        bandwidth is too large for safe windows (reorder first —
        ``sparse/reorder.rcm_permutation``)."""
        from tpusparse.sparse.csr import HostCSR

        if not isinstance(csr, HostCSR):
            csr = HostCSR.from_scipy(csr)
        n, m = csr.shape
        if n != m:
            raise ValueError(f"BandedELL needs a square matrix, got {csr.shape}")
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr))
        cols = csr.indices.astype(np.int64)
        w_bw = int(np.abs(cols - rows).max()) if csr.nnz else 0
        # L + 2W <= window_cap with L >= 2W keeps the window majority-payload
        if 4 * w_bw > window_cap:
            raise ValueError(
                f"bandwidth {w_bw} needs windows > {window_cap} rows — the"
                " gather-operand crash region; RCM-reorder the matrix first"
                " (sparse/reorder.py) or raise window_cap at your own risk"
            )
        seg = min(int(n), window_cap - 2 * w_bw)
        n_seg = -(-int(n) // seg)
        n_pad = n_seg * seg
        width = int(csr.max_row_nnz)
        dt = np.dtype(dtype or csr.data.dtype)
        vals = np.zeros((width, n_pad), dt)
        rel = np.zeros((width, n_pad), np.int32)
        slot = np.zeros(n, np.int64)
        k = np.concatenate([np.arange(c) for c in np.diff(csr.indptr)]) \
            if csr.nnz else np.zeros(0, np.int64)
        del slot
        win_start = (rows // seg) * seg - w_bw
        vals[k, rows] = csr.data.astype(dt)
        rel[k, rows] = (cols - win_start).astype(np.int32)
        return cls(
            rel_cols=jnp.asarray(rel),
            vals=jnp.asarray(vals),
            diag=jnp.asarray(csr.diagonal().astype(dt)),
            shape=(int(n), int(m)),
            seg_rows=seg,
            half_bw=w_bw,
        )

    # --- apply ---------------------------------------------------------------
    def mv(self, x: jax.Array) -> jax.Array:
        """y = A @ x.  S statically-unrolled segment passes; every gather
        reads only its (L + 2W)-row window."""
        n = self.n_rows
        L, W = self.seg_rows, self.half_bw
        n_pad = self.vals.shape[1]
        x_ext = jnp.pad(x, (W, W + n_pad - n))
        ys = []
        for s in range(self.n_segments):
            win = jax.lax.slice_in_dim(x_ext, s * L, s * L + L + 2 * W)
            v = jax.lax.slice_in_dim(self.vals, s * L, (s + 1) * L, axis=1)
            rc = jax.lax.slice_in_dim(
                self.rel_cols, s * L, (s + 1) * L, axis=1
            )
            ys.append(jnp.sum(v * win[rc], axis=0))
        y = ys[0] if len(ys) == 1 else jnp.concatenate(ys)
        return y[:n]

    def diagonal(self) -> jax.Array:
        return self.diag

    def to_scipy(self):
        import scipy.sparse as sp

        rel = np.asarray(self.rel_cols)
        vals = np.asarray(self.vals)
        w, n_pad = vals.shape
        L, W = self.seg_rows, self.half_bw
        rows = np.tile(np.arange(n_pad, dtype=np.int64), (w, 1))
        cols = rel.astype(np.int64) + (rows // L) * L - W
        keep = vals != 0
        a = sp.csr_matrix(
            (vals[keep], (rows[keep], cols[keep])), shape=self.shape
        )
        a.sum_duplicates()
        a.sort_indices()
        return a

    def __matmul__(self, x):
        return self.mv(x)
