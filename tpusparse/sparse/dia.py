"""Device-resident DIA (diagonal/banded) sparse matrix — the gather-free
general-matrix path.

Why it exists: it was built for an accelerator whose runtime failed when
gather-based SpMV (ELL/COO/BSR ``x[cols]``) ran inside solver loops at
>= ~2M rows (an inherited limit, not measured on the GPU).  A DIA matrix
stores one value array per *occupied diagonal* and applies

    y = sum_k  bands[k] * shift(x, offsets[k])

where every shift is a static ``lax.pad`` slice — **no gather anywhere** —
at stencil-like bandwidth: XLA fuses the K shifted reads into one pass
over x and the bands (on an H100, the 7-band float32 apply at 300^3 runs
at the rate of a plain copy; PERF.md).  Matrices that arise from meshes
(the reference's entire problem class: DMDA grids, the reference's
``src/helper.cpp:161-246``, and their Galerkin coarse operators under
lexicographic aggregate numbering) occupy few distinct diagonals, so the
format is dense-free: the 7-point Poisson has 7 bands; its
smoothed-aggregation coarse operators ~27-challenge.

Storage: ``bands`` is (K, n); entry (k, r) = A[r, r + offsets[k]].  Rows
whose diagonal leaves the matrix hold zeros.  ``from_csr`` refuses matrices
occupying more than ``max_offsets`` diagonals (storage is K*n — a general
dense-ish matrix would explode); callers fall back to ELL.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _shift(x: jax.Array, o: int, n: int | None = None) -> jax.Array:
    """y[r] = x[r + o] for r in [0, n) (zeros shifted in), along axis 0.
    ``n`` defaults to len(x) (square frame)."""
    m = x.shape[0]
    n = m if n is None else n
    if o == 0 and n == m:
        return x
    cfg = [(-o, n - m + o, 0)] + [(0, 0, 0)] * (x.ndim - 1)
    return lax.pad(x, jnp.zeros((), x.dtype), cfg)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["bands"],
    meta_fields=["offsets", "shape"],
)
@dataclasses.dataclass
class DIA:
    """Banded matrix: ``bands[k, r] = A[r, r + offsets[k]]``."""

    bands: jax.Array               # (K, n) float
    offsets: tuple[int, ...]       # static, sorted
    shape: tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def nnz(self):
        return jnp.sum(self.bands != 0).astype(jnp.int64)

    # --- construction --------------------------------------------------------
    @staticmethod
    def host_bands(csr, max_offsets: int = 192, dtype=None):
        """Host-side band extraction: (bands ndarray (K, n), offsets tuple,
        shape).  Raises ValueError above ``max_offsets`` diagonals."""
        from tpusparse.sparse.csr import HostCSR

        if not isinstance(csr, HostCSR):
            csr = HostCSR.from_scipy(csr)
        n, m = csr.shape
        rows = np.repeat(
            np.arange(n, dtype=np.int64), np.diff(csr.indptr)
        )
        off = csr.indices.astype(np.int64) - rows
        if off.size == 0:
            data = csr.data.astype(dtype) if dtype is not None else csr.data
            return (
                np.zeros((1, n), data.dtype), (0,), (n, m)
            )
        # distinct offsets + per-entry band index WITHOUT the O(nnz log nnz)
        # sort of np.unique: banded matrices have a small offset RANGE, so a
        # bincount + lookup table is one linear pass each (measured 3x
        # faster at 8M rows — this conversion sits in the aij driver's init
        # phase)
        omin, omax = int(off.min()), int(off.max())
        span = omax - omin + 1
        if span <= max(4 * off.size, 1 << 24):
            hist = np.bincount(off - omin, minlength=span)
            offsets = np.flatnonzero(hist) + omin
            if offsets.size > max_offsets:
                raise ValueError(
                    f"matrix occupies {offsets.size} diagonals"
                    f" > max_offsets={max_offsets}; use ELL"
                )
            lut = np.zeros(span, np.int32)
            lut[offsets - omin] = np.arange(offsets.size, dtype=np.int32)
            k = lut[off - omin]
        else:
            offsets = np.unique(off)
            if offsets.size > max_offsets:
                raise ValueError(
                    f"matrix occupies {offsets.size} diagonals"
                    f" > max_offsets={max_offsets}; use ELL"
                )
            k = np.searchsorted(offsets, off)
        data = csr.data.astype(dtype) if dtype is not None else csr.data
        bands = np.zeros((offsets.size, n), data.dtype)
        bands[k, rows] = data
        return bands, tuple(int(o) for o in offsets), (n, m)

    @classmethod
    def from_csr(
        cls, csr, max_offsets: int = 192, dtype=None, device=None
    ) -> "DIA":
        """Convert a HostCSR/scipy CSR.  Raises ValueError when the matrix
        occupies more than ``max_offsets`` diagonals (fall back to ELL)."""
        bands, offsets, shape = cls.host_bands(csr, max_offsets, dtype)
        return cls(
            bands=jax.device_put(bands, device=device),
            offsets=offsets,
            shape=shape,
        )

    def to_scipy(self):
        import scipy.sparse as sp

        bands = np.asarray(jax.device_get(self.bands))
        n, m = self.shape
        rows, cols, vals = [], [], []
        for k, o in enumerate(self.offsets):
            r = np.arange(max(0, -o), min(n, m - o))
            v = bands[k, r]
            keep = v != 0
            rows.append(r[keep])
            cols.append(r[keep] + o)
            vals.append(v[keep])
        a = sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=self.shape,
        )
        a.sum_duplicates()
        a.sort_indices()
        return a

    # --- operators ------------------------------------------------------------
    def mv(self, x: jax.Array) -> jax.Array:
        """y = A @ x: K fused multiply-adds over shifted views — no gather
        (MatMult_SeqAIJ capability, crash-free inside jitted solver loops)."""
        n = self.n_rows
        y = self.bands[0] * _shift(x, self.offsets[0], n)
        for k, o in enumerate(self.offsets[1:], start=1):
            y = y + self.bands[k] * _shift(x, o, n)
        return y

    def mm(self, x: jax.Array) -> jax.Array:
        """Y = A @ X for dense X of shape (n_cols, j)."""
        n = self.n_rows
        y = self.bands[0][:, None] * _shift(x, self.offsets[0], n)
        for k, o in enumerate(self.offsets[1:], start=1):
            y = y + self.bands[k][:, None] * _shift(x, o, n)
        return y

    def rmv(self, y: jax.Array) -> jax.Array:
        """x = A^T @ y: shift the products the other way (still gather-free)."""
        m = self.n_cols
        x = _shift(self.bands[0] * y, -self.offsets[0], m)
        for k, o in enumerate(self.offsets[1:], start=1):
            x = x + _shift(self.bands[k] * y, -o, m)
        return x

    def diagonal(self) -> jax.Array:
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return jnp.zeros(self.n_rows, self.dtype)

    def __matmul__(self, x):
        return self.mv(x)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["dia", "rem"],
    meta_fields=[],
)
@dataclasses.dataclass
class HybridDIA:
    """DIA for the heavy diagonals + a thin ELL gather remainder.

    Mesh-graph matrices that occupy too many DISTINCT diagonals for pure
    DIA (e.g. Galerkin coarse operators under greedy aggregation: a few
    dominant near-grid offsets plus a scatter of ragged-boundary entries)
    split naturally: the top-K diagonals carry the bulk of the nonzeros at
    shift speed, and the remainder's gather volume drops by ~10x.
    """

    dia: DIA
    rem: object | None  # ELL, or None when the bands cover everything

    @classmethod
    def from_csr(
        cls, csr, max_bands: int = 64, dtype=None, device=None
    ) -> "HybridDIA":
        """Keep the ``max_bands`` most-populated diagonals (always including
        the main diagonal) as DIA; the rest becomes a thin ELL."""
        import scipy.sparse as sp

        from tpusparse.sparse.csr import HostCSR
        from tpusparse.sparse.ell import ELL

        if not isinstance(csr, HostCSR):
            csr = HostCSR.from_scipy(csr)
        n, m = csr.shape
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr))
        off = csr.indices.astype(np.int64) - rows
        offsets, counts = np.unique(off, return_counts=True)
        if offsets.size > max_bands:
            order = np.argsort(counts)[::-1]
            keep = set(offsets[order[:max_bands]].tolist())
            keep.add(0)
        else:
            keep = set(offsets.tolist()) | {0}
        in_dia = np.isin(off, np.fromiter(keep, np.int64))

        def sub(mask):
            return sp.csr_matrix(
                (csr.data[mask], (rows[mask], csr.indices[mask])),
                shape=(n, m),
            )

        dia = DIA.from_csr(
            HostCSR.from_scipy(sub(in_dia)),
            max_offsets=max_bands + 1, dtype=dtype, device=device,
        )
        rem = None
        if (~in_dia).any():
            rem = ELL.from_csr(
                HostCSR.from_scipy(sub(~in_dia)), dtype=dtype, device=device
            )
        return cls(dia=dia, rem=rem)

    @property
    def shape(self):
        return self.dia.shape

    @property
    def n_rows(self) -> int:
        return self.dia.n_rows

    @property
    def n_cols(self) -> int:
        return self.dia.n_cols

    @property
    def dtype(self):
        return self.dia.dtype

    @property
    def nnz(self):
        return self.dia.nnz + (self.rem.nnz if self.rem is not None else 0)

    def mv(self, x: jax.Array) -> jax.Array:
        y = self.dia.mv(x)
        if self.rem is not None:
            # the remainder GATHERS (x[cols]) — callers building hierarchies
            # must keep n_rows below GATHER_ROW_CAP (see auto_container)
            y = y + self.rem.mv(x)
        return y

    def diagonal(self) -> jax.Array:
        return self.dia.diagonal()  # main diagonal always lives in the bands

    def to_scipy(self):
        a = self.dia.to_scipy()
        if self.rem is not None:
            a = (a + self.rem.to_csr().to_scipy()).tocsr()
        return a

    def __matmul__(self, x):
        return self.mv(x)


# Inherited limit, not measured on the GPU: on the accelerator this was first
# built for, gather-based mv (ELL/COO/BSR ``x[cols]``) inside jitted solver
# loops crashed the runtime at >= ~2M rows (2.1M fine, 27M failed).  Operators
# that keep an ELL gather remainder stay below this cap until a GPU measurement
# says whether it is still needed.
GATHER_ROW_CAP = 1_500_000


def auto_container(
    csr,
    max_bands: int = 64,
    dtype=None,
    device=None,
    gather_row_cap: int = GATHER_ROW_CAP,
    dia_budget_bytes: int = 4 << 30,
):
    """Pick the safest fast container for a mesh-graph CSR level operator.

    Small-enough-to-gather levels get the usual treatment: pure DIA when the
    bands cover everything, else HybridDIA (heavy diagonals as bands + thin
    ELL gather remainder).  Levels ABOVE ``gather_row_cap`` rows must not
    gather at all (see GATHER_ROW_CAP) — so the bands are widened until they
    cover every occupied diagonal (DIA-only fallback).  If that widened DIA
    would exceed ``dia_budget_bytes`` of band storage, raise instead of
    risking a device-memory blowout; the caller must coarsen harder or
    shrink the level.
    """
    import numpy as np_

    from tpusparse.sparse.csr import HostCSR

    if not isinstance(csr, HostCSR):
        csr = HostCSR.from_scipy(csr)
    n = csr.shape[0]
    rows = np_.repeat(np_.arange(n, dtype=np_.int64), np_.diff(csr.indptr))
    k_distinct = np_.unique(csr.indices.astype(np_.int64) - rows).size

    if k_distinct <= max_bands or n <= gather_row_cap:
        hyb = HybridDIA.from_csr(
            csr, max_bands=max_bands, dtype=dtype, device=device
        )
        return hyb.dia if hyb.rem is None else hyb

    itemsize = np_.dtype(dtype or csr.data.dtype).itemsize
    need = k_distinct * n * itemsize
    if need > dia_budget_bytes:
        # widened-DIA storage infeasible: fall back to the segmented
        # banded-ELL executor — window-local gathers only (each operand
        # <= its segment window, far below the crash cap), O(nnz) storage,
        # any row count.  Needs bounded bandwidth; callers with scattered
        # patterns reorder first (sparse/reorder.py, ksp mat_reorder).
        from tpusparse.sparse.bandell import BandedELL

        try:
            return BandedELL.from_csr(csr, dtype=dtype)
        except ValueError as e:
            raise ValueError(
                f"level operator has {n} rows (> gather cap"
                f" {gather_row_cap}) over {k_distinct} diagonals; widened"
                f" DIA would need {need / 2**30:.1f} GiB > budget"
                f" {dia_budget_bytes / 2**30:.1f} GiB and the segmented"
                f" executor refused: {e}"
            ) from e
    return DIA.from_csr(
        csr, max_offsets=k_distinct, dtype=dtype, device=device
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["hi", "lo"],
    meta_fields=["offsets", "shape", "grid"],
)
@dataclasses.dataclass
class DFDIA:
    """Two-float (hi+lo f32) banded matrix applying in a higher dtype.

    The defect-correction outer operator must be high-precision, but
    storing/uploading f64 bands costs 8 B/entry of HBM traffic AND host->
    device transfer (1.5 GB at 300^3).  ``hi`` carries ``float32(A)``; ``lo``
    carries the f32 residual ``A - hi`` (None when A is EXACTLY
    f32-representable — true for many assembled operators, e.g. the reference
    Poisson matrix whose entries are +-h^-2 multiples).  ``mv`` promotes
    per-band to the vector dtype, so hi+lo recovers ~48 mantissa bits (rel
    ~4e-15) at 4 B/entry of traffic.

    ``hi`` may ALIAS the f32 hierarchy's fine-level bands — then the
    high-precision operator costs zero extra upload.
    """

    hi: jax.Array               # (K, n) f32
    lo: jax.Array | None        # (K, n) f32 residual, or None
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    # optional 3-D view: (grid_shape, d3s) — bands applied as field
    # shifts (sparse/griddia.py semantics; requires validated wrap-zeros)
    grid: tuple | None = None

    @classmethod
    def from_host_bands(
        cls, bands64: "np.ndarray", offsets, shape, hi_dev=None,
        grid: tuple | None = None,
    ) -> "DFDIA":
        """Split host f64 bands; upload lo only when nonzero.  ``hi_dev``:
        an already-uploaded f32 band array to alias (must equal
        float32(bands64) — asserted cheaply by dtype/shape)."""
        hi_np = bands64.astype(np.float32)
        lo_np = (bands64 - hi_np.astype(np.float64)).astype(np.float32)
        if hi_dev is None:
            hi_dev = jax.device_put(hi_np)
        else:
            # the alias MUST be float32(bands64): lo was computed against
            # the host bands, so a stale/mismatched device array would
            # silently build hi + lo != A (mv of the wrong operator).
            # Shape/dtype always checked; a sampled value check (first and
            # last band entries) catches stale data without a full fetch.
            if (
                tuple(hi_dev.shape) != tuple(hi_np.shape)
                or hi_dev.dtype != jnp.float32
            ):
                raise ValueError(
                    f"hi_dev alias mismatch: {hi_dev.shape}/{hi_dev.dtype}"
                    f" vs float32(bands64) {hi_np.shape}/float32"
                )
            if hi_np.size and not (
                float(hi_dev.reshape(-1)[0]) == float(hi_np.reshape(-1)[0])
                and float(hi_dev.reshape(-1)[-1])
                == float(hi_np.reshape(-1)[-1])
            ):
                raise ValueError(
                    "hi_dev alias mismatch: sampled entries differ from"
                    " float32(bands64) — stale or wrong upload"
                )
        exact = not np.any(lo_np)
        return cls(
            hi=hi_dev,
            lo=None if exact else jax.device_put(lo_np),
            offsets=tuple(int(o) for o in offsets),
            shape=tuple(shape),
            grid=grid,
        )

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return jnp.float64  # the dtype mv EFFECTIVELY applies in

    def mv(self, x: jax.Array) -> jax.Array:
        """y = A x in x's dtype (promote bands per-term on the fly)."""
        dt = x.dtype
        if self.grid is not None:
            from tpusparse.sparse.griddia import shift3

            gshape, d3s = self.grid
            x3 = x.reshape(gshape)
            y3 = self.hi[0].astype(dt).reshape(gshape) * shift3(x3, d3s[0])
            for k in range(1, len(d3s)):
                y3 = y3 + self.hi[k].astype(dt).reshape(gshape) * shift3(
                    x3, d3s[k]
                )
            if self.lo is not None:
                for k in range(len(d3s)):
                    y3 = y3 + self.lo[k].astype(dt).reshape(gshape) * (
                        shift3(x3, d3s[k])
                    )
            return y3.reshape(-1)
        n = self.n_rows
        y = self.hi[0].astype(dt) * _shift(x, self.offsets[0], n)
        for k, o in enumerate(self.offsets[1:], start=1):
            y = y + self.hi[k].astype(dt) * _shift(x, o, n)
        if self.lo is not None:
            for k, o in enumerate(self.offsets):
                y = y + self.lo[k].astype(dt) * _shift(x, o, n)
        return y

    def diagonal(self) -> jax.Array:
        if 0 not in self.offsets:
            return jnp.zeros(self.n_rows, jnp.float64)
        k = self.offsets.index(0)
        d = self.hi[k].astype(jnp.float64)
        if self.lo is not None:
            d = d + self.lo[k].astype(jnp.float64)
        return d

    def __matmul__(self, x):
        return self.mv(x)
