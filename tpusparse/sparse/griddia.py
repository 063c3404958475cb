"""Grid-view banded matrix — DIA with 3-D shift semantics.

``DIA.mv`` applies bands as 1-D shifts of the FLAT vector (on the
accelerator this was first built for, each shift cost a relayout; an
inherited measurement, not repeated on the GPU).  When the operator lives
on a known 3-D grid (the geometric aij path, ``amg/geo.py``), the same
product is

    y3 = sum_k  B_k3 * shift3(x3, d3_k)

over (nz, ny, nx) FIELD views — exactly the formulation the structured
stencil path uses (``sparse/stencil.py``), which XLA fuses into one
HBM-bandwidth loop, except the coefficients are per-row FIELDS instead of
broadcast scalars (no constant-coefficient assumption: this is still the
general banded container).

Safety: flat-shift and 3-D-shift semantics differ at grid edges (a flat
offset +1 at x = nx-1 wraps into the next row).  They coincide exactly
when every band is zero at its wrap positions — true by construction for
operators whose couplings are grid-neighbor couplings, and VALIDATED
band-by-band in ``from_dia`` (one host pass); inputs that fail keep the
flat form.

KNOWN ISSUE (2026-08-17, jax 0.9.0 CPU): a SMALL GridDIA (observed at
grid (8,8,8), 27 bands) used as a coarse AMG level inside a jitted CG
while_loop makes the whole solve stall, even though its mv in isolation
— and every V-cycle intermediate — matches the flat form bit-for-bit;
flattening that one level to DIA fixes it.  Composition-level XLA
miscompile class.  Production policy: the 3-D view is used ONLY for
LARGE (fine-level) operators, where its bandwidth win lives anyway.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def shift3(x3: jax.Array, d3) -> jax.Array:
    """out[p] = x3[p + d3] with zeros shifted in (lax.pad slices)."""
    pads = [(-d, d, 0) for d in d3]
    if all(p == (0, 0, 0) for p in pads):
        return x3
    return lax.pad(x3, jnp.zeros((), x3.dtype), pads)


def _decompose(o: int, shape) -> tuple[int, int, int] | None:
    """Flat offset -> (dz, dy, dx) on ``shape``, or None if out of range."""
    nz, ny, nx = shape
    q = ny * nx
    dz = round(o / q) if nz > 1 else 0
    rem = o - dz * q
    dy = round(rem / nx) if ny > 1 else 0
    dx = rem - dy * nx
    if abs(dz) >= nz or abs(dy) >= ny or abs(dx) >= nx:
        return None
    if dz * q + dy * nx + dx != o:
        return None
    return (dz, dy, dx)


def _wrap_ok(band: np.ndarray, d3, shape) -> bool:
    """True when the band is zero wherever the 3-D neighbor leaves the
    grid (= wherever flat and 3-D shift semantics differ)."""
    b3 = band.reshape(shape)
    dz, dy, dx = d3
    nz, ny, nx = shape

    def edge(b, d, ax, n):
        if d > 0:
            sl = [slice(None)] * 3
            sl[ax] = slice(n - d, n)
            return b[tuple(sl)]
        if d < 0:
            sl = [slice(None)] * 3
            sl[ax] = slice(0, -d)
            return b[tuple(sl)]
        return b[0:0]

    for ax, (d, n) in enumerate(((dz, nz), (dy, ny), (dx, nx))):
        e = edge(b3, d, ax, n)
        if e.size and np.any(e != 0):
            return False
    return True


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["bands"],
    meta_fields=["offsets", "d3s", "grid_shape"],
)
@dataclasses.dataclass
class GridDIA:
    """Banded matrix on a known (nz, ny, nx) grid; bands applied as 3-D
    field shifts.  Flat-vector interface (mv/diagonal take/return (n,))
    so it drops into the DIA-shaped hierarchy unchanged."""

    bands: jax.Array                   # (K, n)
    offsets: tuple[int, ...]           # flat offsets (sorted, DIA parity)
    d3s: tuple[tuple[int, int, int], ...]
    grid_shape: tuple[int, int, int]

    @classmethod
    def from_dia(cls, dia, grid_shape, validate: bool = True):
        """Wrap a DIA whose couplings are grid-neighbor couplings; returns
        None when an offset does not decompose or a band has nonzero wrap
        entries (caller keeps the flat DIA)."""
        shape = tuple(int(s) for s in grid_shape)
        if validate:
            # the one validation implementation (decompose + wrap-zero
            # check) lives in host_grid_view — review finding: keep a
            # single copy of the decomposition rules
            d3s = host_grid_view(
                np.asarray(jax.device_get(dia.bands)), dia.offsets, shape
            )
            if d3s is None:
                return None
        else:
            d3s = []
            for o in dia.offsets:
                d3 = _decompose(int(o), shape)
                if d3 is None:
                    return None
                d3s.append(d3)
            d3s = tuple(d3s)
        return cls(
            bands=dia.bands,
            offsets=tuple(int(o) for o in dia.offsets),
            d3s=d3s,
            grid_shape=shape,
        )

    def to_dia(self):
        from tpusparse.sparse.dia import DIA

        return DIA(
            bands=self.bands, offsets=self.offsets,
            shape=self.shape,
        )

    # --- DIA-compatible surface -----------------------------------------
    @property
    def shape(self):
        n = int(np.prod(self.grid_shape))
        return (n, n)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.bands.dtype

    def diagonal(self) -> jax.Array:
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return jnp.zeros(self.n_rows, self.dtype)

    def to_scipy(self):
        return self.to_dia().to_scipy()

    def mv(self, x: jax.Array) -> jax.Array:
        """y = A x via 3-D field shifts (flat in, flat out)."""
        shape = self.grid_shape
        x3 = x.reshape(shape)
        y3 = self.bands[0].reshape(shape) * shift3(x3, self.d3s[0])
        for k in range(1, len(self.d3s)):
            y3 = y3 + self.bands[k].reshape(shape) * shift3(
                x3, self.d3s[k]
            )
        return y3.reshape(-1)

    def __matmul__(self, x):
        return self.mv(x)


def host_grid_view(bands_host: np.ndarray, offsets, grid_shape):
    """Validate a host band array for the 3-D view: every offset must
    decompose on ``grid_shape`` and every band must be zero at its wrap
    positions.  Returns the d3 tuple, or None (keep the flat form)."""
    shape = tuple(int(s) for s in grid_shape)
    d3s = []
    for k, o in enumerate(offsets):
        d3 = _decompose(int(o), shape)
        if d3 is None or not _wrap_ok(bands_host[k], d3, shape):
            return None
        d3s.append(d3)
    return tuple(d3s)
