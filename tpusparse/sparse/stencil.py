"""7-point star-stencil operator on structured 3D grids — gather-free SpMV.

The reference forces the DMDA-assembled 7-point Laplacian into generic CSR
(``DMSetMatType(MATAIJ)``, ``src/helper.cpp:39``) because its whole point was
accelerating PETSc's CSR kernel.  This design keeps the structure the grid
already gives us: the matrix action is six shifted reads plus a
positionally-varying diagonal,

    y[k,j,i] = diag[k,j,i]*x[k,j,i]
             + cx*(x[k,j,i-1] + x[k,j,i+1])
             + cy*(x[k,j-1,i] + x[k,j+1,i])
             + cz*(x[k-1,j,i] + x[k+1,j,i])

with zero-fill outside the domain (exactly the reference's Neumann-via-dropped
-entries assembly, ``src/helper.cpp:229-233``).  Each shift is a single
``lax.pad`` (crop one plane, zero-pad the other), so the entire SpMV is
elementwise adds/multiplies that XLA fuses into one HBM-bandwidth-bound pass:
it reads x and diag and writes y — no column indices, no gathers.  For f64 at
300^3 that is ~3 arrays * 216 MB instead of the ELL form's ~4.3 GB, a ~7x
memory-traffic reduction on the hottest kernel in the solve.

Reference-point pinning (``MatZeroRowsColumns`` on row/col 0,
``src/helper.cpp:274``) is carried structurally: the pinned column is removed
by zeroing x[0,0,0] before the neighbor shifts, and the pinned row is fixed up
with a single element overwrite after.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def _shift(x: jax.Array, axis: int, direction: int) -> jax.Array:
    """out[..., i, ...] = x[..., i + direction, ...], zero-filled at the edge.

    Implemented as one lax.pad with a negative low/high pad (crop) on one side
    and a zero pad on the other — no concatenate, no copy chains.
    """
    cfg = [(0, 0, 0)] * x.ndim
    if direction == 1:
        cfg[axis] = (-1, 1, 0)   # drop first plane, zero-pad at the end
    elif direction == -1:
        cfg[axis] = (1, -1, 0)   # zero-pad at the start, drop last plane
    else:
        raise ValueError(f"direction must be +-1, got {direction}")
    return lax.pad(x, jnp.zeros((), x.dtype), cfg)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["diag", "cx", "cy", "cz"],
    meta_fields=["pinned"],
)
@dataclasses.dataclass
class StarStencil3D:
    """Symmetric 7-point star stencil with constant off-diagonal coefficients
    per axis and an arbitrary (nz, ny, nx) diagonal field.

    If ``pinned`` is true, row/column 0 (natural ordering) are zeroed except
    the diagonal — ``diag[0,0,0]`` holds the pinned diagonal value (the
    reference's ``scale``, ``src/helper.cpp:264-274``).
    """

    diag: jax.Array          # (nz, ny, nx)
    cx: jax.Array            # scalar
    cy: jax.Array            # scalar
    cz: jax.Array            # scalar
    pinned: bool

    @property
    def shape(self) -> tuple[int, int]:
        n = self.diag.size
        return (n, n)

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return self.diag.shape

    @property
    def dtype(self):
        return self.diag.dtype

    def _origin_mask(self, shape) -> jax.Array:
        """Boolean (nz, ny, nx) mask of the pinned cell, built from iotas so
        XLA fuses it into the elementwise pipeline — a dynamic-update-slice
        here would materialize a full array copy per apply."""
        k = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        i = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
        return (k == 0) & (j == 0) & (i == 0)

    def mv(self, x: jax.Array) -> jax.Array:
        """y = A @ x on the 3D field view (nz, ny, nx)."""
        if x.shape != self.diag.shape:
            raise ValueError(f"x shape {x.shape} != grid {self.diag.shape}")
        if self.pinned:
            origin = self._origin_mask(x.shape)
            xn = jnp.where(origin, jnp.zeros((), x.dtype), x)
        else:
            xn = x
        y = self.diag * x
        y += self.cx * (_shift(xn, 2, 1) + _shift(xn, 2, -1))
        y += self.cy * (_shift(xn, 1, 1) + _shift(xn, 1, -1))
        y += self.cz * (_shift(xn, 0, 1) + _shift(xn, 0, -1))
        if self.pinned:
            # pinned row: y[0] = diag[0] * x[0] only
            y = jnp.where(origin, self.diag * x, y)
        return y

    def mv_flat(self, x: jax.Array) -> jax.Array:
        """y = A @ x on the 1D natural-ordering vector view."""
        return self.mv(x.reshape(self.diag.shape)).reshape(-1)

    def to_df(self) -> "StarStencilDF":
        """Two-float twin of this (f64) operator: high-precision applies on
        the f32 datapath (see utils/twofloat.py)."""
        from tpusparse.utils.twofloat import DF64

        return StarStencilDF(
            diag=DF64.from_f64(self.diag),
            cx=DF64.from_f64(self.cx),
            cy=DF64.from_f64(self.cy),
            cz=DF64.from_f64(self.cz),
            pinned=self.pinned,
        )

    def diagonal(self) -> jax.Array:
        return self.diag.reshape(-1)

    def diagonal_field(self) -> jax.Array:
        return self.diag

    def gs_color_masks(self) -> list:
        """Checkerboard (red-black) coloring: the star stencil couples
        only opposite (i+j+k) parities, so all same-color points are
        mutually independent — a masked simultaneous update over one
        color IS a Gauss-Seidel ordering (multicolor SOR, the standard
        parallel-machine formulation of PETSc's PCSOR)."""
        shape = self.diag.shape
        k = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        i = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
        p = (k + j + i) % 2
        return [p == 0, p == 1]

    def flat_band_fields(self, max_abs_offset: int) -> dict:
        """{flat offset o: field f with f[p] = A[p, p+o]} for every stencil
        leg with 0 < |o| < ``max_abs_offset`` (natural ordering, p = flat
        index of (k, j, i)).  Domain-edge drops and the pinned row/column
        are masked in, so the fields ARE the matrix bands — the structured
        block-Jacobi builder (``solve/bjacobi.py::BlockJacobi.from_bands``)
        consumes them to assemble exact bs x bs diagonal blocks.
        """
        shape = self.diag.shape
        nz, ny, nx = shape
        dt = self.diag.dtype
        k = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        i = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
        zero = jnp.zeros((), dt)
        legs = [
            (1, jnp.asarray(self.cx, dt), i < nx - 1),
            (-1, jnp.asarray(self.cx, dt), i > 0),
            (nx, jnp.asarray(self.cy, dt), j < ny - 1),
            (-nx, jnp.asarray(self.cy, dt), j > 0),
            (nx * ny, jnp.asarray(self.cz, dt), k < nz - 1),
            (-nx * ny, jnp.asarray(self.cz, dt), k > 0),
        ]
        flat = (k * ny + j) * nx + i  # natural-ordering row index
        out = {}
        for o, c, valid in legs:
            if abs(o) >= max_abs_offset:
                continue
            f = jnp.where(valid, c, zero)
            if self.pinned:
                # MatZeroRowsColumns on row/col 0: A[0, o] = A[o, 0] = 0
                f = jnp.where((flat == 0) | (flat + o == 0), zero, f)
            out[o] = f
        return out

    def __matmul__(self, x):
        return self.mv(x) if x.ndim == 3 else self.mv_flat(x)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["diag", "cx", "cy", "cz"],
    meta_fields=["pinned"],
)
@dataclasses.dataclass
class StarStencilDF:
    """Two-float (double-single) twin of StarStencil3D: y = A x carried out
    entirely in paired-f32 arithmetic (~1.4e-14 relative precision) on the
    f32 datapath — the high-precision apply for devices whose f64 is
    emulated.  Fields are DF64 pytrees (utils/twofloat.py); shifts act on
    both components (exact), products/sums use error-free transformations.
    """

    diag: object   # DF64 field (nz, ny, nx)
    cx: object     # DF64 scalar
    cy: object     # DF64 scalar
    cz: object     # DF64 scalar
    pinned: bool

    def mv(self, x):
        """y = A @ x with DF64 in/out on the 3D field view."""
        from tpusparse.utils.twofloat import DF64, df_add, df_mul

        if self.pinned:
            k = jax.lax.broadcasted_iota(jnp.int32, x.hi.shape, 0)
            j = jax.lax.broadcasted_iota(jnp.int32, x.hi.shape, 1)
            i = jax.lax.broadcasted_iota(jnp.int32, x.hi.shape, 2)
            origin = (k == 0) & (j == 0) & (i == 0)
            zero = jnp.zeros((), x.hi.dtype)
            xn = DF64(
                hi=jnp.where(origin, zero, x.hi),
                lo=jnp.where(origin, zero, x.lo),
            )
        else:
            xn = x

        def sh(v, axis, direction):
            return DF64(
                hi=_shift(v.hi, axis, direction),
                lo=_shift(v.lo, axis, direction),
            )

        y = df_mul(self.diag, x)
        y = df_add(y, df_mul(self.cx, df_add(sh(xn, 2, 1), sh(xn, 2, -1))))
        y = df_add(y, df_mul(self.cy, df_add(sh(xn, 1, 1), sh(xn, 1, -1))))
        y = df_add(y, df_mul(self.cz, df_add(sh(xn, 0, 1), sh(xn, 0, -1))))
        if self.pinned:
            d = df_mul(self.diag, x)
            y = DF64(
                hi=jnp.where(origin, d.hi, y.hi),
                lo=jnp.where(origin, d.lo, y.lo),
            )
        return y
