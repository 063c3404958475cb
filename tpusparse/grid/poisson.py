"""Manufactured 3D Poisson problem — parity with the reference's helper.cpp.

Problem (reference ``src/main_ksp.cpp:1-20``, ``src/helper.cpp:14-18``):

    lap u = -12 pi^2 cos(2 pi x) cos(2 pi y) cos(2 pi z)   on [0,1]^3
    exact u = cos(2 pi x) cos(2 pi y) cos(2 pi z)

discretized with a cell-centered 7-point finite-difference star on an
Nx x Ny x Nz grid, all-Neumann boundaries realized by *dropping* out-of-domain
stencil entries and absorbing them into the diagonal
(``src/helper.cpp:229-233``), and the resulting singular system pinned at
cell 0 via a MatZeroRowsColumns-equivalent (``src/helper.cpp:250-279``).

Note the assembled operator is symmetric *negative* definite (diag < 0,
off-diag > 0), exactly as the reference assembles it; the CG solver handles
the sign symmetrically.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from tpusparse.grid.grid3d import Grid3D
from tpusparse.sparse.csr import HostCSR

# constants from reference src/helper.cpp:17-18
C1 = 2.0 * np.pi
C2 = -3.0 * C1 * C1


def exact_field(grid: Grid3D, dtype=np.float64) -> np.ndarray:
    """u(x,y,z) = cos(2 pi x) cos(2 pi y) cos(2 pi z) at cell centers.

    Parity: ``generateExt`` (src/helper.cpp:120-157). Shape (nz, ny, nx).
    """
    cx = np.cos(C1 * grid.cell_centers("x", dtype)).astype(dtype)
    cy = np.cos(C1 * grid.cell_centers("y", dtype)).astype(dtype)
    cz = np.cos(C1 * grid.cell_centers("z", dtype)).astype(dtype)
    # one broadcast product pass (an .astype here would copy 216 MB again)
    return cz[:, None, None] * cy[None, :, None] * cx[None, None, :]


def rhs_field(grid: Grid3D, dtype=np.float64) -> np.ndarray:
    """f = -12 pi^2 * exact. Parity: ``generateRHS`` (src/helper.cpp:78-116)."""
    return dtype(C2) * exact_field(grid, dtype)


def _neighbor_masks_and_coeffs(grid: Grid3D, dtype):
    """Validity masks and coefficients for the 6 neighbors, in ascending
    column-offset order: k-1, j-1, i-1, i+1, j+1, k+1 (matches the sorted
    column order PETSc stores after assembly)."""
    nz, ny, nx = grid.shape
    ax = dtype(1.0 / (grid.dx * grid.dx))
    ay = dtype(1.0 / (grid.dy * grid.dy))
    az = dtype(1.0 / (grid.dz * grid.dz))

    # broadcastable index vectors — meshgrid would COPY three full fields
    K = np.arange(nz)[:, None, None]
    J = np.arange(ny)[None, :, None]
    I = np.arange(nx)[None, None, :]
    ones = np.ones((nz, ny, nx), bool)
    bc = lambda m: m & ones  # materialize (nz,ny,nx) in one pass
    # (name, valid mask (nz,ny,nx), flat col offset, coefficient)
    return [
        ("k-1", bc(K > 0), -ny * nx, az),
        ("j-1", bc(J > 0), -nx, ay),
        ("i-1", bc(I > 0), -1, ax),
        ("i+1", bc(I < nx - 1), +1, ax),
        ("j+1", bc(J < ny - 1), +nx, ay),
        ("k+1", bc(K < nz - 1), +ny * nx, az),
    ]


def assemble_poisson(
    grid: Grid3D, pin: bool = True, dtype=np.float64
):
    """Assemble the 7-point Neumann Laplacian + RHS + exact solution.

    Returns ``(A: HostCSR, b: (n,) ndarray, exact: (n,) ndarray)``, with the
    reference-point pin applied to both A and b when ``pin`` (the default, as
    the reference always pins: ``createSystem``, src/helper.cpp:54).

    Parity: ``generateA`` (src/helper.cpp:161-246) + ``setRefPoint``
    (src/helper.cpp:250-279).
    """
    n = grid.n
    nbrs = _neighbor_masks_and_coeffs(grid, dtype)

    # per-row entries in sorted column order: 3 lower nbrs, diag, 3 upper
    # nbrs.  Built in few whole-array passes (columnwise strided writes +
    # per-slot np.where temps measured ~2x the assembly time at 300^3).
    w = 7
    slots = [0, 1, 2, 4, 5, 6]  # slot 3 = diagonal
    offs = np.zeros(w, np.int64)
    coefs = np.zeros(w, dtype)
    mask = np.empty((n, w), dtype=bool)
    mask[:, 3] = True
    for (name, valid, off, coef), s in zip(nbrs, slots):
        mask[:, s] = valid.reshape(-1)
        offs[s] = off
        coefs[s] = coef
    idx_dtype = np.int32 if n < 2 ** 31 - 1 else np.int64
    rows = np.arange(n, dtype=idx_dtype)
    cols = rows[:, None] + offs.astype(idx_dtype)[None, :]
    vals = np.where(mask, coefs[None, :], dtype(0))
    # all-Neumann: diagonal = -(sum of coefficients of *existing* nbrs);
    # coefs[3] is 0 so summing the whole row is the neighbor sum
    diag = -vals.sum(axis=1)
    vals[:, 3] = diag

    exact = exact_field(grid, dtype).reshape(-1)
    b = rhs_field(grid, dtype).reshape(-1)

    scale = dtype(diag.sum() / n)  # mean of diagonal (src/helper.cpp:264-272)
    if pin:
        # MatZeroRowsColumns(A, {0}, scale, x=exact, b=rhs) semantics
        # (src/helper.cpp:274):
        #   b[i] -= A[i,0] * exact[0]  for i != 0 with a column entry at 0
        #   b[0]  = scale * exact[0]
        #   row 0 and column 0 zeroed; A[0,0] = scale
        # Only rows r with r + offs[s] == 0 can hold a column-0 entry — a
        # HANDFUL of direct updates, not a full (n, 7) scan (the scan
        # measured ~13 s at 300^3 on this host).
        for s in range(w):
            r = -int(offs[s])
            if 0 <= r < n and s != 3 and mask[r, s]:
                b[r] -= vals[r, s] * exact[0]
                mask[r, s] = False
                vals[r, s] = dtype(0)
        mask[0, :] = False
        vals[0, :] = dtype(0)
        # restore pinned diagonal
        cols[0, 3] = 0
        vals[0, 3] = scale
        mask[0, 3] = True
        b[0] = scale * exact[0]

    row_nnz = mask.sum(axis=1).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_nnz, out=indptr[1:])
    # one flat index set reused for both compressions (boolean fancy
    # indexing on the f64 array measured 2-3x slower than take-by-index)
    flat = np.flatnonzero(mask.ravel())
    a = HostCSR(
        indptr=indptr,
        indices=np.ascontiguousarray(
            cols.ravel()[flat], dtype=np.int32
        ),
        data=vals.ravel()[flat],
        shape=(n, n),
    )
    return a, b, exact


def poisson_stencil_device(grid: Grid3D, pin: bool = True, dtype=np.float64):
    """Device-side twin of ``poisson_stencil``: every field is computed with
    jnp ops ON the accelerator — no host assembly, no host→device transfer.

    Why it exists: at 300^3 the host path materializes ~650 MB of f64 fields
    in numpy and copies them to the device, which would dominate the
    driver's ``init`` phase; this path compiles a tiny program instead.
    Values agree with the host path to 1-2 ulp (libm vs XLA cos).
    """
    import jax
    import jax.numpy as jnp

    from tpusparse.sparse.stencil import StarStencil3D

    dt = jnp.dtype(dtype)
    nz, ny, nx = grid.shape
    ax = 1.0 / (grid.dx * grid.dx)
    ay = 1.0 / (grid.dy * grid.dy)
    az = 1.0 / (grid.dz * grid.dz)

    @partial(jax.jit, static_argnames=())
    def build():
        cxs = jnp.cos(C1 * (jnp.arange(nx, dtype=dt) + 0.5) * grid.dx)
        cys = jnp.cos(C1 * (jnp.arange(ny, dtype=dt) + 0.5) * grid.dy)
        czs = jnp.cos(C1 * (jnp.arange(nz, dtype=dt) + 0.5) * grid.dz)
        exact = czs[:, None, None] * cys[None, :, None] * cxs[None, None, :]
        b = jnp.asarray(C2, dt) * exact

        k = jnp.arange(nz, dtype=jnp.int32)[:, None, None]
        j = jnp.arange(ny, dtype=jnp.int32)[None, :, None]
        i = jnp.arange(nx, dtype=jnp.int32)[None, None, :]
        # NB: bool + bool saturates (logical or) — cast each mask first
        diag = -(
            ax * ((i > 0).astype(dt) + (i < nx - 1).astype(dt))
            + ay * ((j > 0).astype(dt) + (j < ny - 1).astype(dt))
            + az * ((k > 0).astype(dt) + (k < nz - 1).astype(dt))
        )
        if pin:
            # mean of the diagonal, closed form (each interior face pair
            # contributes -coef to two rows)
            sum_diag = -2.0 * (
                ax * (nx - 1) * ny * nz
                + ay * (ny - 1) * nx * nz
                + az * (nz - 1) * nx * ny
            )
            scale = jnp.asarray(sum_diag / grid.n, dt)
            e0 = exact[0, 0, 0]
            if nx > 1:
                b = b.at[0, 0, 1].add(-jnp.asarray(ax, dt) * e0)
            if ny > 1:
                b = b.at[0, 1, 0].add(-jnp.asarray(ay, dt) * e0)
            if nz > 1:
                b = b.at[1, 0, 0].add(-jnp.asarray(az, dt) * e0)
            diag = diag.at[0, 0, 0].set(scale)
            b = b.at[0, 0, 0].set(scale * e0)
        return diag, b, exact

    diag, b, exact = build()
    op = StarStencil3D(
        diag=diag,
        cx=jnp.asarray(ax, dt),
        cy=jnp.asarray(ay, dt),
        cz=jnp.asarray(az, dt),
        pinned=bool(pin),
    )
    return op, b, exact


def poisson_stencil(grid: Grid3D, pin: bool = True, dtype=np.float64):
    """Build the same operator as a gather-free StarStencil3D plus (b, exact)
    as (nz, ny, nx) fields. Numerically identical to ``assemble_poisson``."""
    import jax.numpy as jnp

    from tpusparse.sparse.stencil import StarStencil3D

    nbrs = _neighbor_masks_and_coeffs(grid, dtype)
    diag = np.zeros(grid.shape, dtype=dtype)
    coefs = {}
    for name, valid, _off, coef in nbrs:
        diag -= np.where(valid, coef, dtype(0))
        coefs[name] = coef

    exact = exact_field(grid, dtype)
    b = rhs_field(grid, dtype).copy()
    scale = dtype(diag.sum() / grid.n)
    if pin:
        e0 = exact[0, 0, 0]
        # neighbors of cell 0 lose their column-0 entry; move it to the RHS
        if grid.nx > 1:
            b[0, 0, 1] -= coefs["i-1"] * e0
        if grid.ny > 1:
            b[0, 1, 0] -= coefs["j-1"] * e0
        if grid.nz > 1:
            b[1, 0, 0] -= coefs["k-1"] * e0
        diag[0, 0, 0] = scale
        b[0, 0, 0] = scale * e0

    op = StarStencil3D(
        diag=jnp.asarray(diag),
        cx=jnp.asarray(coefs["i-1"]),
        cy=jnp.asarray(coefs["j-1"]),
        cz=jnp.asarray(coefs["k-1"]),
        pinned=bool(pin),
    )
    return op, jnp.asarray(b), jnp.asarray(exact)

def poisson_dia_device(grid: Grid3D, pin: bool = True):
    """Device-side DIA assembly of the general-matrix (MATAIJ) system.

    The aij driver's init phase used to assemble a 27M-row HostCSR in numpy
    and convert it to bands — ~100 s of single-core host time at 300^3 on
    this class of host (the reference assembles on a full CPU socket,
    ``generateA`` src/helper.cpp:161-246).  The answer is the same one
    ``poisson_stencil_device`` gives the structured path: compute every
    O(n) array ON the accelerator.  This builds the 7-band DIA form
    directly as an EXACT two-float split:

      * the six neighbor bands take one value each (``1/h^2``) — split
        hi = float32(c), lo = float32(c - hi) on the host as scalars;
      * the diagonal takes at most 8 distinct values (one per
        interior/face combination per axis, ``-(ci*ax + cj*ay + ck*az)``
        with ci,cj,ck in {1,2}) — all 8 split host-side, selected on
        device by nested ``where`` over the boundary masks (no gather);
      * b / exact are f64 cos-product fields (the structured path's
        machinery).

    So ``hi == float32(A64)`` entrywise and ``hi + lo`` carries ~48
    mantissa bits — the DFDIA outer-operator contract — with zero host
    O(n) work and zero host->device band transfer.

    Returns ``(op_hi: DFDIA, op_lo: DIA, b, exact)`` with b/exact flat
    (n,) f64 device arrays.  Parity oracle: ``assemble_poisson`` (same
    matrix entrywise; tests/test_poisson_device_assembly.py).
    """
    import jax
    import jax.numpy as jnp

    from tpusparse.sparse.dia import DFDIA, DIA

    nz, ny, nx = grid.shape
    if min(nx, ny, nz) < 2:
        raise ValueError("poisson_dia_device requires nx,ny,nz >= 2")
    n = grid.n
    ax = 1.0 / (grid.dx * grid.dx)
    ay = 1.0 / (grid.dy * grid.dy)
    az = 1.0 / (grid.dz * grid.dz)

    def split(c: float):
        hi = np.float32(c)
        lo = np.float32(c - np.float64(hi))
        return float(hi), float(lo)

    # band order = ascending column offset (PETSc post-assembly order)
    offsets = (-ny * nx, -nx, -1, 0, 1, nx, ny * nx)
    coef64 = (az, ay, ax, 0.0, ax, ay, az)
    csplit = [split(c) for c in coef64]
    # 64 diagonal values, one per neighbor-presence pattern, each computed
    # with numpy's OWN 7-slot row summation (``-vals.sum(axis=1)`` in
    # assemble_poisson) so the f64 rounding — and therefore the hi/lo
    # split — is entrywise IDENTICAL to the host oracle for any
    # anisotropy.  Grouped per-axis arithmetic (2*ax + 2*ay + 2*az)
    # rounds differently in the last ulp, which the lo band would expose.
    dsplit = np.empty((2,) * 6 + (2,), np.float32)
    for bits in np.ndindex(*(2,) * 6):
        row = np.array(
            [az * bits[0], ay * bits[1], ax * bits[2], 0.0,
             ax * bits[3], ay * bits[4], az * bits[5]], np.float64,
        )
        dsplit[bits] = split(-row.sum())
    # pinned diagonal (mean of the unpinned diagonal, closed form)
    sum_diag = -2.0 * (
        ax * (nx - 1) * ny * nz
        + ay * (ny - 1) * nx * nz
        + az * (nz - 1) * nx * ny
    )
    scale = sum_diag / n
    scale_hi, scale_lo = split(scale)

    f32 = jnp.float32
    f64 = jnp.float64

    @jax.jit
    def build():
        k = jnp.arange(nz, dtype=jnp.int32)[:, None, None]
        j = jnp.arange(ny, dtype=jnp.int32)[None, :, None]
        i = jnp.arange(nx, dtype=jnp.int32)[None, None, :]
        zero = jnp.zeros((), f32)
        masks = [k > 0, j > 0, i > 0, None, i < nx - 1, j < ny - 1,
                 k < nz - 1]

        def band(s, part):
            m = masks[s]
            c = jnp.asarray(csplit[s][part], f32)
            return jnp.where(m, c, zero) + jnp.zeros((nz, ny, nx), f32)

        def diag(part):
            # 64-way select by nested where over the presence bits —
            # a 6-deep constant tree, no gather
            bits = [masks[s] for s in (0, 1, 2, 4, 5, 6)]

            def pick(table, depth):
                if depth == 6:
                    return jnp.asarray(float(table[part]), f32)
                return jnp.where(
                    bits[depth],
                    pick(table[1], depth + 1),
                    pick(table[0], depth + 1),
                )

            return pick(dsplit, 0) + jnp.zeros((nz, ny, nx), f32)

        his = [band(s, 0) if s != 3 else diag(0) for s in range(7)]
        los = [band(s, 1) if s != 3 else diag(1) for s in range(7)]

        cxs = jnp.cos(C1 * (jnp.arange(nx, dtype=f64) + 0.5) * grid.dx)
        cys = jnp.cos(C1 * (jnp.arange(ny, dtype=f64) + 0.5) * grid.dy)
        czs = jnp.cos(C1 * (jnp.arange(nz, dtype=f64) + 0.5) * grid.dz)
        exact = czs[:, None, None] * cys[None, :, None] * cxs[None, None, :]
        b = jnp.asarray(C2, f64) * exact
        exact = exact.reshape(-1)
        b = b.reshape(-1)

        his = [h.reshape(-1) for h in his]
        los = [l.reshape(-1) for l in los]
        if pin:
            e0 = exact[0]
            # column-0 entries live in the NEGATIVE-offset bands at rows
            # r = -offset (MatZeroRowsColumns semantics, helper.cpp:274):
            # move the coupling to the RHS, zero the entry
            for s, r, c in ((0, ny * nx, az), (1, nx, ay), (2, 1, ax)):
                b = b.at[r].add(-jnp.asarray(c, f64) * e0)
                his[s] = his[s].at[r].set(0.0)
                los[s] = los[s].at[r].set(0.0)
            # row 0: all neighbors dropped, diagonal = scale
            for s in range(7):
                if s != 3:
                    his[s] = his[s].at[0].set(0.0)
                    los[s] = los[s].at[0].set(0.0)
            his[3] = his[3].at[0].set(scale_hi)
            los[3] = los[3].at[0].set(scale_lo)
            b = b.at[0].set(jnp.asarray(scale, f64) * e0)
        return jnp.stack(his), jnp.stack(los), b, exact

    hi, lo, b, exact = build()
    lo_exact_zero = (
        all(c[1] == 0.0 for c in csplit)
        and not np.any(dsplit[..., 1])
        and (not pin or scale_lo == 0.0)
    )
    op_lo = DIA(bands=hi, offsets=offsets, shape=(n, n))
    op_hi = DFDIA(
        hi=hi,
        lo=None if lo_exact_zero else lo,
        offsets=offsets,
        shape=(n, n),
    )
    return op_hi, op_lo, b, exact
