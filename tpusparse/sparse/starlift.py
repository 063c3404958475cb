"""Structure detection: lift an assembled general (MATAIJ) matrix to the
structured executor when it IS a constant-coefficient 7-point star.

The reference benchmarks exactly one matrix class — the DMDA-assembled
7-point Poisson operator forced into generic CSR (``DMSetMatType(MATAIJ)``,
/root/reference/src/helper.cpp:39) so that PETSc's patched general-CSR
kernel gets exercised (src/openacc-step1/MatMult_SeqAIJ.patch:19-30).  A
structure-aware library should do what a structure-aware Mat implementation
does:
*prove* from the assembled coefficients that the matrix is a
constant-per-axis star stencil (+ arbitrary diagonal field + optional
MatZeroRowsColumns pin on row/col 0), and when the proof succeeds, run the
structured pipeline (StarStencil3D + the structured GAMG hierarchy) instead
of the generic banded executor.

The proof is EXACT (bitwise equality against the candidate constants): any
deviation — variable coefficients, asymmetric legs, nonzero entries at
domain-wrap positions that the stencil's zero-fill shifts would drop —
falls back to the general DIA path.  Detection is a handful of band-sized
reductions (one HBM pass over the operator data) and one scalar fetch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpusparse.sparse.dia import DFDIA, DIA
from tpusparse.sparse.stencil import StarStencil3D


def _axis_masks(shape):
    """Interior-validity masks per flat offset for a (gz, gy, gx) grid in
    natural ordering.

    Deliberately an INDEPENDENT encoding of the star-leg semantics (not a
    reuse of ``StarStencil3D.flat_band_fields``): the proof checks the
    assembled matrix against what the executor will DO, so sharing the
    executor's own mask code would make the proof circular.  Divergence
    between the two encodings is pinned by tests/test_starlift.py's
    bitwise lift-vs-``poisson_stencil`` equality.
    """
    gz, gy, gx = shape
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    return {
        1: i < gx - 1,
        -1: i > 0,
        gx: j < gy - 1,
        -gx: j > 0,
        gx * gy: k < gz - 1,
        -gx * gy: k > 0,
    }


@partial(jax.jit, static_argnums=(2, 3, 4))
def _check_bands(hi, lo, offsets, shape, promote):
    """Traceable core: given (K, n) bands, decide star-liftability.

    ``hi``/``lo``: the band array and its optional two-float residual
    (DFDIA inputs); ``promote`` promotes to f64 INSIDE the program so the
    exact value hi+lo is checked without materializing an f64 copy of the
    operator in HBM — XLA fuses the promotion into the reduction pass.

    Returns (ok, pinned, cx, cy, cz, diag_field) as traced values.  ``ok``
    requires, for each +-u leg pair of each axis: one shared constant on
    the structurally-valid mask (minus the pin positions when pinned) and
    exact zeros everywhere else in the band.
    """
    bands = hi.astype(jnp.float64) if promote else hi
    if lo is not None:
        bands = bands + lo.astype(bands.dtype)
    gz, gy, gx = shape
    n = gz * gy * gx
    masks = _axis_masks(shape)
    ki = {o: k for k, o in enumerate(offsets)}
    dt = bands.dtype
    zero = jnp.zeros((), dt)

    # pin pattern (MatZeroRowsColumns on row/col 0): A[0, o] == 0 for every
    # o > 0 leg and A[-o, 0] == 0 for every o < 0 leg
    pinned = jnp.bool_(True)
    for o in masks:
        if o not in ki:
            continue
        r = 0 if o > 0 else -o
        pinned = pinned & (bands[ki[o], r] == zero)

    ok = jnp.bool_(True)
    cs = []
    for u in (1, gx, gx * gy):
        c_axis = None
        for o in (u, -u):
            if o not in ki:
                # missing leg: acceptable only as an all-zero coefficient,
                # which the shared-constant check below can't express —
                # handled by the static guard in star_lift (offsets must
                # contain all six legs or the axis is degenerate)
                continue
            v = bands[ki[o]].reshape(shape)
            valid = masks[o]
            if o > 0:
                pin = (
                    jax.lax.broadcasted_iota(jnp.int32, shape, 0) == 0
                ) & (
                    jax.lax.broadcasted_iota(jnp.int32, shape, 1) == 0
                ) & (
                    jax.lax.broadcasted_iota(jnp.int32, shape, 2) == 0
                )
            else:
                # flat row -o = the +o neighbor of the origin
                flat = (
                    (jax.lax.broadcasted_iota(jnp.int32, shape, 0) * gy
                     + jax.lax.broadcasted_iota(jnp.int32, shape, 1)) * gx
                    + jax.lax.broadcasted_iota(jnp.int32, shape, 2)
                )
                pin = flat == -o
            use = valid & ~(pin & pinned)
            # candidate constant: the first used entry
            idx = jnp.argmax(use.reshape(-1))
            c = v.reshape(-1)[idx]
            ok = ok & jnp.all(jnp.where(use, v == c, v == zero))
            if c_axis is None:
                c_axis = c
            else:
                ok = ok & (c_axis == c)
        cs.append(c_axis if c_axis is not None else zero)
    diag = bands[ki[0]].reshape(shape)
    return ok, pinned, cs[0], cs[1], cs[2], diag


def star_lift(op_lo, op_hi, shape):
    """Try to lift general banded operators onto StarStencil3D.

    ``op_lo``: the f32 :class:`DIA` the hierarchy would be built on.
    ``op_hi``: the outer (high-precision) operator — a :class:`DFDIA`
    (mixed precision; its exact f64 value ``hi + lo`` is what gets
    verified and lifted) or a :class:`DIA` (uniform precision; may be
    ``op_lo`` itself).  ``shape``: the detected (gz, gy, gx) grid.

    Returns ``(star_hi, star_lo)`` — StarStencil3D twins sharing the
    verified structure (``star_hi`` is f64 for DFDIA inputs, else the
    input dtype) — or ``None`` when the matrix is not an exact
    constant-coefficient star.  Cost: one fused pass over the band data +
    one scalar fetch.
    """
    gz, gy, gx = shape
    offsets = tuple(op_lo.offsets)
    star_offs = {0, 1, -1, gx, -gx, gx * gy, -gx * gy}
    if min(gx, gy, gz) < 2:
        return None
    if 0 not in offsets or not set(offsets) <= star_offs:
        return None
    if set(offsets) != star_offs:
        # a missing leg means a zero axis coefficient — possible, but not
        # the benchmark class; keep the lift conservative
        return None
    if op_lo.shape[0] != gz * gy * gx:
        return None

    if isinstance(op_hi, DFDIA):
        if tuple(op_hi.offsets) != offsets:
            return None
        promote = jax.config.jax_enable_x64
        hi, lo = op_hi.hi, op_hi.lo
    elif isinstance(op_hi, DIA):
        if tuple(op_hi.offsets) != offsets:
            return None
        promote = False
        hi, lo = op_hi.bands, None
    else:
        return None

    ok, pinned, cx, cy, cz, diag_hi = _check_bands(
        hi, lo, offsets, (gz, gy, gx), promote
    )
    if not bool(ok):
        return None
    pinned = bool(pinned)

    kd = offsets.index(0)
    star_hi = StarStencil3D(
        diag=diag_hi, cx=cx, cy=cy, cz=cz, pinned=pinned
    )
    if op_lo is op_hi:
        star_lo = star_hi
    else:
        # the f32 twin reuses the already-resident f32 bands (for DFDIA,
        # hi IS float32(A) by the two-float split contract)
        lo_bands = op_hi.hi if isinstance(op_hi, DFDIA) else op_lo.bands
        star_lo = StarStencil3D(
            diag=lo_bands[kd].reshape(gz, gy, gx),
            cx=cx.astype(lo_bands.dtype),
            cy=cy.astype(lo_bands.dtype),
            cz=cz.astype(lo_bands.dtype),
            pinned=pinned,
        )
    return star_hi, star_lo
