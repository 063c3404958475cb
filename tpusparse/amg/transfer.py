"""Structured smoothed-aggregation grid transfers — matrix-free P and P^T.

GAMG parity (``configs/PETSc_SolverOptions_GAMG.info:6-9``: ``-pc_gamg_type
agg``, ``-pc_gamg_agg_nsmooths 1``, ``-pc_gamg_threshold 0.0``): the
prolongator is the once-smoothed tentative aggregate operator

    P = (I - omega * D^{-1} A) T,     omega = 4 / (3 * rho(D^{-1} A)),

with threshold 0.0 meaning the full graph is "strong" (no filtering), exactly
the reference's configuration.  On a structured grid we choose the aggregates
*geometrically* — 3x3x3 cell blocks (ragged at the high boundary when a
dimension is not divisible by 3) — which a strength-of-connection pass on the
isotropic 7-point Laplacian would also produce, and which keeps every level
structured (see ``varstencil.py``).

T is the piecewise-constant injection with l2-normalized columns
(T[i, c] = 1/sqrt(|agg c|)), so its action is a ``repeat``-then-scale and its
transpose a block-sum-then-scale — both pure reshapes on the 3D field view.
P and P^T therefore never exist as matrices: prolong/restrict are one fine
stencil apply plus a reshape, keeping transfers gather-free and HBM-bound.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def norm_factors(factor) -> tuple[int, int, int]:
    """Per-axis aggregation factors: an int means isotropic blocks; a
    3-tuple (fz, fy, fx) encodes anisotropic/semicoarsening aggregation
    (factor 1 = axis not coarsened — the -pc_gamg_threshold structured
    semantics, see hierarchy.threshold_schedule)."""
    if isinstance(factor, (tuple, list)):
        fz, fy, fx = (int(f) for f in factor)
        return (fz, fy, fx)
    return (int(factor),) * 3


def coarse_shape(fine_shape: tuple[int, int, int], factor=3):
    return tuple(
        cdiv(s, f) for s, f in zip(fine_shape, norm_factors(factor))
    )


def aggregate_sizes(fine_shape, factor=3) -> np.ndarray:
    """(ncz, ncy, ncx) array of aggregate cardinalities (ragged at the top)."""
    per_axis = []
    for s, f in zip(fine_shape, norm_factors(factor)):
        nc = cdiv(s, f)
        sz = np.full(nc, f, dtype=np.int64)
        rem = s - f * (nc - 1)
        sz[-1] = rem
        per_axis.append(sz)
    return (
        per_axis[0][:, None, None]
        * per_axis[1][None, :, None]
        * per_axis[2][None, None, :]
    )


def _agg_matrix(n: int, factor: int, dtype) -> np.ndarray:
    """(n, ceil(n/factor)) 0/1 membership matrix: S[i, i // factor] = 1.

    The T-action along one axis is a contraction with S, which XLA lowers
    to a matrix product; the ``jnp.repeat`` / reshape-and-reduce forms
    (``_repeat_crop``, ``_block_sum``) are kept as the test oracles.
    """
    nc = cdiv(n, factor)
    s = np.zeros((n, nc), dtype)
    s[np.arange(n), np.arange(n) // factor] = 1
    return s


def _repeat_crop(e: jax.Array, fine_shape, factor: int) -> jax.Array:
    """T-action index part: coarse field -> fine field (piecewise constant).

    Reference implementation (repeat + crop); the hot path uses the
    ``_agg_matrix`` contractions below.  Kept as the oracle for tests.
    """
    x = e
    for ax in range(3):
        x = jnp.repeat(x, factor, axis=ax)
    return x[: fine_shape[0], : fine_shape[1], : fine_shape[2]]


def _block_sum(r: jax.Array, c_shape, factor: int) -> jax.Array:
    """T^T-action index part: fine field -> coarse field (sum over blocks).

    Reference implementation (pad + 6-D reshape + reduce); hot path uses
    ``_agg_matrix`` contractions.  Kept as the oracle for tests.
    """
    pad = tuple((0, c_shape[i] * factor - r.shape[i], 0) for i in range(3))
    x = lax.pad(r, jnp.zeros((), r.dtype), pad)
    x = x.reshape(
        c_shape[0], factor, c_shape[1], factor, c_shape[2], factor
    )
    return x.sum(axis=(1, 3, 5))


# The T / T^T contractions below are 0/1 block sums bound by memory
# bandwidth.  A float32 dot at default precision may run in TF32 on a GPU
# (about three decimal digits), which buys no speed here, so every transfer
# contraction asks for full precision.
PRECISION = lax.Precision.HIGHEST


def expand3(e, sz, sy, sx, precision=PRECISION):
    """out[z, y, x] = sum sz[z, c] sy[y, d] sx[x, e] e[c, d, e]: the
    coarse -> fine index action of T as three axis contractions."""
    x = jnp.einsum("zc,cde->zde", sz, e, precision=precision)
    x = jnp.einsum("yd,zde->zye", sy, x, precision=precision)
    return jnp.einsum("xe,zye->zyx", sx, x, precision=precision)


def block_sum3(r, sz, sy, sx, precision=PRECISION):
    """out[c, d, e] = sum sz[z, c] sy[y, d] sx[x, e] r[z, y, x]: the
    fine -> coarse index action of T^T (the transpose of ``expand3``)."""
    x = jnp.einsum("zyx,zc->cyx", r, sz, precision=precision)
    x = jnp.einsum("cyx,yd->cdx", x, sy, precision=precision)
    return jnp.einsum("cdx,xe->cde", x, sx, precision=precision)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["omega", "tnorm", "sz", "sy", "sx", "fop"],
    meta_fields=["fine_shape", "factor"],
)
@dataclasses.dataclass
class StructuredTransfer:
    """Matrix-free smoothed-aggregation transfer between one level pair.

    ``tnorm`` is the coarse-shaped field 1/sqrt(|agg|); ``omega`` the
    prolongator-smoothing damping; ``sz/sy/sx`` the per-axis aggregation
    matrices (``_agg_matrix``) that carry the T-action as contractions.
    ``fine_op``/``dinv`` live in the fine level and are passed per call
    (they are needed for the smoothing apply).
    """

    omega: jax.Array                 # scalar
    tnorm: jax.Array                 # (ncz, ncy, ncx)
    sz: jax.Array                    # (nz, ncz) 0/1
    sy: jax.Array                    # (ny, ncy) 0/1
    sx: jax.Array                    # (nx, ncx) 0/1
    # optional FILTERED operator for the P-smoothing applies only
    # (-pc_gamg_threshold: weak-axis legs dropped so the smoothed P has no
    # reach along uncoarsened axes — keeps A_c inside the 27-point
    # container; PETSc smooths P with the filtered matrix the same way).
    # The residual/smoother applies keep the FULL level operator.
    fop: object | None
    fine_shape: tuple[int, int, int]
    factor: int | tuple[int, int, int]

    @classmethod
    def build(cls, fine_shape, omega, dtype, factor=3, fop=None):
        fz, fy, fx = norm_factors(factor)
        sizes = aggregate_sizes(fine_shape, factor)
        tnorm = jnp.asarray(1.0 / np.sqrt(sizes), dtype=dtype)
        return cls(
            omega=jnp.asarray(omega, dtype),
            tnorm=tnorm,
            sz=jnp.asarray(_agg_matrix(fine_shape[0], fz, dtype)),
            sy=jnp.asarray(_agg_matrix(fine_shape[1], fy, dtype)),
            sx=jnp.asarray(_agg_matrix(fine_shape[2], fx, dtype)),
            fop=fop,
            fine_shape=tuple(fine_shape),
            factor=norm_factors(factor),
        )

    @property
    def c_shape(self):
        return coarse_shape(self.fine_shape, self.factor)

    def t_apply(self, e_c: jax.Array) -> jax.Array:
        """T e_c: normalized piecewise-constant interpolation, as three
        axis contractions (coarse -> fine)."""
        return expand3(e_c * self.tnorm, self.sz, self.sy, self.sx)

    def tT_apply(self, r: jax.Array) -> jax.Array:
        """T^T r: block sums as three axis contractions (fine -> coarse)."""
        return block_sum3(r, self.sz, self.sy, self.sx) * self.tnorm

    def prolong(self, fine_op, dinv: jax.Array, e_c: jax.Array) -> jax.Array:
        """x_f = P e_c = (I - omega D^{-1} A) T e_c."""
        if self.fop is not None:
            fine_op = self.fop  # threshold-filtered smoothing operator
        t = self.t_apply(e_c)
        return t - self.omega * dinv * fine_op.mv(t)

    def restrict(self, fine_op, dinv: jax.Array, r: jax.Array) -> jax.Array:
        """r_c = P^T r = T^T (I - omega A D^{-1}) r   (A symmetric)."""
        if self.fop is not None:
            fine_op = self.fop  # threshold-filtered smoothing operator
        s = r - self.omega * fine_op.mv(dinv * r)
        return self.tT_apply(s)

    # --- host-side explicit P (oracle for tests / interop) ----------------
    def explicit_p_scipy(self, fine_op_csr, dinv_flat: np.ndarray):
        """Materialize P as scipy CSR: (I - omega D^{-1} A) T."""
        import scipy.sparse as sp

        fz, fy, fx = self.fine_shape
        cz, cy, cx = self.c_shape
        n_f, n_c = fz * fy * fx, cz * cy * cx
        K, J, I = np.meshgrid(
            np.arange(fz), np.arange(fy), np.arange(fx), indexing="ij"
        )
        fz, fy, fx_ = norm_factors(self.factor)
        agg = ((K // fz) * cy + (J // fy)) * cx + (I // fx_)
        tnorm = np.asarray(jax.device_get(self.tnorm)).reshape(-1)
        t = sp.csr_matrix(
            (
                tnorm[agg.reshape(-1)],
                (np.arange(n_f), agg.reshape(-1)),
            ),
            shape=(n_f, n_c),
        )
        a = fine_op_csr.to_scipy()
        d = sp.diags(np.asarray(dinv_flat))
        omega = float(self.omega)
        return (t - omega * (d @ (a @ t))).tocsr()
