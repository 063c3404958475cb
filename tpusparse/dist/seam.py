"""Sharded fine/coarse transfer — the seam-local contraction form.

Round-4's HLO audit (``utils/hlostats`` + ``runs/scaling_weak.json``)
exposed what GSPMD emits for the level-0 restriction when the fine field is
(z, y)-sharded and the coarse hierarchy is replicated: it all-reduces the
z-coarsened PARTIAL slab (~n/3 values) over the z groups and all-gathers it
across y — ~n/3 bytes on the wire per V-cycle where ~n/27 suffice.  The
reference pays the analogous cost inside PETSc's MatMultTranspose +
VecScatter at each GAMG level boundary (`main_ksp.cpp:97`, setup-built
transfers applied every cycle).

This module is the n/27 form: ``shard_map`` the transfer's index
contractions so each device contracts ONLY its own (z, y) block against the
matching rows of the aggregation matrices — producing a full-coarse-shaped
partial that is zero outside the device's aggregates — then one ``psum``
over the mesh replicates the exact coarse field.  Bytes on the wire: one
ring all-reduce of the coarse field, 2*(p-1)/p * n/27 per device.  The
prolongation direction is the transpose: every device holds the replicated
coarse field and builds its own fine block locally — ZERO communication.

The smoothing applies (I - omega D^-1 A, fine-grid operators) stay in GSPMD
land where the stencil halo exchange already rides collective-permutes; only
the T / T^T index contractions move into ``shard_map``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
from jax import lax
from jax.sharding import PartitionSpec as P

from tpusparse.amg.transfer import block_sum3, expand3
from tpusparse.dist.mesh import AXES


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["inner"],
    meta_fields=["mesh"],
)
@dataclasses.dataclass
class ShardedTransfer:
    """Level-0 ``StructuredTransfer`` with seam-local T/T^T contractions.

    Drop-in for the transfer slot of a (z, y)-sharded level: ``restrict`` /
    ``prolong`` keep the StructuredTransfer formulas (the fine-grid
    smoothing apply runs under GSPMD on the sharded operator), but the
    coarse<->fine index contractions run under ``shard_map`` so the only
    collective at the seam is one coarse-sized psum (restrict) or nothing
    (prolong).  ``mesh`` is static metadata; the wrapped transfer's arrays
    (sz/sy/sx/tnorm, replicated) and optional sharded ``fop`` ride in the
    pytree as data.
    """

    inner: object          # StructuredTransfer (fields placed by caller)
    mesh: object           # jax.sharding.Mesh over AXES = ('z', 'y')

    # --- delegation --------------------------------------------------------
    @property
    def c_shape(self):
        return self.inner.c_shape

    @property
    def fine_shape(self):
        return self.inner.fine_shape

    @property
    def omega(self):
        return self.inner.omega

    @property
    def tnorm(self):
        return self.inner.tnorm

    @property
    def fop(self):
        return self.inner.fop

    def _blocks(self):
        pz, py = self.mesh.shape[AXES[0]], self.mesh.shape[AXES[1]]
        nz, ny, _ = self.inner.fine_shape
        return pz, py, nz // pz, ny // py

    # --- seam-local index contractions --------------------------------------
    def tT_apply(self, r: jax.Array) -> jax.Array:
        """T^T r, fine (sharded) -> coarse (replicated): local block sums +
        one coarse-sized psum."""
        _pz, _py, bz, by = self._blocks()

        def local(r_blk, sz, sy, sx, tnorm):
            iz = lax.axis_index(AXES[0])
            iy = lax.axis_index(AXES[1])
            # rows of the aggregation matrices covering this block; the
            # columns span ALL aggregates, so the contraction yields a
            # full-coarse-shaped partial (zero outside this block's
            # aggregates — boundary-straddling aggregates sum in the psum)
            szl = lax.dynamic_slice_in_dim(sz, iz * bz, bz, 0)
            syl = lax.dynamic_slice_in_dim(sy, iy * by, by, 0)
            return lax.psum(block_sum3(r_blk, szl, syl, sx), AXES) * tnorm

        fn = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(*AXES, None), P(), P(), P(), P()),
            out_specs=P(),
        )
        return fn(r, self.inner.sz, self.inner.sy, self.inner.sx,
                  self.inner.tnorm)

    def t_apply(self, e_c: jax.Array) -> jax.Array:
        """T e_c, coarse (replicated) -> fine (sharded): every device builds
        its own block from the replicated coarse field — no communication."""
        _pz, _py, bz, by = self._blocks()

        def local(e, sz, sy, sx, tnorm):
            iz = lax.axis_index(AXES[0])
            iy = lax.axis_index(AXES[1])
            szl = lax.dynamic_slice_in_dim(sz, iz * bz, bz, 0)
            syl = lax.dynamic_slice_in_dim(sy, iy * by, by, 0)
            return expand3(e * tnorm, szl, syl, sx)

        fn = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=P(*AXES, None),
        )
        return fn(e_c, self.inner.sz, self.inner.sy, self.inner.sx,
                  self.inner.tnorm)

    # --- smoothed-aggregation transfer (StructuredTransfer formulas) --------
    def prolong(self, fine_op, dinv: jax.Array, e_c: jax.Array) -> jax.Array:
        """x_f = P e_c = (I - omega D^{-1} A) T e_c."""
        if self.inner.fop is not None:
            fine_op = self.inner.fop
        t = self.t_apply(e_c)
        return t - self.inner.omega * dinv * fine_op.mv(t)

    def restrict(self, fine_op, dinv: jax.Array, r: jax.Array) -> jax.Array:
        """r_c = P^T r = T^T (I - omega A D^{-1}) r   (A symmetric)."""
        if self.inner.fop is not None:
            fine_op = self.inner.fop
        s = r - self.inner.omega * fine_op.mv(dinv * r)
        return self.tT_apply(s)
