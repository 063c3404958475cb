"""Explicit halo-exchange stencil SpMV under ``shard_map`` — VecScatter /
MatMult_MPIAIJ parity, hand-scheduled.

The default distributed path (``dist/mesh.py``) lets GSPMD partition the
``lax.pad`` shifts and insert halo collectives automatically.  This module is
the *explicit* equivalent of what PETSc does inside ``MatMult_MPIAIJ``
(SURVEY.md section 3.3): VecScatterBegin (post neighbor exchanges), compute
the diagonal-block contribution from purely local data, VecScatterEnd, add
the off-block contribution from received ghost planes.  Here the exchanges
are ``lax.ppermute`` shifts along the ('z', 'y') mesh axes, and the code is
ordered so the interior compute has no data dependence on the permutes —
XLA can overlap the transfer with the local stencil math, the same
communication/compute overlap the reference gets from
VecScatterBegin/.../VecScatterEnd.

Domain boundaries (mesh edge shards) zero their halos — exactly the
reference's Neumann-via-dropped-entries assembly (src/helper.cpp:229-233).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from tpusparse.dist.mesh import AXES, check_divisible, field_sharding


def _neighbor_planes(x_local, axis: int, axis_name: str):
    """Exchange boundary planes with mesh neighbors along one axis.

    Returns (prev_plane, next_plane): the neighbor-owned planes adjacent to
    this shard's low/high face (zeros at the domain boundary).
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    lo = lax.slice_in_dim(x_local, 0, 1, axis=axis)
    hi = lax.slice_in_dim(
        x_local, x_local.shape[axis] - 1, x_local.shape[axis], axis=axis
    )
    if n == 1:
        z = jnp.zeros_like(lo)
        return z, z
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    # my low-face halo = previous shard's high plane; high-face halo = next's low
    prev_plane = lax.ppermute(hi, axis_name, fwd)
    next_plane = lax.ppermute(lo, axis_name, bwd)
    zeros = jnp.zeros_like(lo)
    prev_plane = jnp.where(idx == 0, zeros, prev_plane)
    next_plane = jnp.where(idx == n - 1, zeros, next_plane)
    return prev_plane, next_plane


def _shift_with_halo(x, axis: int, direction: int, halo):
    """out[i] = x[i + direction] along axis, reading ``halo`` past the edge."""
    size = x.shape[axis]
    if direction == 1:
        body = lax.slice_in_dim(x, 1, size, axis=axis)
        return jnp.concatenate([body, halo], axis=axis)
    body = lax.slice_in_dim(x, 0, size - 1, axis=axis)
    return jnp.concatenate([halo, body], axis=axis)


def _local_shift(x, axis: int, direction: int):
    """Zero-filled shift entirely inside the shard (for the unsharded x axis)."""
    cfg = [(0, 0, 0)] * x.ndim
    cfg[axis] = (-1, 1, 0) if direction == 1 else (1, -1, 0)
    return lax.pad(x, jnp.zeros((), x.dtype), cfg)


def _mv_shard(diag, cx, cy, cz, x, *, pinned: bool):
    """Per-shard stencil apply.  Runs inside shard_map over ('z', 'y')."""
    zi = lax.axis_index("z")
    yi = lax.axis_index("y")
    on_origin_shard = (zi == 0) & (yi == 0)

    kk = lax.broadcasted_iota(jnp.int32, x.shape, 0)
    jj = lax.broadcasted_iota(jnp.int32, x.shape, 1)
    ii = lax.broadcasted_iota(jnp.int32, x.shape, 2)
    zero = jnp.zeros((), x.dtype)

    if pinned:
        # zero column 0: the origin lives at local (0,0,0) of shard (0,0);
        # mask it out of x before ANY neighbor read — including the exchanged
        # planes: with a 1-plane-thick shard (nz_local==1 or ny_local==1) the
        # origin's plane IS the hi face shipped to the z+1/y+1 neighbor, so
        # the exchange must carry the masked field.  (The local diag*x term
        # below is unaffected; it reads the unmasked x.)
        origin = on_origin_shard & (kk == 0) & (jj == 0) & (ii == 0)
        xn = jnp.where(origin, zero, x)
    else:
        xn = x

    # --- VecScatterBegin parity: post all four neighbor exchanges ----------
    z_prev, z_next = _neighbor_planes(xn, 0, "z")
    y_prev, y_next = _neighbor_planes(xn, 1, "y")

    # --- diagonal-block contribution: purely local, overlaps the permutes --
    y = diag * x
    y += cx * (_local_shift(xn, 2, 1) + _local_shift(xn, 2, -1))
    y += cy * (_local_shift(xn, 1, 1) + _local_shift(xn, 1, -1))
    y += cz * (_local_shift(xn, 0, 1) + _local_shift(xn, 0, -1))

    # --- VecScatterEnd + off-block contribution from ghost planes ----------
    nz_l, ny_l = x.shape[0], x.shape[1]
    y = y.at[0].add(cz * z_prev[0])
    y = y.at[nz_l - 1].add(cz * z_next[0])
    y = y.at[:, 0].add(cy * y_prev[:, 0])
    y = y.at[:, ny_l - 1].add(cy * y_next[:, 0])

    if pinned:
        y = jnp.where(origin, diag * x, y)
    return y


def halo_mv(op, x: jax.Array, mesh) -> jax.Array:
    """y = A @ x with explicit halo exchange (StarStencil3D operators).

    Matches ``op.mv`` exactly on (z, y)-sharded fields; exists both as the
    hand-scheduled overlap path and as executable documentation of the
    communication pattern GSPMD derives implicitly.
    """
    check_divisible(x.shape, mesh)
    fn = jax.shard_map(
        partial(_mv_shard, pinned=op.pinned),
        mesh=mesh,
        in_specs=(P(*AXES, None), P(), P(), P(), P(*AXES, None)),
        out_specs=P(*AXES, None),
    )
    return fn(op.diag, op.cx, op.cy, op.cz, x)
