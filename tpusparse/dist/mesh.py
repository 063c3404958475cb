"""Device-mesh distribution — the replacement for the reference's MPI rank
decomposition.

The reference scales by DMDA box decomposition over MPI ranks with VecScatter
halo exchange inside MatMult_MPIAIJ and MPI_Allreduce for every CG dot
(SURVEY.md sections 2c, 5.8).  Here the same spatial decomposition is a
``jax.sharding.Mesh`` with fields sharded over (z, y) planes of the (nz, ny,
nx) field view; the stencil shifts become GSPMD halo exchanges between devices,
and the dots become single ``psum``s — all inserted by XLA from sharding
annotations on one jitted program, not hand-written point-to-point calls.

Sharding layout choices:
- level-0 fields (the big ones) shard over ('z', 'y'): halo traffic = one
  boundary plane per neighbor per stencil apply;
- the AMG hierarchy's coarse levels are orders of magnitude smaller
  (27x per level) and are replicated — their transfers then need one
  collective at the fine/coarse seam instead of resharding every level;
- XLA requires sharded dimensions to divide evenly; ``make_mesh`` factors the
  device count into a (pz, py) grid and ``shard_system`` validates
  divisibility up front with an actionable error (like DMDA's decomposition
  validation), instead of a mid-compile failure.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("z", "y")


def _factor2(n: int) -> tuple[int, int]:
    """Split n into (pz, py) with pz >= py, as square as possible."""
    best = (n, 1)
    for py in range(1, int(np.sqrt(n)) + 1):
        if n % py == 0:
            best = (n // py, py)
    return best


def make_mesh(
    n_devices: int | None = None, shape: tuple[int, int] | None = None
) -> Mesh:
    """2-D ('z', 'y') mesh over the first ``n_devices`` (all by default).

    ``shape=(pz, py)`` overrides the default near-square factorization.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    pz, py = shape if shape is not None else _factor2(n_devices)
    if pz * py != n_devices:
        raise ValueError(f"mesh shape {(pz, py)} != {n_devices} devices")
    return Mesh(
        np.asarray(devices[:n_devices]).reshape(pz, py), AXES
    )


def field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (nz, ny, nx) fields: split z and y over the mesh."""
    return NamedSharding(mesh, P(*AXES, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def check_divisible(field_shape, mesh: Mesh) -> None:
    pz, py = (mesh.shape["z"], mesh.shape["y"])
    nz, ny = field_shape[0], field_shape[1]
    if nz % pz or ny % py:
        raise ValueError(
            f"grid (nz={nz}, ny={ny}) not divisible by mesh (z={pz}, y={py});"
            f" choose a mesh shape that divides the grid, e.g."
            f" make_mesh(shape=(pz, py)) with nz % pz == ny % py == 0"
        )


def _put(tree, sharding):
    # (27, nz, ny, nx) coefficient stacks (VarStencil27) shard along the
    # grid dims like the fields they multiply; replicating one on a fine
    # level is a per-device memory blowup and forces GSPMD resharding
    # inside every mv.
    coef_sharding = NamedSharding(sharding.mesh, P(None, *AXES, None))

    def _place(x):
        if not hasattr(x, "ndim"):
            return x
        if x.ndim == 3:
            return jax.device_put(x, sharding)
        if x.ndim == 4:
            return jax.device_put(x, coef_sharding)
        return jax.device_put(x, NamedSharding(sharding.mesh, P()))

    return jax.tree.map(_place, tree)


def shard_system(op, b, exact, mesh: Mesh):
    """Place a stencil operator + vectors with (z, y)-sharded fields.

    Scalars (stencil coefficients) are replicated.
    """
    check_divisible(b.shape, mesh)
    fs = field_sharding(mesh)
    return _put(op, fs), jax.device_put(b, fs), jax.device_put(exact, fs)


def shard_hierarchy(hier, mesh: Mesh):
    """Shard level-0 fields over the mesh; replicate coarse levels (small).

    A level-0 transfer's ``tnorm`` lives on the *coarse* grid, so it is
    replicated along with everything from level 1 down.  VarStencil27
    coefficient stacks are 4-D (27, nz, ny, nx) and only appear from level 1
    on, where everything is replicated anyway.
    """
    fs = field_sharding(mesh)
    rep = replicated(mesh)
    put_rep = lambda t: jax.tree.map(lambda x: jax.device_put(x, rep), t)

    lev0 = hier.levels[0]
    check_divisible(lev0.dinv.shape, mesh)
    transfer0 = lev0.transfer
    if getattr(transfer0, "fop", None) is not None:
        # the filtered P-smoothing operator (-pc_gamg_threshold) is a
        # FINE-grid-sized operator: shard it exactly like lev0.op, never
        # replicate (ADVICE r4: replicated fop = memory blowup + forced
        # resharding inside restrict/prolong)
        import dataclasses as _dc

        transfer0 = _dc.replace(
            put_rep(_dc.replace(transfer0, fop=None)),
            fop=_put(transfer0.fop, fs),
        )
    else:
        transfer0 = put_rep(transfer0)
    if hasattr(transfer0, "sz"):
        # structured level-0 transfer: wrap the index contractions in the
        # seam-local shard_map form — one coarse-sized (n/27) psum at the
        # restrict seam and ZERO comm at prolong, instead of GSPMD's ~n/3
        # all-reduce + all-gather of the z-coarsened partial slab (measured
        # by utils/hlostats in round 4; dist/seam.py)
        from tpusparse.dist.seam import ShardedTransfer

        transfer0 = ShardedTransfer(inner=transfer0, mesh=mesh)
    new_levels = [
        type(lev0)(
            op=_put(lev0.op, fs),
            dinv=jax.device_put(lev0.dinv, fs),
            rho=jax.device_put(lev0.rho, rep),
            transfer=transfer0,
        )
    ] + [put_rep(lev) for lev in hier.levels[1:]]
    return dataclass_replace_levels(hier, new_levels, rep)


def dataclass_replace_levels(hier, new_levels, rep):
    import dataclasses

    return dataclasses.replace(
        hier, levels=new_levels, damping=jax.device_put(hier.damping, rep)
    )
