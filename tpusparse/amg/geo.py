"""Geometry-aware aggregation for the general-matrix (aij) path.

The unstructured V-cycle's FactoredTransfer applies the tentative
prolongator through a fine-sized gather (``e_c[agg]``) and a fine-sized
``segment_sum`` — the two operation classes that dominated the 300^3
general-matrix solve on the accelerator this was first built for (an
inherited measurement, not repeated on the GPU).

This module removes both for the (large, common) class of inputs whose
sparsity pattern reveals a 3-D grid: a banded matrix with offsets
``{dz*(nx*ny) + dy*nx + dx : |dz|,|dy|,|dx| <= r}`` *is* a grid operator in
lexicographic order, whatever its coefficients.  When ``infer_grid3d``
recognizes that shape, aggregation becomes geometric (bz x by x bx index
blocks — the same 3^3 aggregation the structured fast path uses, PETSc
``PCSetCoordinates``-informed GAMG being the precedent for
structure-exploiting aggregation), and the transfer becomes ``GeoTransfer``:
prolongation = 3-D ``repeat`` + crop, restriction = pad + block-``reshape``
sum — pure layout ops, zero gathers, zero scatters, at every level (Galerkin
coarse operators inherit the 3-D lexicographic numbering, so every coarse
level is a pure <=27-band DIA with no ELL remainder).

Inputs that do not look like grids keep the fully general greedy-Vanek
+ FactoredTransfer path (``amg/unstructured.py``).

Reference parity notes: the reference's matrix IS this class
(``DMSetMatType(MATAIJ)`` over a DMDA 7-point star,
/root/reference/src/helper.cpp:31-39,161-246); PETSc solves it through
general-CSR kernels (``src/openacc-step1/MatMult_SeqAIJ.patch:19-30``) with
graph-based GAMG aggregation.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def infer_grid3d(
    offsets: tuple[int, ...], n: int, max_reach: int = 3
) -> tuple[int, int, int] | None:
    """Recover (nz, ny, nx) from a banded sparsity pattern, or None.

    Accepts offset sets of the form ``dz*(nx*ny) + dy*nx + dx`` with
    ``|d*| <= max_reach`` over SOME factorization ``n == nx*ny*nz``.  The
    7-point star yields ``{0, +-1, +-nx, +-nx*ny}``; Galerkin coarse
    operators of geometric 3^3 aggregation yield the 27-point version.

    Degenerate/ambiguous patterns (pure tridiagonal, or too few distinct
    positive offsets to pin nx and nx*ny) return None — callers fall back
    to graph aggregation, never guess.
    """
    offs = sorted(set(int(o) for o in offsets))
    if offs != sorted(-o for o in offs):
        return None  # structurally nonsymmetric pattern: not a grid star
    pos = [o for o in offs if o > 0]
    if len(pos) < 2 or pos[0] != 1:
        return None
    # Grid stars are CLUSTERED offset sets: each (dz, dy) plane contributes
    # a run of at most 2*max_reach+1 consecutive dx values.  A solid banded
    # pattern (e.g. an RCM-reordered scattered matrix, whose offsets fill
    # an interval) can decompose "validly" under a small-nx factorization —
    # every integer below reach*(q+nx+1) does — so a long contiguous run is
    # a band, never a grid.  (Found by a false (56, 7, 7) inference on an
    # RCM-reordered 14^3 Poisson — which then crashed the geo setup.)
    run = longest = 1
    for a, b_ in zip(pos, pos[1:]):
        run = run + 1 if b_ == a + 1 else 1
        longest = max(longest, run)
    if longest > 2 * max_reach + 1:
        return None

    def decompose(o, nx, q):
        """o -> (dz, dy, dx) under strides (q, nx, 1), nearest rounding."""
        dz = round(o / q) if q else 0
        rem = o - dz * q
        dy = round(rem / nx)
        dx = rem - dy * nx
        return dz, dy, dx

    def valid(nx, ny, nz):
        q = nx * ny
        for o in pos:
            dz, dy, dx = decompose(o, nx, q if nz > 1 else 0)
            if nz == 1 and abs(o) >= q:
                return False
            if not (abs(dz) <= max_reach and abs(dy) <= max_reach
                    and abs(dx) <= max_reach):
                return False
            # (dz,dy,dx) must address a real neighbor on the grid
            if abs(dy) >= ny or abs(dx) >= nx or abs(dz) >= nz:
                return False
        return True

    def score(nx, ny, nz):
        """Total |dz|+|dy|+|dx| over offsets — the true factorization
        decomposes a grid star with minimal neighbor reach, so ties between
        valid factorizations (possible on tiny grids whose offset clusters
        overlap) resolve toward the real one."""
        q = nx * ny
        return sum(
            sum(map(abs, decompose(o, nx, q if nz > 1 else 0)))
            for o in pos
        )

    # nx candidates: the cluster of offsets just above the x-band (a
    # 27-point pattern has {nx-1, nx, nx+1} — any member might be first)
    big = [o for o in pos if o > max_reach]
    if not big:
        return None
    nx_cands = [o for o in big if o <= big[0] + max_reach and n % o == 0]
    found: list[tuple[int, tuple[int, int, int]]] = []
    for nx in nx_cands:
        # q candidates: cluster just above the xy-plane band
        plane = [o for o in big if o > nx * max_reach + max_reach]
        if not plane:
            ny = n // nx
            if ny >= 1 and valid(nx, ny, 1):
                found.append((score(nx, ny, 1), (1, ny, nx)))
            continue
        q_cands = [
            o for o in plane
            if o <= plane[0] + nx * max_reach + max_reach
            and o % nx == 0 and n % o == 0
        ]
        for q in q_cands:
            ny = q // nx
            nz = n // q
            if ny >= 1 and nz >= 1 and valid(nx, ny, nz):
                found.append((score(nx, ny, nz), (nz, ny, nx)))
    return min(found)[1] if found else None


def geo_block_sizes(shape, factor: int = 3):
    """Per-axis aggregation block size: ``factor``, clamped to the axis."""
    return tuple(min(factor, s) for s in shape)


def coarse_dims(shape, bs):
    return tuple(-(-s // b) for s, b in zip(shape, bs))


def geo_aggregate_ids(shape, bs) -> np.ndarray:
    """Aggregate id of every fine cell under bz x by x bx index blocks,
    3-D lexicographic coarse numbering.  (n,) int64, host-side — used to
    build the tentative prolongator for the Galerkin products."""
    nz, ny, nx = shape
    czs, cys, cxs = coarse_dims(shape, bs)
    z, y, x = np.meshgrid(
        np.arange(nz) // bs[0], np.arange(ny) // bs[1],
        np.arange(nx) // bs[2], indexing="ij",
    )
    return (z * cys * cxs + y * cxs + x).reshape(-1)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["w", "omega", "sz", "sy", "sx"],
    meta_fields=["fine_shape", "bs"],
)
@dataclasses.dataclass
class GeoTransfer:
    """Smoothed-aggregation transfer over geometric index blocks —
    gather/scatter-free twin of ``FactoredTransfer``.

    P = (I - omega D^-1 A) T with T the l2-normalized piecewise-constant
    tentative prolongator over bz x by x bx blocks.  T's index action is
    carried by per-axis 0/1 membership matrices ``sz/sy/sx`` as tensor
    contractions (``amg/transfer.expand3``/``block_sum3``, the structured
    path's own).
    The smoothing factor reuses the level operator's gather-free mv.
    Identical math to FactoredTransfer (tested), different data movement.
    """

    w: jax.Array           # (n_fine,) 1/sqrt(|block|) per member
    omega: jax.Array       # prolongator-smoothing damping
    sz: jax.Array          # (nz, czs) 0/1 membership
    sy: jax.Array          # (ny, cys)
    sx: jax.Array          # (nx, cxs)
    fine_shape: tuple[int, int, int]
    bs: tuple[int, int, int]

    @classmethod
    def build(cls, w, omega, fine_shape, bs, dtype=jnp.float32):
        from tpusparse.amg.transfer import _agg_matrix

        nz, ny, nx = fine_shape
        return cls(
            w=w, omega=omega,
            sz=jnp.asarray(_agg_matrix(nz, bs[0], np.float32), dtype),
            sy=jnp.asarray(_agg_matrix(ny, bs[1], np.float32), dtype),
            sx=jnp.asarray(_agg_matrix(nx, bs[2], np.float32), dtype),
            fine_shape=tuple(fine_shape), bs=tuple(bs),
        )

    @property
    def coarse_shape(self):
        return coarse_dims(self.fine_shape, self.bs)

    @property
    def n_coarse(self) -> int:
        c = self.coarse_shape
        return c[0] * c[1] * c[2]

    def _up(self, e_c: jax.Array) -> jax.Array:
        """T0 e_c as three axis contractions, flat -> flat."""
        from tpusparse.amg.transfer import expand3

        e3 = e_c.reshape(self.coarse_shape)
        return expand3(e3, self.sz, self.sy, self.sx).reshape(-1)

    def _down(self, v: jax.Array) -> jax.Array:
        """T0^T v as three axis contractions, flat -> flat."""
        from tpusparse.amg.transfer import block_sum3

        v3 = v.reshape(self.fine_shape)
        return block_sum3(v3, self.sz, self.sy, self.sx).reshape(-1)

    def prolong(self, fine_op, dinv, e_c):
        t = self.w * self._up(e_c)
        return t - self.omega * (dinv * fine_op.mv(t))

    def restrict(self, fine_op, dinv, x):
        s = x - self.omega * fine_op.mv(dinv * x)
        return self._down(self.w * s)


def up3(e_c: jax.Array, fine_shape, bs) -> jax.Array:
    """T0 e_c: nearest-neighbor upsample (repeat + crop), flat->flat.
    Reference/oracle form — production uses GeoTransfer's contractions."""
    nz, ny, nx = fine_shape
    e3 = e_c.reshape(coarse_dims(fine_shape, bs))
    for ax, b in enumerate(bs):
        if b > 1:
            e3 = jnp.repeat(e3, b, axis=ax)
    return e3[:nz, :ny, :nx].reshape(-1)


def down3(v: jax.Array, fine_shape, bs) -> jax.Array:
    """T0^T v: zero-pad to block multiples + block-sum, flat->flat.
    Reference/oracle form — production uses GeoTransfer's contractions."""
    nz, ny, nx = fine_shape
    (bz, by, bx) = bs
    czs, cys, cxs = coarse_dims(fine_shape, bs)
    v3 = v.reshape(nz, ny, nx)
    pad = (czs * bz - nz, cys * by - ny, cxs * bx - nx)
    if any(pad):
        v3 = jnp.pad(v3, [(0, p) for p in pad])
    return (
        v3.reshape(czs, bz, cys, by, cxs, bx)
        .sum(axis=(1, 3, 5))
        .reshape(-1)
    )


def _ax_sizes(s, b):
    c = -(-s // b)
    out = np.full(c, b, np.float64)
    if s % b:
        out[-1] = s % b
    return out


def block_weight_field(shape, bs, dtype=np.float32):
    """COARSE-sized array of 1/sqrt(|block|) (ragged edge blocks included).
    Tiny host build; the fine-sized w = upsample of this, done on device."""
    sz = _ax_sizes(shape[0], bs[0])
    sy = _ax_sizes(shape[1], bs[1])
    sx = _ax_sizes(shape[2], bs[2])
    sizes = sz[:, None, None] * sy[None, :, None] * sx[None, None, :]
    return (1.0 / np.sqrt(sizes)).astype(dtype)


def block_weight_field_dev(shape, bs, dtype=jnp.float32):
    """Device twin: outer product of three TINY per-axis constants —
    trace-friendly (no fine/coarse-sized host constants baked into jitted
    setup programs)."""
    sz = jnp.asarray(_ax_sizes(shape[0], bs[0]), dtype)
    sy = jnp.asarray(_ax_sizes(shape[1], bs[1]), dtype)
    sx = jnp.asarray(_ax_sizes(shape[2], bs[2]), dtype)
    sizes = sz[:, None, None] * sy[None, :, None] * sx[None, None, :]
    return 1.0 / jnp.sqrt(sizes)


def grid_reach(offsets, shape) -> tuple[int, int, int]:
    """Per-axis neighbor reach (|dz|,|dy|,|dx| max) of a banded operator on
    the given grid."""
    nz, ny, nx = shape
    q = ny * nx
    rz = ry = rx = 0
    for o in offsets:
        dz = round(o / q) if nz > 1 else 0
        rem = o - dz * q
        dy = round(rem / nx) if ny > 1 else 0
        dx = rem - dy * nx
        rz, ry, rx = max(rz, abs(dz)), max(ry, abs(dy)), max(rx, abs(dx))
    return rz, ry, rx


def galerkin_probe_geo(fine_op, dinv, transfer: GeoTransfer, dtype=None):
    """A_c = P^T A P by exact on-device colored probing — the DIA twin of
    ``amg/galerkin.galerkin_coarse`` (same idea: the coarse pattern is known
    a priori under geometric aggregation, so comb vectors whose members are
    farther apart than the coarse reach recover every band exactly).  This
    replaces the host SpGEMM entirely: no host coarse matrix, no coarse
    uploads — KSPSetUp runs at device speed (the host PtAP measured 20 s at
    200^3; ~70 s extrapolated at 300^3).
    """
    from tpusparse.sparse.dia import DIA

    fs = transfer.fine_shape
    cs = transfer.coarse_shape
    czs, cys, cxs = cs
    nc = czs * cys * cxs
    bs = transfer.bs
    dt = dtype or dinv.dtype

    # coarse reach per axis: supports overlap iff |dc|*b < b + 3*reach
    reach = grid_reach(fine_op.offsets, fs)
    rc = tuple(
        (b - 1 + 3 * r) // b if s > 1 else 0
        for b, r, s in zip(bs, reach, cs)
    )
    mz, my, mx = (2 * r + 1 for r in rc)
    d3s = [
        (dz, dy, dx)
        for dz in range(-rc[0], rc[0] + 1)
        for dy in range(-rc[1], rc[1] + 1)
        for dx in range(-rc[2], rc[2] + 1)
        if abs(dz) < czs and abs(dy) < cys and abs(dx) < cxs
    ]
    offsets = tuple(
        dz * cys * cxs + dy * cxs + dx for (dz, dy, dx) in d3s
    )

    def shift3c(y3, d3):
        """out[p] = y3[p + d3] (zeros shifted in)."""
        pads = [
            (-d3[0], d3[0], 0), (-d3[1], d3[1], 0), (-d3[2], d3[2], 0)
        ]
        return jax.lax.pad(y3, jnp.zeros((), y3.dtype), pads)

    n_probes = mz * my * mx

    @jax.jit
    def probe_all(fine_op, dinv, transfer):
        kz = jax.lax.broadcasted_iota(jnp.int32, cs, 0) % mz
        jy = jax.lax.broadcasted_iota(jnp.int32, cs, 1) % my
        ix = jax.lax.broadcasted_iota(jnp.int32, cs, 2) % mx

        def body(t, bands):
            a = t // (my * mx)
            rem = t % (my * mx)
            b = rem // mx
            c = rem % mx
            mask = (kz == a) & (jy == b) & (ix == c)
            e3 = mask.astype(dt)
            y = transfer.restrict(
                fine_op, dinv,
                fine_op.mv(transfer.prolong(fine_op, dinv, e3.reshape(-1))),
            )
            y3 = y.reshape(cs)
            # DIA convention bands[k][r] = A[r, r+o]: row r reads the probe
            # when its COLUMN r+d3 is a comb member — index by row so
            # nonsymmetric operators probe correctly too
            for k, d3 in enumerate(d3s):
                col_is_member = shift3c(e3, d3) > 0.5
                bands = bands.at[k].set(
                    jnp.where(col_is_member, y3, bands[k])
                )
            return bands

        bands0 = jnp.zeros((len(d3s),) + cs, dtype=dt)
        return jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(n_probes), body, bands0
        )

    bands = probe_all(fine_op, dinv, transfer).reshape(len(d3s), nc)
    # sort offsets ascending (DIA convention).  Coarse levels stay FLAT
    # DIA deliberately: their mv cost is negligible (27-64x fewer rows),
    # and a small-shape GridDIA inside a jitted CG while_loop was observed
    # to make the whole solve stall on XLA:CPU (individually-exact mv;
    # composition-level miscompile class — see sparse/griddia.py).  The
    # 3-D view is reserved for the FINE level, where the bandwidth lives.
    order = np.argsort(offsets)
    return DIA(
        bands=bands[np.asarray(order)],
        offsets=tuple(int(offsets[i]) for i in order),
        shape=(nc, nc),
    )


def gamg_setup_geo(fine_op, shape, params, timings: dict | None = None):
    """Device-resident geometric GAMG setup: given the FINE-level DIA
    operator (already on device) and its inferred grid shape, build the
    whole hierarchy without ever materializing a host coarse matrix —
    aggregation is index arithmetic, transfers are reshapes, Galerkin
    products are on-device colored probes (``galerkin_probe_geo``), rho is
    the on-device power iteration.

    KSPSetUp parity (/root/reference/src/main_ksp.cpp:97-100): this IS the
    setup phase for grid-shaped aij inputs; only the fine operator upload
    (timed by the caller) touches the host after assembly.
    """
    if params.coarse_solve not in ("jacobi", "lu"):
        raise ValueError(
            f"unknown coarse_solve {params.coarse_solve!r} (jacobi | lu)"
        )
    import time as _time

    from tpusparse.amg.hierarchy import (
        Hierarchy,
        Level,
        estimate_rho_dinv_a,
    )

    tm = {"aggregate": 0.0, "galerkin": 0.0, "rho": 0.0, "device_put": 0.0}
    levels = []
    op = fine_op
    while True:
        n = int(np.prod(shape))
        dinv = 1.0 / op.diagonal()
        _t0 = _time.perf_counter()
        rho = (
            estimate_rho_dinv_a(op, dinv, params.rho_iters)
            * params.rho_safety
        )
        rho = jnp.asarray(rho, op.dtype)
        tm["rho"] += _time.perf_counter() - _t0
        bs = geo_block_sizes(shape, params.factor)
        last = (
            n <= params.coarse_eq_limit
            or len(levels) + 1 >= params.max_levels
            or all(b == 1 for b in bs)
        )
        if last:
            from tpusparse.amg.hierarchy import dense_coarse_inverse

            levels.append(Level(
                op=op, dinv=dinv, rho=rho, transfer=None,
                coarse_inv=(
                    dense_coarse_inverse(op)
                    if params.coarse_solve == "lu" else None
                ),
            ))
            break
        omega = (
            params.omega_scale / rho
            if params.nsmooths == 1
            else jnp.zeros((), op.dtype)
        )
        _t0 = _time.perf_counter()
        w_c = block_weight_field_dev(shape, bs, op.dtype)
        transfer = GeoTransfer.build(
            w=w_c.reshape(-1),  # placeholder; replaced by the fine field
            omega=omega,
            fine_shape=tuple(shape),
            bs=bs,
        )
        # upsample the coarse weight field through the transfer's own
        # contraction (jitted: one dispatch, not one per eager op)
        w_f = jax.jit(lambda t, wc: t._up(wc))(transfer, w_c.reshape(-1))
        transfer = dataclasses.replace(transfer, w=w_f)
        tm["aggregate"] += _time.perf_counter() - _t0
        levels.append(Level(op=op, dinv=dinv, rho=rho, transfer=transfer))
        _t0 = _time.perf_counter()
        op = galerkin_probe_geo(op, dinv, transfer)
        if timings is not None:
            jax.block_until_ready(op.bands)
        tm["galerkin"] += _time.perf_counter() - _t0
        shape = coarse_dims(shape, bs)

    if timings is not None:
        for k, v in tm.items():
            timings[k] = timings.get(k, 0.0) + v
    return Hierarchy(
        levels=levels,
        damping=jnp.asarray(params.smooth_damping, levels[0].dinv.dtype),
        smoother=params.smoother,
        degree=params.degree,
        cheby_lo=params.cheby_lo,
        cheby_hi=params.cheby_hi,
    )


@partial(jax.jit, static_argnames=("shape", "params"))
def gamg_setup_geo_compiled(fine_op, shape, params):
    """ONE-dispatch geometric setup: the whole device-resident hierarchy
    build (rho, transfers, every Galerkin probe at every level) as a
    single XLA program instead of eager per-level dispatches.
    Compile-cached per (shape, offsets, params)."""
    return gamg_setup_geo(fine_op, tuple(shape), params, None)
