"""Unstructured smoothed-aggregation AMG — the general-matrix GAMG path.

The structured hierarchy (``hierarchy.py``) covers the reference benchmark's
actual use (DMDA grids).  This module provides what PETSc GAMG provides for
*arbitrary* symmetric matrices (``-pc_type gamg -pc_gamg_type agg``): a
strength-of-connection graph, greedy Vanek aggregation, a smoothed tentative
prolongator, and Galerkin coarse operators — with setup on the host (it runs
once, like KSPSetUp) and the V-cycle apply fully on device over padded-ELL
operators and explicit ELL transfer matrices.

The apply path reuses ``hierarchy.vcycle`` unchanged: levels are the same
``Level`` pytree, with an ``ELLTransfer`` standing in for the matrix-free
structured transfer (duck-typed ``prolong``/``restrict``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpusparse.amg.hierarchy import AMGParams, Hierarchy, Level
from tpusparse.sparse.csr import HostCSR
from tpusparse.sparse.ell import ELL


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["p", "r"],
    meta_fields=[],
)
@dataclasses.dataclass
class ELLTransfer:
    """Explicit prolongator/restrictor pair (R = P^T, materialized once at
    setup so the apply path never pays a scatter)."""

    p: ELL  # (n_fine, n_coarse)
    r: ELL  # (n_coarse, n_fine)

    def prolong(self, fine_op, dinv, e_c):
        return self.p.mv(e_c)

    def restrict(self, fine_op, dinv, x):
        return self.r.mv(x)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["agg", "w", "omega"],
    meta_fields=["n_coarse", "nsmooths"],
)
@dataclasses.dataclass
class FactoredTransfer:
    """P kept in factored form P = (I - omega D^-1 A)^k T instead of as an
    explicit matrix: T's action is one gather from the SMALL coarse vector
    (prolong) / one segment-sum into it (restrict), and the smoothing factor
    reuses the level operator's gather-free DIA mv.  This removes the
    fine-sized ELL index gathers from the V-cycle entirely and stores O(n)
    instead of O(n*width).

    ``nsmooths`` (-pc_gamg_agg_nsmooths) is the prolongator-smoothing
    application count k: 0 = tentative-only (omega is 0 there), 1 = the
    reference config, >= 2 = wider-support smoothed aggregation (each
    application is one more fine mv per transfer).
    """

    agg: jax.Array    # (n_fine,) int32 aggregate id
    w: jax.Array      # (n_fine,) float: 1/sqrt(|aggregate|) per member
    omega: jax.Array  # prolongator-smoothing damping (0 when nsmooths=0)
    n_coarse: int
    nsmooths: int = 1

    def prolong(self, fine_op, dinv, e_c):
        t = self.w * e_c[self.agg]
        for _ in range(max(self.nsmooths, 0)):
            t = t - self.omega * (dinv * fine_op.mv(t))
        return t

    def restrict(self, fine_op, dinv, x):
        s = x
        for _ in range(max(self.nsmooths, 0)):
            s = s - self.omega * fine_op.mv(dinv * s)
        return jax.ops.segment_sum(
            self.w * s, self.agg, num_segments=self.n_coarse
        )


def strength_graph(a: HostCSR, threshold: float) -> "np.ndarray":
    """Boolean strong-connection mask over a's entries.

    GAMG semantics (``-pc_gamg_threshold``): keep entry (i, j != i) when
    |a_ij| > threshold * sqrt(|a_ii| * |a_jj|); threshold 0.0 (the reference
    config) keeps every structural connection.
    """
    rows = np.repeat(np.arange(a.n_rows), a.row_nnz())
    cols = a.indices
    off = rows != cols
    if threshold <= 0.0:
        return off
    d = np.abs(a.diagonal())
    lim = threshold * np.sqrt(d[rows] * d[cols])
    return off & (np.abs(a.data) > lim)


def greedy_aggregate(a: HostCSR, threshold: float = 0.0) -> np.ndarray:
    """Vanek-style greedy aggregation (the algorithm family behind GAMG's
    'agg' type).  Returns the aggregate id of every node.

    Pass 1: any node whose strong neighborhood is fully unaggregated roots a
    new aggregate containing the whole neighborhood.  Pass 2: remaining nodes
    join the aggregate of any strong neighbor.  Pass 3: leftovers root their
    own aggregates from whatever unaggregated neighbors remain.

    Dispatches to the native C++ engine when built (same decisions — tested
    against ``_greedy_aggregate_py``); Python loops otherwise.
    """
    from tpusparse import native

    strong = strength_graph(a, threshold)
    if native.available():
        agg, _ = native.aggregate(a, strong)
        return agg
    return _greedy_aggregate_py(a, strong)


def _greedy_aggregate_py(a: HostCSR, strong: np.ndarray) -> np.ndarray:
    """Pure-Python reference implementation (and no-toolchain fallback)."""
    n = a.n_rows
    indptr, indices = a.indptr, a.indices
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0

    def nbrs(i):
        sl = slice(indptr[i], indptr[i + 1])
        return indices[sl][strong[sl]]

    # pass 1
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = nbrs(i)
        if np.all(agg[nb] == -1):
            agg[i] = n_agg
            agg[nb] = n_agg
            n_agg += 1
    # pass 2: attach to a neighboring aggregate
    attach = agg.copy()
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = nbrs(i)
        owned = nb[agg[nb] != -1]
        if owned.size:
            attach[i] = agg[owned[0]]
    agg = attach
    # pass 3: leftovers
    for i in range(n):
        if agg[i] == -1:
            agg[i] = n_agg
            nb = nbrs(i)
            free = nb[agg[nb] == -1]
            agg[free] = n_agg
            n_agg += 1
    return agg


def tentative_prolongator(agg: np.ndarray):
    """T with l2-normalized piecewise-constant columns (scipy CSR)."""
    import scipy.sparse as sp

    n = agg.shape[0]
    n_agg = int(agg.max()) + 1
    sizes = np.bincount(agg, minlength=n_agg).astype(np.float64)
    vals = 1.0 / np.sqrt(sizes[agg])
    return sp.csr_matrix((vals, (np.arange(n), agg)), shape=(n, n_agg))


def _rho_m_a(a_sp, m_apply, iters: int = 25) -> float:
    """Power iteration for rho(M^{-1} A) with an arbitrary host apply."""
    v = np.sin(np.arange(a_sp.shape[0]) * 0.7 + 0.3)
    v /= np.linalg.norm(v)
    for _ in range(iters):
        w = m_apply(a_sp @ v)
        v = w / np.linalg.norm(w)
    return float(v @ m_apply(a_sp @ v))


def _rho_dinv_a(a_sp, dinv: np.ndarray, iters: int = 25) -> float:
    return _rho_m_a(a_sp, lambda r: dinv * r, iters)


def gamg_setup_unstructured(
    a: HostCSR | None, params: AMGParams = AMGParams(), dtype=None,
    device_format: str = "auto", max_offsets: int = 192,
    transfer_format: str = "auto", gather_row_cap: int | None = None,
    timings: dict | None = None, aggregation: str = "auto",
    fine_op=None,
) -> Hierarchy:
    """Build a device Hierarchy from an arbitrary symmetric HostCSR.

    ``a`` may be None when ``fine_op`` is a device container whose sparsity
    pattern resolves to the geometric device-resident setup (a
    device-assembled caller has no host matrix at all); any path that needs
    host graph passes (greedy aggregation) then raises.

    ``timings``: pass a dict to receive the setup-phase breakdown in seconds
    (keys: "aggregate", "galerkin", "rho", "device_put") — KSPSetUp is a
    first-class timed phase in the reference (src/main_ksp.cpp:97-100), so
    its dominant sub-costs must be observable here.

    ``device_format`` picks the level-operator container: "dia" (banded,
    gather-free), "ell"
    (padded gather form), or "auto" (DIA when the level occupies at most
    ``max_offsets`` diagonals — true for mesh-graph matrices, the
    reference's entire problem class — else ELL).

    ``transfer_format``: "factored" keeps P = (I - omega D^-1 A) T in
    factored form (no fine-sized index gathers; see FactoredTransfer),
    "ell" materializes explicit P / P^T matrices, "auto" = factored.

    ``aggregation``: "greedy" is the fully general graph path (Vanek greedy
    + FactoredTransfer); "geometric" demands a grid-shaped sparsity pattern
    (``amg/geo.infer_grid3d``) and aggregates by 3-D index blocks with
    reshape-based transfers — no gathers or scatters anywhere in the cycle;
    "banded" is the device-resident contiguous-segment setup for arbitrary
    banded matrices (``amg/deviceagg.py`` — no host matrix, no gathers);
    "auto" (default) uses geometric when the pattern reveals a grid, then
    banded when greedy is not viable (device-assembled input, or a fine
    level above the in-cycle gather cap), greedy otherwise.
    """
    if params.coarse_solve not in ("jacobi", "lu"):
        raise ValueError(
            f"unknown coarse_solve {params.coarse_solve!r} (jacobi | lu)"
        )
    import scipy.sparse as sp

    from tpusparse.sparse.dia import DIA

    # greedy's FactoredTransfer gathers at fine-level size inside the
    # solver loop; above this "auto" reroutes such inputs to the banded
    # setup (sparse/dia.py GATHER_ROW_CAP: an inherited limit, not measured
    # on the GPU)
    GATHER_ROW_CAP_BANDED = 1_500_000

    if params.nsmooths < 0:
        raise ValueError(f"nsmooths must be >= 0, got {params.nsmooths}")
    if params.smoother == "sor":
        raise ValueError(
            "smoother='sor' (multicolor GS) needs colorable grid"
            " operators; the unstructured DIA/ELL levels have no coloring"
            " — use chebyshev/richardson, or the structured path"
        )
    if device_format not in ("auto", "dia", "ell"):
        raise ValueError(f"unknown device_format {device_format!r}")
    if transfer_format not in ("auto", "factored", "ell"):
        raise ValueError(f"unknown transfer_format {transfer_format!r}")
    if aggregation not in ("auto", "geometric", "greedy", "banded"):
        raise ValueError(f"unknown aggregation {aggregation!r}")
    factored = transfer_format in ("auto", "factored")

    geo_shape = None
    if aggregation in ("auto", "geometric"):
        from tpusparse.amg.geo import infer_grid3d

        if fine_op is not None and hasattr(fine_op, "offsets"):
            # the caller's DIA container already knows the occupied
            # diagonals — recomputing them walks 2*nnz int64 ops (~7 s at
            # 300^3 of pure host time)
            offs_ = np.asarray(fine_op.offsets, np.int64)
        else:
            rows_ = np.repeat(
                np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr)
            )
            offs_ = np.unique(a.indices.astype(np.int64) - rows_)
        n_rows_ = a.n_rows if a is not None else fine_op.shape[0]
        geo_shape = infer_grid3d(tuple(offs_.tolist()), n_rows_)
        if geo_shape is None and aggregation == "geometric":
            raise ValueError(
                "aggregation='geometric' but the sparsity pattern does not"
                " reveal a 3-D grid (infer_grid3d); use 'auto' or 'greedy'"
            )
        if (
            geo_shape is not None
            and transfer_format == "auto"
            and device_format in ("auto", "dia")
            and params.bjacobi_bs == 0
        ):
            # fully device-resident setup: upload the fine operator once,
            # then aggregation = index arithmetic, transfers = reshapes,
            # Galerkin = on-device colored probing, rho = on-device power
            # iteration.  No host coarse matrices at all (the host PtAP
            # measured 20 s at 200^3).
            import time as _time2

            from tpusparse.amg.geo import gamg_setup_geo_compiled

            tm0 = {}
            _t0 = _time2.perf_counter()
            if fine_op is not None:
                # caller already uploaded the fine container (e.g. the aij
                # driver aliases it with the two-float outer operator) —
                # zero duplicate transfer
                if dtype is not None and fine_op.dtype != np.dtype(dtype):
                    raise ValueError(
                        f"fine_op dtype {fine_op.dtype} != requested {dtype}"
                    )
                op0 = fine_op
            else:
                # flat DIA: the 3-D grid-view form (sparse/griddia.py) is
                # not production
                op0 = DIA.from_csr(a, max_offsets=max_offsets, dtype=dtype)
            tm0["device_put"] = _time2.perf_counter() - _t0
            _t0 = _time2.perf_counter()
            # single-dispatch setup: the whole device-resident build is one
            # compiled program, not a dispatch per level
            hier = gamg_setup_geo_compiled(op0, tuple(geo_shape), params)
            jax.block_until_ready(hier.levels[-1].rho)
            tm0["hierarchy_build"] = _time2.perf_counter() - _t0
            if timings is not None:
                timings.update(tm0)
            return hier

    def make_op(h: HostCSR):
        if device_format in ("auto", "dia"):
            try:
                return DIA.from_csr(h, max_offsets=max_offsets, dtype=dtype)
            except ValueError:
                if device_format == "dia":
                    raise
        if device_format == "auto":
            # wide-stencil level (e.g. Galerkin coarse op under greedy
            # aggregation): heavy diagonals as bands + thin gather
            # remainder — ~10x less gather volume than full ELL.
            # auto_container enforces the gather-row cap: levels too large
            # to gather get a widened DIA-only fallback (or an informative
            # error) (sparse/dia.py).
            from tpusparse.sparse.dia import GATHER_ROW_CAP, auto_container

            return auto_container(
                h, max_bands=64, dtype=dtype,
                gather_row_cap=(
                    GATHER_ROW_CAP if gather_row_cap is None
                    else gather_row_cap
                ),
            )
        return ELL.from_csr(h, dtype=dtype)
    import time as _time

    # Device-resident banded setup (amg/deviceagg.py): the non-grid twin
    # of the geo compiled path — contiguous-segment aggregation + static
    # segment-banded Galerkin, no host matrix and no gathers anywhere.
    # Taken when explicitly requested ("banded"), or under "auto" when the
    # greedy host path is not viable: no host CSR at all (device-assembled
    # callers), or a fine level too large for the greedy path's in-cycle
    # FactoredTransfer gathers (GATHER_ROW_CAP).
    if aggregation == "banded" and params.bjacobi_bs != 0:
        # An EXPLICIT banded request must not silently reroute to greedy:
        # raise the same incompatibility gamg_setup_banded_device would
        # (block-Jacobi smoothers need per-block host factorization, which
        # the device-resident path deliberately has no access to).  The
        # silent fallback below is reserved for aggregation == "auto".
        raise ValueError(
            "-pc_gamg_aggregation banded is incompatible with block-Jacobi "
            "smoothers (pc_bjacobi_bs != 0): the device-resident setup has "
            "no host factorization path; use jacobi smoothing or the "
            "greedy aggregation"
        )
    if params.bjacobi_bs == 0 and (
        aggregation == "banded"
        or (
            aggregation == "auto"
            and (
                (a is None and fine_op is not None)
                or (a is not None and a.n_rows > GATHER_ROW_CAP_BANDED)
            )
        )
    ):
        cand = fine_op if isinstance(fine_op, DIA) else None
        if cand is None and a is not None:
            try:
                cand = DIA.from_csr(a, max_offsets=max_offsets, dtype=dtype)
            except ValueError:
                if aggregation == "banded":
                    raise
                cand = None  # too many diagonals: fall through to greedy
        if cand is not None:
            from tpusparse.amg.deviceagg import gamg_setup_banded_device

            if dtype is not None and cand.dtype != np.dtype(dtype):
                cand = DIA(
                    bands=cand.bands.astype(np.dtype(dtype)),
                    offsets=cand.offsets, shape=cand.shape,
                )
            tm0: dict = {}
            hier = gamg_setup_banded_device(
                cand, params, timings=tm0, max_offsets=max_offsets
            )
            if timings is not None:
                timings.update(tm0)
            return hier

    if a is None:
        # device-assembled caller (e.g. the aij driver's zero-host-work
        # init): only the device-resident branches above can run — the
        # greedy path's graph passes are host-side by design, and the
        # banded route was refused (bjacobi sub-PC or no DIA fine_op)
        raise ValueError(
            "no host CSR and the sparsity pattern did not resolve to a"
            " device-resident setup (geometric infer_grid3d / banded"
            " segment aggregation); pass the HostCSR for greedy"
            " aggregation"
        )

    tm = {"aggregate": 0.0, "galerkin": 0.0, "rho": 0.0, "device_put": 0.0}

    a_sp = a.to_scipy()
    levels: list[Level] = []
    transfers: list[ELLTransfer | None] = []

    while True:
        n = a_sp.shape[0]
        diag = a_sp.diagonal()
        dinv = 1.0 / diag
        bjac = None
        _t0 = _time.perf_counter()
        if params.bjacobi_bs > 1:
            # real PCBJACOBI smoother sub-PC: invert bs x bs diagonal blocks
            from tpusparse.solve.bjacobi import BlockJacobi

            bjac = BlockJacobi.build(
                HostCSR.from_scipy(a_sp), params.bjacobi_bs, dtype=dtype
            )
            inv_np = np.asarray(
                jax.device_get(bjac.dinv_blocks), np.float64
            )
            nb, bs = inv_np.shape[0], params.bjacobi_bs

            def m_apply(r, inv_np=inv_np, nb=nb, bs=bs, n=n):
                rb = np.pad(r, (0, nb * bs - n)).reshape(nb, bs)
                return np.einsum("kij,kj->ki", inv_np, rb).reshape(-1)[:n]

            # chebyshev bounds must track the actual smoother: rho(M^-1 A);
            # the prolongator smoothing below stays point-Jacobi (GAMG
            # semantics), so its omega keeps rho(D^-1 A)
            rho = _rho_m_a(a_sp, m_apply, params.rho_iters) * params.rho_safety
            rho_point = (
                _rho_dinv_a(a_sp, dinv, params.rho_iters) * params.rho_safety
            )
            op_dev = None
        else:
            # rho(D^-1 A) power iteration ON DEVICE over the level's own
            # container (gather-free DIA mv): the host-scipy version costs
            # 25 single-threaded SpMVs — seconds at 27M rows, the single
            # largest setup item measured at 300^3
            _tp = _time.perf_counter()
            op_dev = make_op(HostCSR.from_scipy(a_sp))
            dt_put = _time.perf_counter() - _tp
            tm["device_put"] += dt_put
            _t0 += dt_put  # container build is charged to device_put, not rho
            from tpusparse.amg.hierarchy import estimate_rho_dinv_a

            dinv_dev = jnp.asarray(dinv, op_dev.dtype)
            rho = float(
                estimate_rho_dinv_a(op_dev, dinv_dev, params.rho_iters)
            ) * params.rho_safety
            rho_point = rho
        tm["rho"] += _time.perf_counter() - _t0
        last = n <= params.coarse_eq_limit or len(levels) + 1 >= params.max_levels
        if not last:
            _t0 = _time.perf_counter()
            next_geo = bs = None
            if geo_shape is not None:
                # geometric index-block aggregation (grid-shaped pattern):
                # no graph walk, and the transfers become pure reshapes
                from tpusparse.amg.geo import (
                    coarse_dims,
                    geo_aggregate_ids,
                    geo_block_sizes,
                )

                bs = geo_block_sizes(geo_shape, params.factor)
                agg = geo_aggregate_ids(geo_shape, bs)
                next_geo = coarse_dims(geo_shape, bs)
            else:
                agg = greedy_aggregate(
                    HostCSR.from_scipy(a_sp), params.threshold
                )
            if geo_shape is None and len(levels) < params.aggressive_coarsening:
                # PETSc -pc_gamg_aggressive_coarsening: square the
                # aggregation by greedily aggregating the tentative coarse
                # graph and composing the two maps
                from tpusparse import native

                t0 = tentative_prolongator(agg)
                if native.available():
                    coarse_graph = native.ptap(
                        HostCSR.from_scipy(t0.tocsr()),
                        HostCSR.from_scipy(a_sp),
                    ).to_scipy()
                else:
                    coarse_graph = (t0.T @ (a_sp @ t0)).tocsr()
                agg2 = greedy_aggregate(
                    HostCSR.from_scipy(coarse_graph), params.threshold
                )
                agg = agg2[agg]
            if agg.max() + 1 >= n:  # aggregation stalled
                last = True
            tm["aggregate"] += _time.perf_counter() - _t0
        if op_dev is None:  # bjacobi branch built no container yet
            _t0 = _time.perf_counter()
            op_dev = make_op(HostCSR.from_scipy(a_sp))
            tm["device_put"] += _time.perf_counter() - _t0
        lev_common = dict(
            op=op_dev,
            dinv=jnp.asarray(dinv, op_dev.dtype),
            rho=jnp.asarray(rho, op_dev.dtype),
            bjac=bjac,
        )
        if last:
            from tpusparse.amg.hierarchy import dense_coarse_inverse

            levels.append(Level(
                transfer=None,
                coarse_inv=(
                    dense_coarse_inverse(op_dev)
                    if params.coarse_solve == "lu" else None
                ),
                **lev_common,
            ))
            break
        t = tentative_prolongator(agg)
        omega = (
            params.omega_scale / rho_point if params.nsmooths >= 1 else 0.0
        )
        _t0 = _time.perf_counter()
        # P = (I - omega D^-1 A)^k T — k = nsmooths applications of the
        # same damped-Jacobi smoothing factor (PETSc GAMG semantics); the
        # Galerkin product below consumes this same explicit P, so the
        # coarse operators stay exactly consistent with the transfers
        p = t
        dmat = sp.diags(dinv)
        for _ in range(params.nsmooths):
            p = (p - omega * dmat @ (a_sp @ p)).tocsr()
        tm["galerkin"] += _time.perf_counter() - _t0
        if (
            geo_shape is not None and transfer_format == "auto"
            and params.nsmooths <= 1
        ):
            # geometric aggregation's native transfer: pure reshapes.  An
            # EXPLICIT transfer_format request still wins below (the math
            # is identical — geo agg ids work in any container).
            from tpusparse.amg.geo import GeoTransfer

            sizes = np.bincount(
                agg, minlength=int(agg.max()) + 1
            ).astype(np.float64)
            transfer = GeoTransfer.build(
                w=jnp.asarray(
                    1.0 / np.sqrt(sizes[agg]), lev_common["dinv"].dtype
                ),
                omega=jnp.asarray(omega, lev_common["dinv"].dtype),
                fine_shape=geo_shape,
                bs=bs,
            )
        elif factored:
            n_c = int(agg.max()) + 1
            sizes = np.bincount(agg, minlength=n_c).astype(np.float64)
            transfer = FactoredTransfer(
                agg=jnp.asarray(agg, jnp.int32),
                w=jnp.asarray(
                    1.0 / np.sqrt(sizes[agg]), lev_common["dinv"].dtype
                ),
                omega=jnp.asarray(omega, lev_common["dinv"].dtype),
                n_coarse=n_c,
                nsmooths=params.nsmooths,
            )
        else:
            transfer = ELLTransfer(
                p=ELL.from_csr(HostCSR.from_scipy(p), dtype=dtype),
                r=ELL.from_csr(HostCSR.from_scipy(p.T.tocsr()), dtype=dtype),
            )
        if geo_shape is not None:
            geo_shape = next_geo  # Galerkin coarse op inherits 3-D lex
        levels.append(Level(transfer=transfer, **lev_common))
        # Galerkin triple product (PETSc MatPtAP parity): native C++ SpGEMM
        # when built (tpusparse/native), scipy otherwise
        from tpusparse import native

        _t0 = _time.perf_counter()
        if native.available():
            ac = native.ptap(HostCSR.from_scipy(p), HostCSR.from_scipy(a_sp)).to_scipy()
        else:
            ac = (p.T @ (a_sp @ p)).tocsr()
        ac.sum_duplicates()
        ac.eliminate_zeros()
        a_sp = ac
        tm["galerkin"] += _time.perf_counter() - _t0

    if timings is not None:
        timings.update(tm)
    lead = levels[0].dinv.dtype
    return Hierarchy(
        levels=levels,
        damping=jnp.asarray(params.smooth_damping, lead),
        smoother=params.smoother,
        degree=params.degree,
        cheby_lo=params.cheby_lo,
        cheby_hi=params.cheby_hi,
        level_spec=params.level_spec,
    )
