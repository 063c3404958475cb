"""GAMG-style AMG hierarchy: setup + V-cycle apply.

Parity target (``configs/PETSc_SolverOptions_GAMG.info:6-21``):
smoothed aggregation (``agg``), one prolongator-smoothing pass
(``nsmooths 1``), threshold 0.0, level smoother Richardson(1) with
(block-)Jacobi, coarse solve preonly + (block-)Jacobi.  With one process per
block, bjacobi+jacobi degenerates to plain Jacobi — the same degeneracy the
reference hits on one rank.

The V-cycle is built from matrix-free structured transfers
(``transfer.py``) over stencil operators (``stencil.py``/``varstencil.py``):
a full application is nothing but elementwise passes and reshapes — no
gathers, no scalar loops — and the whole hierarchy is one pytree, so
``cg(..., m_mv=lambda r: vcycle(hier, r))`` jits into a single XLA program.
Level count is static at trace time (Python recursion unrolls).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpusparse.amg.galerkin import galerkin_coarse
from tpusparse.amg.transfer import StructuredTransfer, coarse_shape
from tpusparse.sparse.stencil import StarStencil3D
from tpusparse.sparse.varstencil import VarStencil27


@dataclasses.dataclass(frozen=True)
class AMGParams:
    """Setup knobs, named after their GAMG counterparts where they exist."""

    nsmooths: int = 1            # -pc_gamg_agg_nsmooths (structured path:
    # 0/1 — the probed coarse container bounds P's reach; greedy/aij path:
    # any k >= 0 via explicit transfers)
    threshold: float = 0.0       # -pc_gamg_threshold (0.0 = keep all, parity)
    coarse_eq_limit: int = 200   # stop coarsening below this many unknowns
    max_levels: int = 30
    factor: int = 3              # geometric aggregation block edge
    omega_scale: float = 4.0 / 3.0   # omega = omega_scale / rho(D^-1 A)
    rho_iters: int = 25          # power-iteration steps for rho(D^-1 A)
    rho_safety: float = 1.05     # inflate the estimate (underdamping is worse)
    # level smoother: "chebyshev" (PETSc GAMG's own default, fastest) or
    # "richardson" (the reference config's explicit choice, parity mode)
    smoother: str = "chebyshev"
    degree: int = 2              # chebyshev degree / richardson sweep count
    # per-level smoother overrides (-mg_levels_<N>_ksp_type /
    # -mg_levels_<N>_ksp_max_it): ((level, smoother|"", degree|0), ...)
    level_spec: tuple = ()
    smooth_damping: float = 1.0  # Richardson scale (PETSc default 1.0)
    cheby_lo: float = 0.1        # chebyshev target range [lo,hi]*rho(D^-1 A)
    cheby_hi: float = 1.05
    # real block-Jacobi smoother sub-PC (-mg_levels_pc_type bjacobi with
    # bs x bs blocks, PCBJACOBI beyond the 1-block point degeneracy).
    # 0 = point Jacobi.  Structured path: blocks assembled on device from
    # the stencil legs (bs = nx -> x-line relaxation); unstructured path:
    # blocks from the assembled CSR.
    bjacobi_bs: int = 0
    # PETSc -pc_gamg_aggressive_coarsening parity (unstructured path):
    # compose TWO greedy aggregation rounds on the first N levels.  Greedy
    # Vanek aggregation over a 7-point graph only coarsens ~8x, leaving a
    # large, wide level 1 whose gather-heavy applies dominate V-cycle
    # cost; squaring the aggregation there mirrors PETSc's default and
    # coarsens ~50-60x.  (The structured path's geometric 3^3 aggregation
    # is unaffected.)
    aggressive_coarsening: int = 1
    # coarsest-level solve: "jacobi" (preonly + (block-)Jacobi — the
    # reference config's own choice, configs/…GAMG.info:10-21) or "lu"
    # (-mg_coarse_pc_type lu: dense direct solve — PETSc GAMG's default
    # coarse PC is a direct factorization; here the coarsest operator is
    # materialized by one vmapped apply over the identity basis and
    # inverted once at setup, applied as a dense product per cycle)
    coarse_solve: str = "jacobi"


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["op", "dinv", "rho", "transfer", "bjac", "coarse_inv"],
    meta_fields=[],
)
@dataclasses.dataclass
class Level:
    op: StarStencil3D | VarStencil27
    dinv: jax.Array                      # 1 / diag, field view
    rho: jax.Array                       # rho(M^{-1} A) estimate (scalar)
    transfer: StructuredTransfer | None  # None on the coarsest level
    bjac: object | None = None           # BlockJacobi smoother sub-PC
    # (None = point Jacobi; set by the unstructured setup when
    # AMGParams.bjacobi_bs > 0)
    coarse_inv: jax.Array | None = None  # dense inverse of the coarsest
    # operator (AMGParams.coarse_solve == "lu"; None everywhere else)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["levels", "damping"],
    meta_fields=["smoother", "degree", "cheby_lo", "cheby_hi",
                 "level_spec"],
)
@dataclasses.dataclass
class Hierarchy:
    levels: list[Level]
    damping: jax.Array  # Richardson smoother scale
    smoother: str = "chebyshev"
    degree: int = 2
    cheby_lo: float = 0.1
    cheby_hi: float = 1.05
    # per-level smoother overrides (-mg_levels_<N>_ksp_type /
    # -mg_levels_<N>_ksp_max_it — PETSc PCMGGetSmoother-level
    # configuration): tuple of (level, smoother|"", degree|0) triples;
    # "" / 0 keep the hierarchy-wide value for that slot.
    level_spec: tuple = ()

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level_cfg(self, level: int) -> tuple[str, int]:
        """(smoother, degree) effective at ``level``."""
        for lv, sm, dg in self.level_spec:
            if lv == level:
                return (sm or self.smoother, dg or self.degree)
        return self.smoother, self.degree


@partial(jax.jit, static_argnames=("iters",))
def estimate_rho_dinv_a(op, dinv, iters: int = 25, m_pc=None) -> jax.Array:
    """Power iteration for rho(D^{-1} A) (positive spectrum: A and D share
    sign).  Deterministic start vector; a handful of stencil applies.

    ``m_pc``: replace the point-Jacobi D^{-1} with an arbitrary SPD
    preconditioner carried as a pytree exposing ``.apply`` (e.g.
    BlockJacobi) — the estimate becomes rho(M^{-1} A), which is what the
    chebyshev smoother bounds need when the level smoother's sub-PC is not
    point Jacobi.

    Jitted with the operator as an argument (never a closure constant — see
    driver.py note on literal bloat)."""
    shape = tuple(dinv.shape)
    n = int(np.prod(shape))
    # deterministic, non-smooth start (avoid the near-null constant vector).
    # The estimate is load-bearing: a ~1% change in it perturbs omega, which
    # compounds through the Galerkin levels into the coarsest operator.
    v = jnp.sin(jnp.arange(n, dtype=dinv.dtype) * 0.7 + 0.3).reshape(shape)

    pc = (lambda r: dinv * r) if m_pc is None else m_pc.apply

    def body(_, v):
        w = pc(op.mv(v))
        return w / jnp.sqrt(jnp.vdot(w, w))

    v = jax.lax.fori_loop(0, iters, body, v / jnp.sqrt(jnp.vdot(v, v)))
    w = pc(op.mv(v))
    return jnp.vdot(v, w)  # Rayleigh quotient (v normalized)


# dense coarse inverse guard: 4096 unknowns = 128 MB f64 for eye+inverse
# — generous for any real coarsest level (coarse_eq_limit defaults to 200)
DENSE_COARSE_CAP = 4096


def dense_coarse_inverse(op) -> jax.Array:
    """Materialize a (small) operator densely and invert it —
    the ``-mg_coarse_pc_type lu`` coarse solve.

    One vmapped apply over the identity basis gives all n columns in a
    single batched program (n <= coarse_eq_limit keeps it trivial); the
    inverse is computed once at setup and applied as a dense product per
    cycle.
    """
    n_guard = (
        int(np.prod(op.grid_shape))
        if getattr(op, "grid_shape", None) is not None else op.shape[0]
    )
    if n_guard > DENSE_COARSE_CAP:
        # the coarsest level is NOT always <= coarse_eq_limit: max_levels
        # caps and stalled aggregation can leave a large "coarsest" grid,
        # where jnp.eye(n) + inv would be tens of GB — fail with the
        # cause instead of OOM-ing the device
        raise ValueError(
            f"coarse_solve='lu': coarsest level has {n_guard} unknowns"
            f" (> {DENSE_COARSE_CAP} dense-inverse cap) — the hierarchy"
            " stopped early (max_levels / stalled coarsening); use the"
            " jacobi coarse solve or let coarsening continue"
        )
    gs = getattr(op, "grid_shape", None)
    if gs is not None:
        n = int(np.prod(gs))
        eye = jnp.eye(n, dtype=op.dtype).reshape((n, *gs))
        cols = jax.vmap(op.mv)(eye).reshape(n, n)
    else:
        n = op.shape[0]
        eye = jnp.eye(n, dtype=op.dtype)
        cols = jax.vmap(op.mv)(eye)
    dense = cols.T  # row i of the vmap output is A @ e_i
    # invert in f64 when available: the coarsest Galerkin operator's
    # conditioning grows with the number of triple products above it, and
    # an f32 LU of a borderline matrix can emit inf/NaN entries that poison
    # every V-cycle (observed as DIVERGED_NANORINF at 300^3 with
    # coarse_solve='lu').  One-time setup cost on a <= coarse_eq_limit
    # matrix.
    if jax.config.jax_enable_x64 and dense.dtype != jnp.float64:
        return jnp.linalg.inv(dense.astype(jnp.float64)).astype(dense.dtype)
    return jnp.linalg.inv(dense)


def _coarse_direct(lev: Level, b: jax.Array) -> jax.Array:
    """Apply the dense coarse inverse (field or flat view) at full
    precision (a float32 product may otherwise run in TF32 on a GPU)."""
    x = jnp.matmul(
        lev.coarse_inv, b.reshape(-1).astype(lev.coarse_inv.dtype),
        precision=jax.lax.Precision.HIGHEST,
    ).astype(b.dtype)
    return x.reshape(b.shape)


def axis_strengths(op) -> tuple[float, float, float]:
    """PETSc-style coupling strengths per grid axis: mean |face leg| over
    mean diagonal for (z, y, x).  One tiny fetch; used by
    ``threshold_schedule`` to decide which axes -pc_gamg_threshold keeps."""
    from tpusparse.sparse.varstencil import OFFSETS, VarStencil27

    dmean = float(jnp.mean(jnp.abs(op.diagonal_field())))
    if isinstance(op, VarStencil27):
        def leg(off):
            return float(jnp.mean(jnp.abs(op.coef[OFFSETS.index(off)])))

        legs = (
            0.5 * (leg((1, 0, 0)) + leg((-1, 0, 0))),
            0.5 * (leg((0, 1, 0)) + leg((0, -1, 0))),
            0.5 * (leg((0, 0, 1)) + leg((0, 0, -1))),
        )
    else:  # StarStencil3D / PaddedStar: constant per-axis legs
        legs = (
            abs(float(op.cz)), abs(float(op.cy)), abs(float(op.cx))
        )
    return tuple(v / dmean for v in legs)


def threshold_schedule(
    fine_op, threshold: float, factor: int = 3, max_levels: int = 30
) -> tuple[tuple[int, int, int], ...] | None:
    """Static per-level per-axis coarsening factors under
    ``-pc_gamg_threshold`` (configs/PETSc_SolverOptions_GAMG.info:8).

    GAMG drops couplings with |a_ij| <= theta*sqrt(a_ii a_jj) from the
    strength graph, so anisotropic operators semicoarsen along strong
    axes.  The structured equivalent: measure the FINE level's per-axis
    strengths once (eager, one tiny fetch), then advance them
    analytically — coarsening an axis by ``factor`` scales its coupling
    by 1/factor^2 relative to uncoarsened axes (h^2 scaling) — producing
    a STATIC schedule the one-dispatch compiled setup can bake in.
    Returns None when no axis is ever dropped (isotropic: zero overhead,
    identical hierarchy to the threshold-0 build)."""
    if threshold <= 0.0:
        return None
    # track per-axis LEG magnitudes (common scale cancels); the PETSc drop
    # test compares leg/diag against theta, and diag = 2*sum(legs) for the
    # zero-row-sum operators this path serves
    legs = list(axis_strengths(fine_op))
    sched: list[tuple[int, int, int]] = []
    dropped_any = False
    for _ in range(max_levels):
        diag = 2.0 * sum(legs)
        keep = [v / diag > threshold for v in legs]
        if not any(keep):
            keep = [v == max(legs) for v in legs]
        f = tuple(int(factor) if k else 1 for k in keep)
        sched.append(f)
        dropped_any |= not all(keep)
        if all(keep):
            break  # isotropic from here on: schedule tail repeats
        legs = [
            v / (factor * factor) if k else v
            for v, k in zip(legs, keep)
        ]
    return tuple(sched) if dropped_any else None


def _filtered_op(op, factors):
    """The P-smoothing operator with dropped-axis legs zeroed (axes with
    factor 1 under the threshold schedule).  Keeps A_c within the
    27-point container: an uncoarsened axis with live smoothing legs
    would give the Galerkin product radius ceil(3/1) = 3 there, silently
    corrupting the probed coefficients."""
    import dataclasses as _dc

    from tpusparse.sparse.varstencil import OFFSETS, VarStencil27

    drop = [f == 1 for f in factors]
    if not any(drop):
        return None
    if isinstance(op, VarStencil27):
        mask = jnp.asarray(
            [
                0.0 if any(d and o != 0 for d, o in zip(drop, off))
                else 1.0
                for off in OFFSETS
            ],
            op.coef.dtype,
        )
        return VarStencil27(coef=op.coef * mask[:, None, None, None])
    # StarStencil3D: constant per-axis legs -> zero the dropped scalars
    rep = {}
    for name, d in zip(("cz", "cy", "cx"), drop):
        if d:
            rep[name] = jnp.zeros((), getattr(op, name).dtype)
    return _dc.replace(op, **rep)


def gamg_setup(
    fine_op, params: AMGParams = AMGParams(), timings: dict | None = None,
    factors_schedule: tuple | None = None,
) -> Hierarchy:
    """Build the AMG hierarchy from the fine operator.

    Runs eagerly (once per matrix — KSPSetUp parity); every product is
    computed on device via probing, nothing leaves HBM.  ``timings``
    receives a {"rho": s, "galerkin": s} sub-phase breakdown when passed.
    """
    import time as _time

    if params.nsmooths not in (0, 1):
        raise ValueError(
            "the structured path supports nsmooths in {0, 1}: a twice-"
            "smoothed prolongator reaches past the probed 27-point coarse "
            "container; use -mat_type aij -pc_gamg_aggregation greedy, "
            "whose explicit transfers support any -pc_gamg_agg_nsmooths"
        )
    if params.smoother not in ("richardson", "chebyshev", "sor"):
        raise ValueError(f"unknown smoother {params.smoother!r}")
    if params.smoother == "sor":
        if not hasattr(fine_op, "gs_color_masks"):
            raise ValueError(
                f"smoother='sor' needs a colorable grid operator"
                f" (gs_color_masks); {type(fine_op).__name__} has none —"
                " use chebyshev/richardson or the structured plain layout"
            )
        if params.bjacobi_bs:
            raise ValueError(
                "smoother='sor' IS the sub-PC (GS sweeps); it composes"
                " with point relaxation only — drop bjacobi_bs"
            )
    if params.bjacobi_bs and not hasattr(fine_op, "flat_band_fields"):
        raise ValueError(
            f"bjacobi_bs: operator {type(fine_op).__name__} exposes no"
            " x-band accessor — use the unstructured path"
        )
    if params.coarse_solve not in ("jacobi", "lu"):
        raise ValueError(f"unknown coarse_solve {params.coarse_solve!r}")
    coarse_lu = params.coarse_solve == "lu"

    fine_gx = fine_op.grid_shape[2]

    def _bjac(op_l, dinv_l):
        # real PCBJACOBI on the structured path (-mg_levels_pc_type
        # bjacobi beyond the one-block degeneracy): each bs x bs natural-
        # ordering diagonal block assembled exactly from the stencil legs
        # that land inside it and batch-inverted on device — with bs = nx
        # this is x-LINE block relaxation, the textbook smoother for
        # x-anisotropic operators
        if not params.bjacobi_bs:
            return None
        from tpusparse.solve.bjacobi import BlockJacobi

        bs = params.bjacobi_bs
        if bs == fine_gx:
            # x-line mode: line relaxation coarsens WITH the grid — each
            # level smooths its own x-lines (bs = this level's nx), the
            # textbook multilevel line smoother.  Only the +-1 offsets
            # couple within a line: any other |o| < bs (e.g. the 27-point
            # +-(nx-1)/+-(nx+1) wrap diagonals) overlaps a line block only
            # at rows where leg masking zeroes the band, so dropping them
            # is exact — and it lets the tridiagonal PCR route recognize
            # the structure at any size (dense line blocks at 300^3 would
            # be ~32 GB).
            bs = op_l.grid_shape[2]
            bands = {
                o: f for o, f in op_l.flat_band_fields(bs).items()
                if abs(o) == 1
            }
        else:
            bands = op_l.flat_band_fields(bs)
        return BlockJacobi.from_bands(op_l.diagonal_field(), bands, bs)

    tm = {"rho": 0.0, "galerkin": 0.0}
    levels: list[Level] = []
    op = fine_op
    while True:
        diag = op.diagonal_field()
        dinv = 1.0 / diag
        shape = op.grid_shape
        n = int(np.prod(shape))
        last = (
            n <= params.coarse_eq_limit
            or len(levels) + 1 >= params.max_levels
            or min(shape) < 2
        )
        _t0 = _time.perf_counter()
        rho = estimate_rho_dinv_a(
            op, dinv, params.rho_iters,
        ) * params.rho_safety
        if timings is not None:  # sync only when instrumenting
            # (gamg_setup_compiled traces this whole function, where
            # syncing would be meaningless)
            jax.block_until_ready(rho)
        tm["rho"] += _time.perf_counter() - _t0
        bjac = _bjac(op, dinv)
        if bjac is not None and not last:
            # the chebyshev smoother bounds need the spectrum the smoother
            # actually sees: rho(M_block^-1 A).  omega below stays D^-1-
            # based (PETSc smooths the prolongator with point Jacobi
            # regardless of the level smoother's sub-PC).  The coarsest
            # level skips this: its solve is preonly(bjac) and Level.rho
            # is never consumed there.
            _t0 = _time.perf_counter()
            rho_lev = estimate_rho_dinv_a(
                op, dinv, params.rho_iters, m_pc=bjac,
            ) * params.rho_safety
            if timings is not None:
                jax.block_until_ready(rho_lev)
            tm["rho"] += _time.perf_counter() - _t0
        else:
            rho_lev = rho
        if last:
            levels.append(Level(
                op=op, dinv=dinv, rho=rho_lev, transfer=None, bjac=bjac,
                coarse_inv=dense_coarse_inverse(op) if coarse_lu else None,
            ))
            break
        omega = (
            params.omega_scale / rho
            if params.nsmooths == 1
            else jnp.zeros((), dinv.dtype)
        )
        f_lvl = params.factor
        fop = None
        if factors_schedule is not None:
            f_lvl = factors_schedule[
                min(len(levels), len(factors_schedule) - 1)
            ]
            fop = _filtered_op(op, f_lvl)
        transfer = StructuredTransfer.build(
            shape, omega, dinv.dtype, f_lvl, fop=fop
        )
        levels.append(Level(
            op=op, dinv=dinv, rho=rho_lev, transfer=transfer, bjac=bjac,
        ))
        _t0 = _time.perf_counter()
        op = galerkin_coarse(op, dinv, transfer)
        if timings is not None:
            jax.block_until_ready(jax.tree.leaves(op)[0])
        tm["galerkin"] += _time.perf_counter() - _t0
    if timings is not None:
        timings.update(tm)
    return Hierarchy(
        levels=levels,
        damping=jnp.asarray(params.smooth_damping, levels[0].dinv.dtype),
        smoother=params.smoother,
        degree=params.degree,
        cheby_lo=params.cheby_lo,
        cheby_hi=params.cheby_hi,
        level_spec=params.level_spec,
    )


@partial(jax.jit, static_argnames=("params", "factors_schedule"))
def gamg_setup_compiled(
    fine_op, params: AMGParams = AMGParams(),
    factors_schedule: tuple | None = None,
):
    """ONE-dispatch hierarchy build: the whole setup loop (rho power
    iterations, Galerkin probing, transfer builds, every level) traced
    into a single XLA program.

    Why: ``gamg_setup`` run eagerly issues 2+ device dispatches per level
    plus syncs; as one compiled program the same work is a single
    dispatch.  The program is compile-cached per (shape, params).

    ``factors_schedule``: static per-level per-axis coarsening factors
    from ``threshold_schedule`` (computed EAGERLY by the caller — the
    strength fetch cannot run under trace)."""
    return gamg_setup(fine_op, params, factors_schedule=factors_schedule)


def hierarchy_summary(hier: Hierarchy) -> str:
    """PETSc ``-ksp_view``-style description of the PC hierarchy (PCView
    parity: PETSc prints the MG level structure, smoother and coarse-solve
    configuration when ``-ksp_view`` is set)."""
    import numpy as np_

    lines = [
        f"PC Object: type gamg (smoothed aggregation), {hier.n_levels} levels",
        f"  cycle: V (W selectable), smoother: {hier.smoother}"
        f" (degree {hier.degree}, damping {float(hier.damping):g})",
    ]
    for i, lev in enumerate(hier.levels):
        shape = getattr(lev.op, "grid_shape", None)
        n = (
            int(np_.prod(shape)) if shape is not None
            else lev.op.shape[0]
        )
        kind = type(lev.op).__name__
        extra = "" if lev.transfer is not None else \
            ", coarse solve: preonly + " + (
                "lu (dense direct)" if lev.coarse_inv is not None
                else "bjacobi" if lev.bjac is not None else "jacobi"
            )
        lines.append(
            f"  level {i}: {n} unknowns, operator {kind},"
            f" rho(M^-1 A) ~= {float(lev.rho):.4f}{extra}"
        )
    return "\n".join(lines)


def cast_coarse_coefs(hier: Hierarchy, dtype=jnp.bfloat16) -> Hierarchy:
    """Cast ONLY the coarse-level operator coefficient stacks (levels >= 1).

    Unlike ``cast_hierarchy`` (which round 1 measured costing ~2.5x the
    iterations at 300^3 because the coarse-grid CORRECTION vectors lost
    mantissa), this keeps every vector, diagonal and transfer in the build
    dtype and halves only the operator-DATA traffic — which dominates
    coarse-level cost (a 27-point level reads 27 coefficient fields per
    apply).  No entry point uses it; whether it pays on the GPU is not
    measured yet."""
    new = [hier.levels[0]]
    for lev in hier.levels[1:]:
        op = lev.op
        if hasattr(op, "coef"):
            op = dataclasses.replace(op, coef=op.coef.astype(dtype))
        new.append(dataclasses.replace(lev, op=op))
    return dataclasses.replace(hier, levels=new)


def cast_hierarchy(hier: Hierarchy, dtype) -> Hierarchy:
    """Cast every float field of the hierarchy to ``dtype``.

    The V-cycle is an *approximate* inverse, so it tolerates low precision:
    a bf16 hierarchy halves every byte the preconditioner moves, at the
    cost of more CG iterations as conditioning grows.  Setup (rho
    estimation, Galerkin probing) stays in the build dtype; only the stored
    operators/fields are cast.
    """
    return jax.tree.map(
        lambda v: v.astype(dtype)
        if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating)
        else v,
        hier,
    )


def _smooth(
    hier: Hierarchy, lev: Level, b: jax.Array, x: jax.Array | None,
    reverse: bool = False, level: int = 0,
):
    """Apply the level smoother to A x = b starting from x (None = zero).

    richardson: x += damping * M^{-1} (b - A x), ``degree`` sweeps
    (``-mg_levels_ksp_type richardson`` parity, scale = damping).
    chebyshev: degree-k Chebyshev polynomial in M^{-1} A targeting
    [cheby_lo, cheby_hi] * rho — PETSc KSPChebyshev equivalent, and GAMG's
    own default smoother.  M^{-1} is point Jacobi (``lev.dinv``) or real
    block-Jacobi when ``lev.bjac`` is set (``-mg_levels_pc_type bjacobi``
    beyond the one-block degeneracy).
    sor: multicolor Gauss-Seidel sweeps (PCSOR parity in its standard
    parallel-machine form): within one color no two points couple
    (``gs_color_masks``), so a masked simultaneous update is a GS
    ordering; ``reverse`` runs the colors backwards — the post-smooth in
    ``vcycle`` uses it so pre/post are transposes of each other (SSOR
    pairing) and the cycle stays a symmetric CG preconditioner.
    """
    smoother, degree = hier.level_cfg(level)
    if smoother == "sor":
        # COST NOTE: one full mv per color per sweep — 2 mvs on star
        # levels but 8 on 27-point Galerkin coarse levels (vs chebyshev's
        # 1 mv per degree).  Coarse grids are 27x+ smaller so the cycle
        # stays fine-level-dominated, but sor is measurably heavier than
        # chebyshev per sweep; a per-level smoother choice (sor fine,
        # chebyshev coarse) would stay symmetric and is the upgrade path
        # if sor becomes a production config.
        masks = lev.op.gs_color_masks()
        if reverse:
            masks = masks[::-1]
        omega = hier.damping
        for _ in range(degree):
            for m in masks:
                if x is None:
                    x = jnp.where(m, omega * lev.dinv * b,
                                  jnp.zeros_like(b))
                else:
                    x = jnp.where(
                        m, x + omega * lev.dinv * (b - lev.op.mv(x)), x
                    )
        return x
    if lev.bjac is not None:
        pc = lev.bjac.apply
    else:
        pc = lambda r: lev.dinv * r
    if smoother == "richardson":
        for _ in range(degree):
            if x is None:
                x = hier.damping * pc(b)
            else:
                x = x + hier.damping * pc(b - lev.op.mv(x))
        return x

    # chebyshev
    lo = hier.cheby_lo * lev.rho
    hi = hier.cheby_hi * lev.rho
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho_c = 1.0 / sigma
    r = b if x is None else b - lev.op.mv(x)
    d = pc(r) / theta
    x = d if x is None else x + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho_c)
        r = b - lev.op.mv(x)
        d = rho_new * rho_c * d + (2.0 * rho_new / delta) * pc(r)
        x = x + d
        rho_c = rho_new
    return x


def vcycle(
    hier: Hierarchy, b: jax.Array, level: int = 0, gamma: int = 1
) -> jax.Array:
    """One multigrid cycle solving A_l e = b from a zero initial guess.

    ``gamma`` is the cycle index (PETSc ``-pc_mg_cycle_type``): 1 = V-cycle
    (default), 2 = W-cycle (the coarse problem is visited twice per level —
    stronger per application, ~2x the coarse-level work).  Smoother per
    ``hier.smoother`` (chebyshev default; richardson+Jacobi =
    reference-config parity); coarse solve: preonly + Jacobi
    (``configs/PETSc_SolverOptions_GAMG.info:10-21``).  Symmetric — the
    post-smoother is the ADJOINT of the pre-smoother (richardson/
    chebyshev with a symmetric sub-PC are self-adjoint; sor reverses its
    color order on the post sweep) — so the cycle is a valid CG
    preconditioner.  Any new smoother must preserve that pairing.
    """
    lev = hier.levels[level]
    if lev.transfer is None:
        if lev.coarse_inv is not None:
            # preonly + lu: exact dense solve (one dense product)
            return _coarse_direct(lev, b)
        # preonly + (block-)jacobi coarse solve
        if lev.bjac is not None:
            return lev.bjac.apply(b)
        return lev.dinv * b
    x = _smooth(hier, lev, b, None, level=level)
    r = b - lev.op.mv(x)
    e_c = lev.transfer.restrict(lev.op, lev.dinv, r)
    e = vcycle(hier, e_c, level + 1, gamma)
    for _ in range(gamma - 1):
        # W-cycle: re-enter the coarse hierarchy on the updated residual
        r_c = e_c - _coarse_mv(hier, level + 1, e)
        e = e + vcycle(hier, r_c, level + 1, gamma)
    x = x + lev.transfer.prolong(lev.op, lev.dinv, e)
    return _smooth(hier, lev, b, x, reverse=True, level=level)


def fmg(hier: Hierarchy, b: jax.Array, n_v: int = 1) -> jax.Array:
    """Full-multigrid pass (FMG / nested iteration — PETSc
    ``-pc_mg_type full``'s cycle shape): restrict the right-hand side
    through the hierarchy, solve the coarsest problem, then at each finer
    level interpolate the coarse solution up and apply ``n_v`` V-cycles.

    MEASURED HONESTY (CPU, 48^3/96^3 Poisson): with smoothed-AGGREGATION
    transfers the interpolation order is too low for the textbook
    "FMG = discretization accuracy in one pass" result — one pass lands
    at ~0.25 relative residual (~ one V-cycle's worth), so using it as a
    warm start for the rtol-1e-8 defect correction saves ~1 CG iteration
    while costing ~n_v cycles: a wash, and NOT wired into the production
    driver (results/README.md exploration record).  Kept as the
    nested-iteration capability for geometric-quality transfer hierarchies
    and PCMG-full parity experiments.
    """
    bs = [b]
    for lev in hier.levels[:-1]:
        bs.append(lev.transfer.restrict(lev.op, lev.dinv, bs[-1]))
    lev_c = hier.levels[-1]
    x = (
        _coarse_direct(lev_c, bs[-1]) if lev_c.coarse_inv is not None
        else lev_c.bjac.apply(bs[-1]) if lev_c.bjac is not None
        else lev_c.dinv * bs[-1]
    )
    for l in range(len(hier.levels) - 2, -1, -1):
        lev = hier.levels[l]
        x = lev.transfer.prolong(lev.op, lev.dinv, x)
        for _ in range(n_v):
            x = x + vcycle(hier, bs[l] - lev.op.mv(x), level=l)
    return x


def _coarse_mv(hier: Hierarchy, level: int, x: jax.Array) -> jax.Array:
    return hier.levels[level].op.mv(x)


def wcycle(hier: Hierarchy, b: jax.Array) -> jax.Array:
    """W-cycle preconditioner application (``-pc_mg_cycle_type w``)."""
    return vcycle(hier, b, gamma=2)
