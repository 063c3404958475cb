"""KSP — the PETSc-style reusable solver object.

The reference's driver is seven API calls (``src/main_ksp.cpp:92-117``):
``KSPCreate``, ``KSPSetOperators(A, A)``, ``KSPSetType(KSPCG)``,
``KSPSetReusePreconditioner(PETSC_TRUE)``, ``KSPSetFromOptions``,
``KSPSetUp``, ``KSPSolve`` — then ``KSPGetIterationNumber`` /
``KSPGetResidualNorm`` / ``KSPGetConvergedReason``.  ``KSP`` is that
object for tpusparse: construct once (optionally from an ``Options``),
attach an operator, and call ``solve(b)`` as many times as you like.
The AMG hierarchy built by ``setup()`` and the compiled solve program
are REUSED across right-hand sides and — with
``reuse_preconditioner=True``, the reference's own setting
(``main_ksp.cpp:95``) — across operator swaps, which is precisely what
``KSPSetReusePreconditioner`` buys PETSc users: pay KSPSetUp once and
amortize it over every subsequent solve.

The heavy lifting lives in the same modules the benchmark driver uses —
``amg.hierarchy.gamg_setup_compiled`` (structured stencil operators),
``amg.unstructured.gamg_setup_unstructured`` (general matrices),
``solve.refine.cg_refined`` (mixed-precision defect correction) — so the
object API and the CLI driver cannot drift apart numerically.

Example::

    from tpusparse import KSP
    from tpusparse.grid import Grid3D
    from tpusparse.grid.poisson import poisson_stencil_device

    op, b, exact = poisson_stencil_device(Grid3D(96, 96, 96))
    ksp = KSP(rtol=1e-8)              # CG + GAMG, mixed precision
    ksp.set_operators(op)
    x = ksp.solve(b).x                # KSPSetUp happens here, once
    x2 = ksp.solve(2.0 * b).x         # reuses hierarchy AND program
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["KSP", "KSPResult"]


@dataclasses.dataclass
class KSPResult:
    """What ``KSPSolve`` leaves behind (the Get* accessors' data)."""

    x: jax.Array
    iters: int           # KSPGetIterationNumber
    resnorm: float       # KSPGetResidualNorm
    reason: int          # KSPGetConvergedReason (PETSc numbering)
    outer_iters: int = 0  # defect-correction sweeps (mixed precision only)

    @property
    def converged(self) -> bool:
        return self.reason > 0


def _op_kind(op) -> str:
    """'structured' (star-stencil family), 'general' (assembled banded
    containers), or 'opaque' (anything with an ``mv``)."""
    from tpusparse.sparse.bandell import BandedELL
    from tpusparse.sparse.dia import DFDIA, DIA, HybridDIA
    from tpusparse.sparse.stencil import StarStencil3D, StarStencilDF

    if isinstance(op, (StarStencil3D, StarStencilDF)):
        return "structured"
    if isinstance(op, (DIA, HybridDIA, DFDIA, BandedELL)):
        return "general"
    return "opaque"


def _dia_eligible(a) -> bool:
    """True when the HostCSR's natural ordering fits the DIA family
    (<= 192 occupied diagonals — sparse/dia.py's storage gate)."""
    from tpusparse.sparse.reorder import distinct_diagonals

    return distinct_diagonals(a) <= 192


def _cast_floating(op, dtype):
    """A same-structure twin of ``op`` with floating leaves cast to
    ``dtype`` (integer index arrays and aux data pass through)."""
    def cast(leaf):
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            return leaf.astype(dtype)
        return leaf

    return jax.tree.map(cast, op)


class KSP:
    """Reusable Krylov solver object (PETSc ``KSP`` parity).

    Parameters mirror the options the CLI accepts (``config/options.py``):
    ``ksp_type`` (cg | pipecg | gmres | fgmres | bcgs | minres |
    chebyshev | richardson | preonly), ``pc_type`` (gamg | jacobi | sor | bjacobi | none), tolerances, and
    ``precision`` ("mixed" = f32 inner solves under f64 defect
    correction — the production mode; "f64"/"f32" uniform).

    ``reuse_preconditioner=True`` is ``KSPSetReusePreconditioner``
    (``main_ksp.cpp:95``): once ``setup()`` has built the hierarchy,
    later ``set_operators`` calls keep it (the new operator is applied,
    the old preconditioner preconditions — PETSc's exact semantics).

    ``error_if_not_converged`` is ``-ksp_error_if_not_converged``: raise
    ``DivergedError`` on a negative reason instead of returning it.
    """

    def __init__(
        self,
        *,
        ksp_type: str = "cg",
        pc_type: str = "gamg",
        rtol: float = 1e-14,
        atol: float = 1e-12,
        divtol: float = 1e5,
        maxiter: int = 10000,
        precision: str = "mixed",
        amg_params=None,
        mg_cycle: str = "v",
        reuse_preconditioner: bool = True,
        gmres_restart: int = 30,
        richardson_scale: float = 1.0,
        error_if_not_converged: bool = False,
        mat_reorder: str = "auto",
    ):
        from tpusparse.amg import AMGParams
        from tpusparse.bench.driver import _pick_ksp

        if precision not in ("mixed", "f64", "f32"):
            raise ValueError(f"unknown precision {precision!r}")
        if pc_type not in ("gamg", "jacobi", "sor", "bjacobi", "none"):
            raise ValueError(f"unknown pc_type {pc_type!r}")
        if mg_cycle not in ("v", "w"):
            raise ValueError(f"unknown mg_cycle {mg_cycle!r}")
        if mat_reorder not in ("auto", "rcm", "none"):
            raise ValueError(f"unknown mat_reorder {mat_reorder!r}")
        self.ksp_type = ksp_type
        self.pc_type = pc_type
        self.rtol = rtol
        self.atol = atol
        self.divtol = divtol
        self.maxiter = maxiter
        self.precision = precision
        self.amg_params = amg_params or AMGParams()
        self.mg_cycle = mg_cycle
        self.reuse_preconditioner = reuse_preconditioner
        self.error_if_not_converged = error_if_not_converged
        # -mat_reorder: bandwidth-reducing row/col permutation for
        # assembled host matrices (sparse/reorder.py).  "auto" reorders
        # only when the natural ordering defeats every gather-free
        # container; "rcm" forces it; "none" disables (a matrix that then
        # needs it fails with the DIA diagonal-count error).
        self.mat_reorder = mat_reorder
        self._perm = None        # reordering permutation (perm[new] = old)
        self._iperm = None
        # resolved solver callable (validates ksp_type eagerly, like
        # KSPSetType)
        self._ksp_solve = _pick_ksp(
            ksp_type, precision, gmres_restart, richardson_scale
        )
        self._op = None          # hi-precision operator (the A of Ax=b)
        self._op_lo = None       # low-precision twin (inner solves / PC)
        self._host_a = None      # optional HostCSR (greedy aggregation)
        self._pc_state = None    # hierarchy / inverse-diagonal / ()
        self._m_of = None
        self._jitted = None
        self._jitted_x0 = None
        self._jitted_multi = None
        self._last: KSPResult | None = None

    @classmethod
    def from_options(cls, opts) -> "KSP":
        """KSPSetFromOptions: build from a ``config.Options`` (file/CLI)."""
        return cls(
            ksp_type=opts.ksp_type,
            pc_type=opts.pc_type,
            rtol=opts.ksp_rtol,
            atol=opts.ksp_atol,
            divtol=opts.ksp_divtol,
            maxiter=opts.ksp_max_it,
            precision=opts.precision,
            # always built: bjacobi reads pc_bjacobi_bs from it
            amg_params=opts.amg_params(),
            mg_cycle=opts.pc_mg_cycle_type,
            gmres_restart=opts.ksp_gmres_restart,
            richardson_scale=opts.ksp_richardson_scale,
            mat_reorder=opts.mat_reorder,
        )

    # -- KSPSetOperators ---------------------------------------------------

    def set_operators(self, a: Any, a_lo: Any = None) -> "KSP":
        """KSPSetOperators(ksp, A, A): attach the operator.

        ``a`` may be a ``StarStencil3D`` (structured fast path), a
        ``DIA``/``HybridDIA``/``DFDIA`` banded container (general-matrix
        path), a ``HostCSR``/``scipy.sparse`` matrix (converted to banded
        device form; also enables greedy aggregation), or any object with
        an ``mv`` method (``pc_type`` jacobi additionally needs
        ``diagonal()``; gamg needs one of the known container types).

        ``a_lo``: optional low-precision twin for mixed precision
        (defaults to a float32 cast of ``a``).  With
        ``reuse_preconditioner`` (default) an existing hierarchy is KEPT —
        the PETSc semantics the reference relies on; pass
        ``reuse_preconditioner=False`` at construction to rebuild the PC
        per operator.
        """
        from tpusparse.sparse.csr import HostCSR

        self._host_a = None
        self._perm = None
        self._iperm = None
        if isinstance(a, HostCSR) or not hasattr(a, "mv"):
            # host matrix: HostCSR or anything scipy can make a CSR of
            from tpusparse.sparse.dia import DIA

            if not isinstance(a, HostCSR):
                import scipy.sparse as sp

                a = HostCSR.from_scipy(sp.csr_matrix(a))
            # -mat_reorder: arbitrary-sparsity matrices (the reference's
            # MatMult_SeqAIJ contract is ANY CSR) get a bandwidth-reducing
            # RCM permutation so a gather-free / window-gather container
            # exists; the solve then runs in permuted space and solve()
            # unpermutes x (sparse/reorder.py).  "auto" reorders only when
            # the natural ordering already defeats the DIA family.
            if self.mat_reorder == "rcm" or (
                self.mat_reorder == "auto" and not _dia_eligible(a)
            ):
                from tpusparse.sparse.reorder import (
                    inverse_permutation,
                    permute_csr,
                    rcm_permutation,
                )

                perm = rcm_permutation(a)
                a = permute_csr(a, perm)
                self._perm = jnp.asarray(perm)
                self._iperm = jnp.asarray(inverse_permutation(perm))
            self._host_a = a
            mixed = self.precision == "mixed"
            if _dia_eligible(a):
                if mixed:
                    # one f32 upload serves both precisions (the driver's
                    # DFDIA trick): f32 bands are the hierarchy fine
                    # operator AND the hi half of the two-float outer
                    # operator
                    from tpusparse.sparse.dia import DFDIA

                    bands64, offsets, shp = DIA.host_bands(a)
                    bands32 = jax.device_put(bands64.astype(np.float32))
                    a_lo = DIA(bands=bands32, offsets=offsets, shape=shp)
                    a = DFDIA.from_host_bands(
                        bands64, offsets, shp, hi_dev=bands32
                    )
                else:
                    dt = np.float32 if self.precision == "f32" else None
                    a = DIA.from_csr(a, dtype=dt)
                    a_lo = a
            else:
                # bounded bandwidth (possibly after RCM) but too many
                # distinct diagonals for DIA: the segmented banded-ELL
                # executor — window-local gathers only, crash-free at any
                # row count (sparse/bandell.py)
                from tpusparse.sparse.bandell import BandedELL

                if mixed:
                    a_lo = BandedELL.from_csr(a, dtype=np.float32)
                    a = BandedELL.from_csr(a, dtype=np.float64)
                else:
                    dt = np.float32 if self.precision == "f32" else None
                    a = BandedELL.from_csr(a, dtype=dt)
                    a_lo = a
        self._op = a
        if a_lo is not None:
            self._op_lo = a_lo
        elif self.precision == "mixed":
            self._op_lo = _cast_floating(a, jnp.float32)
        else:
            self._op_lo = a
        if not self.reuse_preconditioner:
            self._pc_state = None
            self._m_of = None
        self._jitted = None
        self._jitted_x0 = None
        self._jitted_multi = None
        return self

    # -- KSPSetUp ----------------------------------------------------------

    def setup(self) -> "KSP":
        """KSPSetUp: build the preconditioner (idempotent; with
        ``reuse_preconditioner`` an existing hierarchy is kept)."""
        if self._op is None:
            raise RuntimeError("call set_operators before setup/solve")
        if self._pc_state is not None and self.reuse_preconditioner:
            return self
        # rebuilding: drop the compiled programs derived from the previous PC
        self._jitted_x0 = None
        self._jitted_multi = None
        kind = _op_kind(self._op_lo)
        gamma = 1 if self.mg_cycle == "v" else 2
        mixed = self.precision == "mixed"

        if self.pc_type == "gamg":
            from tpusparse.amg.hierarchy import vcycle

            if kind == "structured":
                from tpusparse.amg.hierarchy import gamg_setup_compiled

                self._pc_state = gamg_setup_compiled(
                    self._op_lo, self.amg_params
                )
                self._m_of = lambda ps: (
                    lambda r: vcycle(ps, r, gamma=gamma)
                )
            elif kind == "general":
                from tpusparse.amg.unstructured import (
                    gamg_setup_unstructured,
                )

                self._pc_state = gamg_setup_unstructured(
                    self._host_a,
                    self.amg_params,
                    dtype=np.float32 if mixed else None,
                    fine_op=self._op_lo,
                )
                # the hierarchy's fine operator is the (possibly
                # container-upgraded) inner-apply form
                self._op_lo = self._pc_state.levels[0].op
                self._m_of = lambda ps: (
                    lambda r: vcycle(ps, r, gamma=gamma)
                )
            else:
                raise ValueError(
                    "pc_type='gamg' needs a StarStencil3D, DIA-family, or"
                    " HostCSR/scipy operator — got"
                    f" {type(self._op).__name__}"
                )
        elif self.pc_type == "jacobi":
            diag = (
                self._op_lo.diagonal_field()
                if hasattr(self._op_lo, "diagonal_field")
                else self._op_lo.diagonal()
            )
            self._pc_state = 1.0 / diag
            self._m_of = lambda ps: (lambda r: ps * r)
        elif self.pc_type == "sor":
            # standalone PCSOR in the CG-compatible SSOR form (the same
            # construction as bench/driver.py's): the operator rides
            # inside pc_state — never a baked closure
            if not hasattr(self._op_lo, "gs_color_masks"):
                raise ValueError(
                    "pc_type='sor' needs a colorable grid operator"
                    f" (gs_color_masks); {type(self._op_lo).__name__}"
                    " has none"
                )
            self._pc_state = (
                1.0 / self._op_lo.diagonal_field(),
                tuple(self._op_lo.gs_color_masks()),
                self._op_lo,
            )

            def _sor_m_of(ps):
                dinv, masks, sop = ps

                def apply(r):
                    x = None
                    for m in masks + masks[::-1]:
                        if x is None:
                            x = jnp.where(m, dinv * r, jnp.zeros_like(r))
                        else:
                            x = jnp.where(
                                m, x + dinv * (r - sop.mv(x)), x
                            )
                    return x

                return apply

            self._m_of = _sor_m_of
        elif self.pc_type == "bjacobi":
            from tpusparse.solve.bjacobi import BlockJacobi

            bs = self.amg_params.bjacobi_bs
            if self._host_a is None:
                raise ValueError(
                    "pc_type='bjacobi' on the KSP object needs a"
                    " HostCSR/scipy operator (set_operators with a host"
                    " matrix keeps it)"
                )
            if bs and bs > 1:
                self._pc_state = BlockJacobi.build(
                    self._host_a, bs,
                    dtype=np.float32 if mixed else None,
                )
                self._m_of = lambda ps: ps.apply
            else:  # point degeneracy
                self._pc_state = 1.0 / jnp.asarray(
                    self._host_a.diagonal(),
                    jnp.float32 if mixed else jnp.float64,
                )
                self._m_of = lambda ps: (lambda r: ps * r)
        else:  # none
            self._pc_state = jnp.zeros(())
            self._m_of = lambda ps: None
        self._jitted = None  # the solve program closes over m_of's shape
        return self

    # -- KSPSolve ----------------------------------------------------------

    def _solve_chunked(self, b: jax.Array, x0) -> KSPResult:
        """Host-loop solve: fixed-trip fori chunks with host-side
        convergence checks (``solve/cg.cg_hostloop``), under an EAGER
        defect-correction outer loop for mixed precision.  Functionally
        the same contract as the jitted path; costs one dispatch per chunk
        of iterations.  ``solve`` never routes here: it is library code
        kept beside ``cg_hostloop``."""
        import numpy as np

        from tpusparse.solve.cg import ConvergedReason, cg_hostloop

        if self.ksp_type != "cg":
            raise ValueError(
                "the chunked large-matrix driver supports ksp_type='cg';"
                f" got {self.ksp_type!r}"
            )
        if x0 is not None:
            raise ValueError(
                "the chunked large-matrix driver requires a zero initial"
                " guess"
            )
        gamma = 1 if self.mg_cycle == "v" else 2
        m_of = self._m_of

        def m_apply(ps, r):
            f = m_of(ps) if m_of is not None else None
            return r if f is None else f(r)

        a_apply = lambda op, x: op.mv(x)
        if self.precision != "mixed":
            res = cg_hostloop(
                a_apply, self._op, b, rtol=self.rtol, atol=self.atol,
                maxiter=self.maxiter, m_apply=m_apply,
                m_state=self._pc_state,
            )
            return KSPResult(
                x=res.x, iters=int(res.iters), resnorm=float(res.resnorm),
                reason=int(res.reason),
            )
        # eager defect correction (the jitted twin: solve/refine.cg_refined)
        bnorm = float(jnp.linalg.norm(b))
        tol = max(self.rtol * bnorm, self.atol)
        x = jnp.zeros_like(b)
        r = b
        total = 0
        prev = float("inf")
        reason = int(ConvergedReason.DIVERGED_ITS)
        for outer in range(12):
            rn = float(jnp.linalg.norm(r))
            if not np.isfinite(rn):
                reason = int(ConvergedReason.DIVERGED_NANORINF)
                break
            if rn <= tol:
                reason = (
                    int(ConvergedReason.CONVERGED_ATOL)
                    if rn <= self.atol
                    else int(ConvergedReason.CONVERGED_RTOL)
                )
                break
            if outer >= 2 and rn > 0.5 * prev:
                reason = int(ConvergedReason.CONVERGED_STALLED)
                break
            prev = rn
            r_lo = (r / rn).astype(jnp.float32)
            need = float(np.clip(0.25 * tol / rn, 1e-5, 0.5))
            inner = cg_hostloop(
                a_apply, self._op_lo, r_lo, rtol=need, maxiter=200,
                m_apply=m_apply, m_state=self._pc_state, chunk=16,
            )
            total += int(inner.iters)
            x = x + inner.x.astype(b.dtype) * rn
            r = b - self._op.mv(x)
        return KSPResult(
            x=x, iters=total, resnorm=float(jnp.linalg.norm(r)),
            reason=reason, outer_iters=outer,
        )

    def _build_solve(self, x0_mode: bool = False):
        """The compiled solve program.  ``x0_mode`` solves the DEFECT
        system A dx = b - A x0 but keeps the convergence gate relative to
        the ORIGINAL right-hand side (PETSc's default rnorm0 = ||b||): the
        tolerance arrives as a traced ``max(rtol*||b_orig||, atol)``
        absolute gate, so a good warm start exits immediately."""
        mixed = self.precision == "mixed"
        m_of = self._m_of
        rtol, atol, maxiter = self.rtol, self.atol, self.maxiter
        divtol = self.divtol
        ksp_solve = self._ksp_solve
        if mixed:
            from tpusparse.solve.refine import cg_refined

            def solve_fn(op_hi, op_lo, pc_state, b, bnorm_ref=None):
                kw = dict(rtol=rtol, atol=atol)
                if bnorm_ref is not None:
                    kw = dict(rtol=0.0, atol=jnp.maximum(
                        rtol * bnorm_ref, atol))
                return cg_refined(
                    op_hi.mv, op_lo.mv, b, divtol=divtol,
                    # maxiter caps both loop depths (PETSc -ksp_max_it:
                    # a work bound; defaults leave both at their tuned
                    # values since maxiter defaults to 10000)
                    max_outer=min(12, maxiter),
                    inner_maxiter=min(200, maxiter),
                    m_lo_mv=m_of(pc_state), solver=ksp_solve, **kw,
                )
        else:
            def solve_fn(op_hi, op_lo, pc_state, b, bnorm_ref=None):
                kw = dict(rtol=rtol, atol=atol)
                if bnorm_ref is not None:
                    kw = dict(rtol=0.0, atol=jnp.maximum(
                        rtol * bnorm_ref, atol))
                return ksp_solve(
                    op_hi.mv, b, maxiter=maxiter, divtol=divtol,
                    m_mv=m_of(pc_state), **kw,
                )
        # operators/hierarchy ride as ARGUMENTS (closures would bake the
        # band data into the HLO as literals — driver.py:416 note)
        if x0_mode:
            return jax.jit(solve_fn)
        return jax.jit(
            lambda op_hi, op_lo, pc_state, b: solve_fn(
                op_hi, op_lo, pc_state, b
            )
        )

    def solve(self, b: jax.Array, x0: jax.Array | None = None) -> KSPResult:
        """KSPSolve: solve A x = b.  Repeated calls reuse the hierarchy
        and the compiled program (only a shape/dtype change retraces).

        ``x0``: optional nonzero initial guess
        (``KSPSetInitialGuessNonzero`` parity) — solved as the defect
        system A dx = b - A x0 so every solver/precision mode supports it.
        """
        self.setup()
        if self._perm is not None:
            # solve in RCM-permuted space: P A P^T (P x) = P b.  One
            # top-level take each way, outside every solver loop; the
            # similarity transform leaves the spectrum and hence the
            # iteration sequence untouched.
            b = jnp.take(b.reshape(-1), self._perm)
            if x0 is not None:
                x0 = jnp.take(x0.reshape(-1), self._perm)
        # structured operators apply on the 3-D field view; accept flat
        # vectors and answer in kind
        flat_in = False
        gshape = getattr(self._op, "grid_shape", None)
        if gshape is not None and b.ndim == 1:
            b = b.reshape(gshape)
            flat_in = True
            if x0 is not None:
                x0 = x0.reshape(gshape)
        if x0 is not None:
            if self._jitted_x0 is None:
                self._jitted_x0 = self._build_solve(x0_mode=True)
            bnorm_ref = jnp.linalg.norm(b.reshape(-1))  # ORIGINAL rhs norm
            b = b - self._op.mv(x0)
            res = self._jitted_x0(
                self._op, self._op_lo, self._pc_state, b, bnorm_ref
            )
        else:
            if self._jitted is None:
                self._jitted = self._build_solve()
            res = self._jitted(self._op, self._op_lo, self._pc_state, b)
        x = res.x if x0 is None else res.x + x0
        if self._perm is not None:
            x = jnp.take(x.reshape(-1), self._iperm)
        if flat_in:
            x = x.reshape(-1)
        out = KSPResult(
            x=x,
            iters=int(res.iters),
            resnorm=float(res.resnorm),
            reason=int(res.reason),
            outer_iters=int(getattr(res, "outer_iters", 0)),
        )
        self._last = out
        if self.error_if_not_converged and out.reason < 0:
            from tpusparse.bench.driver import DivergedError

            raise DivergedError(f"Diverged reason: {out.reason}")
        return out

    def mat_solve(self, b_block: jax.Array) -> "Any":
        """KSPMatSolve parity: solve A X = B for a BLOCK of right-hand
        sides in one batched program — ``b_block`` stacks the columns on
        axis 0 ((k, n) flat or (k, nz, ny, nx) fields).  One batched
        stencil/band apply streams the operator coefficients once for all
        k columns; converged columns are masked-frozen while the rest
        finish (``solve/multi.py``).  Returns a ``MultiResult`` with
        per-column iterations/residuals/reasons.

        Requires ``ksp_type='cg'``.
        """
        if self.ksp_type != "cg":
            raise ValueError(
                "mat_solve supports ksp_type='cg' (block CG); got"
                f" {self.ksp_type!r}"
            )
        self.setup()
        gshape = getattr(self._op, "grid_shape", None)
        flat_in = False
        if gshape is not None and b_block.ndim == 2:
            b_block = b_block.reshape((b_block.shape[0], *gshape))
            flat_in = True
        mixed = self.precision == "mixed"
        gamma = 1 if self.mg_cycle == "v" else 2
        rtol, atol, maxiter = self.rtol, self.atol, self.maxiter
        divtol = self.divtol

        op_hi, op_lo, pc_state = self._op, self._op_lo, self._pc_state
        # preconditioner: the vmappable V-cycle / diagonal forms
        if self.pc_type == "gamg":
            from tpusparse.amg.hierarchy import vcycle

            m_of = lambda ps: (lambda r: vcycle(ps, r, gamma=gamma))
        elif self.pc_type == "jacobi":
            m_of = lambda ps: (lambda r: ps * r)
        else:
            m_of = lambda ps: None

        if self._jitted_multi is None:
            from tpusparse.solve.multi import cg_multi, refined_multi

            if mixed:
                def solve_fn(op_hi, op_lo, pc_state, bb):
                    return refined_multi(
                        op_hi.mv, op_lo.mv, bb, rtol=rtol, atol=atol,
                        divtol=divtol,
                        max_outer=min(12, maxiter),
                        inner_maxiter=min(200, maxiter),
                        m_lo_mv=m_of(pc_state),
                    )
            else:
                def solve_fn(op_hi, op_lo, pc_state, bb):
                    return cg_multi(
                        op_hi.mv, bb, rtol=rtol, atol=atol, divtol=divtol,
                        maxiter=maxiter, m_mv=m_of(pc_state),
                    )
            self._jitted_multi = jax.jit(solve_fn)
        res = self._jitted_multi(op_hi, op_lo, pc_state, b_block)
        if flat_in:
            res = dataclasses.replace(
                res, x=res.x.reshape((res.x.shape[0], -1))
            )
        if self.error_if_not_converged and bool(jnp.any(res.reason < 0)):
            from tpusparse.bench.driver import DivergedError

            raise DivergedError(
                f"Diverged reasons: {np.asarray(res.reason).tolist()}"
            )
        return res

    def compute_eigenvalues(
        self, b: jax.Array | None = None,
        rtol: float = 1e-12, maxiter: int = 300,
    ) -> "np.ndarray":
        """KSPComputeEigenvalues parity: Ritz values of the preconditioned
        operator M A, ascending, measured from a dedicated CG run's own
        Lanczos scalars (``solve/spectrum.py``) — the preconditioner-
        quality probe at sizes a dense eigenanalysis cannot reach.

        Runs on the PC's home operator (the low-precision twin under
        mixed precision — exactly the pair the inner solves iterate
        with).  ``b`` seeds the Krylov space (default: a deterministic
        non-smooth ramp); more iterations = more converged Ritz values,
        extremes first.
        """
        self.setup()
        from functools import partial

        from tpusparse.solve.cg import cg as _cg
        from tpusparse.solve.spectrum import ritz_values

        op = self._op_lo
        gshape = getattr(self._op, "grid_shape", None)
        if b is None:
            n = (
                int(np.prod(gshape)) if gshape is not None
                else self._op.shape[0]
            )
            b = jnp.sin(jnp.arange(n) * 0.7 + 0.3)
            if gshape is not None:
                b = b.reshape(gshape)
        elif gshape is not None and b.ndim == 1:
            b = b.reshape(gshape)
        b = b.astype(op.dtype)
        m_of = self._m_of

        @partial(jax.jit, static_argnames=())
        def run(op, ps, bb):
            return _cg(
                op.mv, bb, rtol=rtol, maxiter=maxiter,
                m_mv=m_of(ps), spectrum=True,
            )

        res, (al, be) = run(op, self._pc_state, b)
        return ritz_values(np.asarray(al), np.asarray(be), int(res.iters))

    # -- Get* accessors (main_ksp.cpp:114-117) ------------------------------

    @property
    def iterations(self) -> int:
        """KSPGetIterationNumber (of the most recent solve)."""
        self._require_solved()
        return self._last.iters

    @property
    def residual_norm(self) -> float:
        """KSPGetResidualNorm (of the most recent solve)."""
        self._require_solved()
        return self._last.resnorm

    @property
    def converged_reason(self) -> int:
        """KSPGetConvergedReason (of the most recent solve)."""
        self._require_solved()
        return self._last.reason

    def _require_solved(self):
        if self._last is None:
            raise RuntimeError("no solve has run yet")
