"""Benchmark driver — parity with the reference's ``src/main_ksp.cpp``.

Reproduces the reference driver's protocol: build the manufactured Poisson
system, set up CG + AMG, solve, hard-fail on divergence, compute the Linf
error against the analytic solution, and report the three-phase time triple
``[init, create solver, solve]`` in the exact text format the reference's
plot layer regex-parses (``src/main_ksp.cpp:124-129``,
``scripts/generate_plots.py:87-90``) — plus a JSON sidecar so nothing
downstream ever has to scrape text again (SURVEY.md section 5.5).
"""

from __future__ import annotations

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpusparse.amg import AMGParams, gamg_setup, vcycle
from tpusparse.grid.grid3d import Grid3D
from tpusparse.grid.poisson import poisson_stencil_device as poisson_stencil
from tpusparse.solve import cg


@dataclasses.dataclass
class SolveReport:
    nx: int
    ny: int
    nz: int
    iters: int
    resnorm: float
    linf_error: float
    reason: int
    t_init: float
    t_setup: float
    t_solve: float
    rtol: float
    atol: float
    pc: str
    precision: str = "f64"
    outer_iters: int = 0
    # -mat_type: "stencil" (structured DMDA fast path) or "aij"
    # (general assembled-CSR path, DMSetMatType(MATAIJ) parity —
    # /root/reference/src/helper.cpp:39)
    mat_type: str = "stencil"
    # KSPSetUp sub-phase breakdown (aij path): aggregate/galerkin/rho/
    # device_put seconds — the reference times setup as a first-class
    # phase (src/main_ksp.cpp:97-100)
    setup_breakdown: dict | None = None
    # -ksp_monitor data: per-iteration ||r||_2 for uniform-precision solves,
    # per-OUTER-sweep true ||r||_2 for mixed precision (index 0 = initial)
    residual_history: list | None = None
    # -ksp_view text (KSPView/PCView parity), filled when view=True
    solver_view: str | None = None
    # matrix provenance for file-loaded systems (-f, MatLoad parity) or
    # non-Poisson problem families; None for assembled Poisson runs
    source: str | None = None
    # True when the system came from a file: nx/ny are MATRIX dims, not
    # grid dims (reference_block keys on this, not on shape inference)
    source_is_file: bool = False
    # -ksp_compute_eigenvalues data: Ritz values of the preconditioned
    # operator M A from the CG iteration's own Lanczos scalars
    # (solve/spectrum.py), ascending; None unless requested
    eigenvalues: list | None = None
    # number of devices the solution is sharded over
    devices: int = 1

    def log_view(self) -> str:
        """PETSc ``-log_view``-style performance summary: phase wall times
        plus the solve phase's flop accounting (PetscLogFlops model:
        2*nnz per fine operator apply, ~7 applies per CG+AMG iteration
        with a 27/7-nnz-ratio coarse hierarchy ~= 1.6x fine-level work)."""
        n = self.nx * self.ny * self.nz
        nnz = 7 * n - 2 * (
            self.ny * self.nz + self.nx * self.nz + self.nx * self.ny
        )
        flops = 2 * nnz * 7 * 1.6 * max(self.iters, 1)
        total = self.t_init + self.t_setup + self.t_solve
        lines = [
            "--- Performance Summary (-log_view) "
            "----------------------------------",
            f"{'Phase':<16}{'Time (s)':>12}{'% total':>10}",
            f"{'init (system)':<16}{self.t_init:>12.4f}"
            f"{100 * self.t_init / total:>9.1f}%",
            f"{'setup (KSP+PC)':<16}{self.t_setup:>12.4f}"
            f"{100 * self.t_setup / total:>9.1f}%",
            f"{'solve':<16}{self.t_solve:>12.4f}"
            f"{100 * self.t_solve / total:>9.1f}%",
            f"solve: {self.iters} iterations, ~{flops / 1e9:.2f} GFLOP "
            f"(PetscLogFlops model), "
            f"{flops / self.t_solve / 1e9:.1f} GFLOP/s, "
            f"{nnz * max(self.iters, 1) / self.t_solve / 1e9:.2f} Gnnz/s",
        ]
        return "\n".join(lines)

    def monitor_block(self) -> str:
        """PETSc ``-ksp_monitor`` output: '  %d KSP Residual norm %e' per
        recorded residual (KSPMonitorResidual format)."""
        if not self.residual_history:
            return ""
        return "\n".join(
            f"  {i} KSP Residual norm {r:e}"
            for i, r in enumerate(self.residual_history)
        )

    def eigenvalues_block(self) -> str:
        """PETSc ``-ksp_compute_eigenvalues`` output (KSPComputeEigenvalues
        data printed after the solve) + the kappa(MA) estimate."""
        if not self.eigenvalues:
            return ""
        import numpy as np

        from tpusparse.solve.spectrum import eigenvalue_block

        return eigenvalue_block(np.asarray(self.eigenvalues))

    def converged_reason_line(self) -> str:
        """PETSc ``-ksp_converged_reason`` output: 'Linear solve converged
        due to CONVERGED_RTOL iterations 34' (KSPConvergedReasonView
        format; the reason name from the shared enum, including the
        tpusparse extension CONVERGED_STALLED)."""
        from tpusparse.solve.cg import ConvergedReason

        try:
            name = ConvergedReason(self.reason).name
        except ValueError:
            name = str(self.reason)
        verdict = (
            "converged" if self.reason > 0 else "did not converge"
        )
        return (
            f"Linear solve {verdict} due to {name}"
            f" iterations {self.iters}"
        )

    def reference_block(self) -> str:
        """The reference's exact output contract (src/main_ksp.cpp:124-129).

        File-loaded systems (``solve_from_file``) substitute the grid line
        with the matrix provenance, and print "n/a" for the
        error-vs-analytic norm when the file carries no exact solution
        (sentinel ``linf_error < 0``)."""
        grid_line = f"[Nx, Ny, Nz]: [{self.nx}, {self.ny}, {self.nz}]"
        if self.source_is_file:
            # file-loaded system: nx x ny are the MATRIX dims
            head = f"Matrix: {self.source} [{self.nx} x {self.ny}]"
        elif self.source:
            # non-Poisson grid problem (e.g. diffusion): name it, keep grid
            head = f"Problem: {self.source}\n{grid_line}"
        else:
            head = grid_line
        linf = (
            f"{self.linf_error:f}" if self.linf_error >= 0.0
            else "n/a (no exact solution in file)"
        )
        return (
            f"{head}\n"
            f"Number of iterations: {self.iters}\n"
            f"L2 norm of final residual: {self.resnorm:f}\n"
            f"Maximum norm of error: {linf}\n"
            f"Time [init, create solver, solve]: "
            f"[{self.t_init:f}, {self.t_setup:f}, {self.t_solve:f}]"
        )

    def json_sidecar(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class DivergedError(RuntimeError):
    """SETERRQ1-on-negative-reason parity (src/main_ksp.cpp:109-111)."""


def _pick_ksp(
    ksp: str,
    precision: str,
    ksp_gmres_restart: int,
    ksp_richardson_scale: float,
    ksp_norm_type: str = "default",
):
    """Resolve a -ksp_type name to a solver callable (shared by the stencil
    and aij drivers)."""
    if ksp == "cg":
        if ksp_norm_type not in ("default", "unpreconditioned"):
            from functools import partial as _partial

            return _partial(cg, norm_type=ksp_norm_type)
        return cg
    if ksp == "pipecg":
        from tpusparse.solve.pipelined import cg_pipelined

        if precision in ("mixed", "tf"):
            # round 1 measured the f32 inner recurrences NaN'ing at >=144^3
            # (the delta - beta*gamma/alpha denominator cancels in f32).
            # Cure: f64 RECURRENCE SCALARS + residual replacement every 5
            # (vectors and dots stay f32).  Measured on-chip: 144^3
            # converges to rel 2e-9; at 216^3+ the solution still reaches
            # discretization accuracy (Linf = O(h^2)) but the pipelined
            # attainable-accuracy floor sits above rtol 1e-8, reported
            # honestly as CONVERGED_STALLED.  Classic cg remains the
            # default inner solver; pipecg's fused-reduction advantage is
            # a multi-chip latency play.
            from functools import partial as _partial

            if not jax.config.jax_enable_x64:
                # the cure REQUIRES f64 scalars; with x64 off this would
                # silently re-enable the measured-NaN configuration
                raise ValueError(
                    "-ksp_type pipecg with mixed precision needs f64 "
                    "recurrence scalars: enable jax_enable_x64"
                )
            return _partial(
                cg_pipelined,
                scalar_dtype=jnp.float64,
                replace_every=5,
            )
        return cg_pipelined
    if ksp == "gmres":
        # KSPGMRES (PETSc's default type): restarted, left-preconditioned,
        # CGS2 orthogonalization as matrix products (solve/gmres.py)
        from functools import partial as _partial

        from tpusparse.solve.gmres import gmres

        return _partial(gmres, restart=ksp_gmres_restart)
    if ksp == "fgmres":
        # KSPFGMRES: flexible (right-preconditioned) restarted GMRES —
        # tolerates a variable/inexact preconditioner, converges on the
        # TRUE residual norm (solve/fgmres.py)
        from functools import partial as _partial

        from tpusparse.solve.fgmres import fgmres

        return _partial(fgmres, restart=ksp_gmres_restart)
    if ksp == "bcgs":
        # KSPBCGS: short-recurrence nonsymmetric workhorse
        from tpusparse.solve.bcgs import bicgstab

        return bicgstab
    if ksp == "minres":
        # KSPMINRES: symmetric INDEFINITE systems (CG requires SPD)
        from tpusparse.solve.minres import minres

        return minres
    if ksp == "chebyshev":
        # KSPCHEBYSHEV: dot-free iteration (auto eigenvalue estimation)
        from tpusparse.solve.chebyshev import chebyshev

        return chebyshev
    if ksp == "richardson":
        # KSPRICHARDSON as the top-level (or inner, under mixed precision)
        # solver: multigrid-as-a-solver when pc=gamg
        from functools import partial as _partial

        from tpusparse.solve.simple import richardson

        return _partial(richardson, scale=ksp_richardson_scale)
    if ksp == "preonly":
        # KSPPREONLY: one preconditioner application; under mixed precision
        # this is classic "one V-cycle per defect-correction sweep"
        from tpusparse.solve.simple import preonly

        return preonly
    raise ValueError(
        f"unknown ksp {ksp!r} (cg | pipecg | gmres | fgmres | bcgs |"
        f" minres | chebyshev | richardson | preonly)"
    )


def solve_poisson(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    *,
    rtol: float = 1e-14,
    atol: float = 1e-12,
    divtol: float = 1e5,
    maxiter: int = 10000,
    pc: str = "gamg",
    amg_params: AMGParams | None = None,
    dtype=jnp.float64,
    precision: str = "mixed",
    warmup: bool = True,
    check_error: bool = True,
    n_devices: int = 1,
    ksp: str = "cg",
    pc_dtype: str = "f32",
    mg_cycle: str = "v",
    monitor: bool = False,
    ksp_richardson_scale: float = 1.0,
    view: bool = False,
    ksp_gmres_restart: int = 30,
    mat_type: str = "stencil",
    aggregation: str = "auto",
    extent: tuple[float, float, float] | None = None,
    assembly: str = "auto",
    structure_detect: bool = True,
    compute_eigenvalues: bool = False,
    ksp_norm_type: str = "default",
) -> SolveReport:
    """End-to-end solve with the reference's defaults
    (tolerances: configs/PETSc_SolverOptions_GAMG.info:1-4).

    ``precision``: "mixed" (default — f32 CG+AMG inner solves under f64
    defect correction, see solve/refine.py), "f64" (uniform f64, the
    reference's own choice), or "f32" (uniform f32, tolerance-limited).

    ``mat_type``: "stencil" (default) is the structured DMDA-equivalent
    fast path; "aij" treats the same system as an arbitrary assembled CSR —
    DMSetMatType(MATAIJ) parity (/root/reference/src/helper.cpp:39) — over
    gather-free DIA containers with unstructured smoothed-aggregation GAMG.

    Phase timing protocol matches main_ksp.cpp:80-106: init = system build,
    setup = preconditioner construction, solve = the (pre-compiled) solve.
    When ``warmup`` is true the solve is compiled + run once first, so
    t_solve measures execution (the reference's KSPSolve timing also
    excludes compilation — its kernels are prebuilt binaries); the SETUP
    program gets the same treatment (pre-built untimed, then the timed
    region re-executes it), so t_setup measures the numeric hierarchy
    build — rho power iterations, probed Galerkin, transfer construction —
    which is what the reference's KSPSetUp phase times (its aggregation/
    SpGEMM run as prebuilt binaries too; src/main_ksp.cpp:97-100).
    """
    ny = ny or nx
    nz = nz or nx
    if mat_type not in ("stencil", "aij"):
        raise ValueError(f"unknown mat_type {mat_type!r} (stencil | aij)")
    if mat_type == "aij":
        return _solve_poisson_aij(
            nx, ny, nz, rtol=rtol, atol=atol, divtol=divtol,
            maxiter=maxiter, pc=pc,
            amg_params=amg_params, precision=precision, warmup=warmup,
            check_error=check_error, n_devices=n_devices, ksp=ksp,
            mg_cycle=mg_cycle, monitor=monitor, view=view,
            ksp_gmres_restart=ksp_gmres_restart,
            ksp_richardson_scale=ksp_richardson_scale,
            aggregation=aggregation, extent=extent, assembly=assembly,
            structure_detect=structure_detect,
            compute_eigenvalues=compute_eigenvalues,
        )
    if precision not in ("mixed", "tf", "f64", "f32"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "f32":
        dtype = jnp.float32
    if dtype == jnp.float64 and not jax.config.jax_enable_x64:
        raise RuntimeError("enable jax_enable_x64 before building f64 systems")
    mixed = precision in ("mixed", "tf")
    ksp_solve = _pick_ksp(
        ksp, precision, ksp_gmres_restart, ksp_richardson_scale,
        ksp_norm_type,
    )

    # Runtime bring-up OUTSIDE the timed phases: the reference's timer
    # starts after MPI_Init/PetscInitialize (src/main_ksp.cpp:70-80), so
    # backend start-up (which otherwise lands in whichever phase runs
    # first) is the PetscInitialize analogue, not init work.
    float(jax.jit(lambda: jnp.zeros(()))())

    t0 = time.perf_counter()
    lx, ly, lz = extent or (1.0, 1.0, 1.0)
    grid = Grid3D(nx, ny, nz, lx=lx, ly=ly, lz=lz)
    op, b, exact = poisson_stencil(grid, dtype=jnp.dtype(dtype).type)
    # low-precision twin for the inner solves (also the AMG's home dtype)
    op_lo = poisson_stencil(grid, dtype=np.float32)[0] if mixed else op

    if n_devices > 1 and pc in ("sor", "bjacobi"):
        raise NotImplementedError(
            f"pc_type={pc!r} is single-device (its state is not wired"
            " through the sharding layer); use gamg/jacobi multi-device"
        )
    b = jax.block_until_ready(b)
    t_init = time.perf_counter() - t0

    return _setup_and_solve(
        op=op, op_lo=op_lo, b=b, exact=exact, nx=nx, ny=ny, nz=nz,
        t_init=t_init, mixed=mixed, precision=precision, pc=pc,
        pc_dtype=pc_dtype, mg_cycle=mg_cycle, amg_params=amg_params,
        rtol=rtol, atol=atol, divtol=divtol, maxiter=maxiter, ksp=ksp,
        ksp_solve=ksp_solve, monitor=monitor, view=view, warmup=warmup,
        n_devices=n_devices, check_error=check_error,
        eigs=compute_eigenvalues,
    )


def _setup_and_solve(
    *,
    op, op_lo, b, exact, nx, ny, nz, t_init,
    mixed, precision, pc, pc_dtype, mg_cycle, amg_params,
    rtol, atol, maxiter, ksp, ksp_solve, monitor, view,
    divtol: float = 1e5,
    warmup, n_devices, check_error,
    mat_type: str = "stencil",
    view_extra: str | None = None,
    breakdown: dict | None = None,
    t_setup_seed: float = 0.0,
    eigs: bool = False,
) -> SolveReport:
    """KSPSetUp + KSPSolve core shared by the structured driver and the
    star-lifted aij route (sparse/starlift.py): warmup program builds,
    timed one-dispatch hierarchy setup, sharding, timed solve, and the
    reference-contract report (src/main_ksp.cpp:97-129)."""
    if eigs and (mixed or ksp != "cg" or monitor):
        # PETSc computes these for any KSP; here the Lanczos identity is
        # wired for the uniform-precision CG path (mixed precision runs
        # many short inner solves — no single Lanczos process to report)
        import warnings

        warnings.warn(
            "-ksp_compute_eigenvalues needs uniform-precision -ksp_type cg"
            " without -ksp_monitor; skipping eigenvalue computation"
        )
        eigs = False
    # -pc_gamg_threshold on the structured path: an EAGER strength fetch
    # picks a static per-axis coarsening schedule (None when isotropic —
    # the threshold-0 reference default takes this branch untouched)
    threshold_sched = None
    if pc == "gamg":
        from tpusparse.amg.hierarchy import threshold_schedule as _tsch

        _params_t = amg_params or AMGParams()
        threshold_sched = _tsch(op_lo, _params_t.threshold, _params_t.factor)

    if warmup and pc == "gamg":
        # Setup-program build OUTSIDE the timed phase — the same protocol
        # the solve phase has always used (see the warmup note below): the
        # reference's KSPSetUp runs prebuilt binaries, so its timed setup
        # is pure numeric work (aggregation, Galerkin products, smoother
        # setup).  Our JIT trace + executable transport is the analogue of
        # its compile step, not of KSPSetUp.  The timed region below
        # re-executes the (now in-process-cached) setup program, so
        # t_setup measures the numeric hierarchy build — rho power
        # iterations, probed Galerkin, transfer builds — on prebuilt
        # programs, exactly like t_solve.
        from tpusparse.amg.hierarchy import gamg_setup_compiled as _gsc

        _pre = _gsc(
            op_lo, amg_params or AMGParams(),
            factors_schedule=threshold_sched,
        )
        jax.block_until_ready(_pre.levels[-1].rho)
        del _pre

    t0 = time.perf_counter()
    # NOTE: operator/hierarchy pytrees are passed as jit ARGUMENTS, never
    # closed over — a closure would bake hundreds of MB of fields into the
    # program as literal constants.  Data stays device-resident; only the
    # HLO is compiled.
    if mg_cycle not in ("v", "w"):
        raise ValueError(f"unknown mg_cycle {mg_cycle!r}")
    gamma = 1 if mg_cycle == "v" else 2
    breakdown = {} if breakdown is None else breakdown
    if pc == "gamg":
        # ONE-dispatch compiled setup (gamg_setup_compiled): the whole
        # hierarchy build as a single XLA program, not a dispatch per level
        from tpusparse.amg.hierarchy import gamg_setup_compiled

        _t0 = time.perf_counter()
        pc_state = gamg_setup_compiled(
            op_lo, amg_params or AMGParams(),
            factors_schedule=threshold_sched,
        )
        jax.block_until_ready(pc_state.levels[-1].rho)
        breakdown["hierarchy_build"] = round(time.perf_counter() - _t0, 4)
        if pc_dtype == "bf16":
            # bf16 V-cycle: half the preconditioner's memory traffic.  Its
            # trade-off is size-dependent (more CG iterations as
            # conditioning grows), hence default f32; opt in per problem.
            from tpusparse.amg.hierarchy import cast_hierarchy

            pc_state = cast_hierarchy(pc_state, jnp.bfloat16)
            m_of = lambda pc_state: (
                lambda r: vcycle(
                    pc_state, r.astype(jnp.bfloat16), gamma=gamma
                ).astype(r.dtype)
            )
        else:
            m_of = lambda pc_state: (
                lambda r: vcycle(pc_state, r, gamma=gamma)
            )
    elif pc == "jacobi":
        pc_state = 1.0 / op_lo.diagonal_field()
        m_of = lambda pc_state: (lambda r: pc_state * r)
    elif pc == "sor":
        # standalone PCSOR, in the CG-compatible SSOR form (PETSc's
        # -pc_sor_symmetric): one forward + one reversed multicolor GS
        # sweep — masked simultaneous updates within a color ARE a GS
        # ordering (amg/hierarchy._smooth's 'sor' smoother, as its own PC)
        if not hasattr(op_lo, "gs_color_masks"):
            raise ValueError(
                "pc_type='sor' needs a colorable grid operator"
                f" (gs_color_masks); {type(op_lo).__name__} has none"
            )
        # the operator rides INSIDE pc_state (m_of only receives
        # pc_state; a python closure over op_lo would bake its fields
        # into the HLO as literals — the driver-wide rule)
        pc_state = (
            1.0 / op_lo.diagonal_field(),
            tuple(op_lo.gs_color_masks()),
            op_lo,
        )

        def m_of(pc_state):
            dinv, masks, sop = pc_state

            def apply(r):
                x = None
                for m in masks + masks[::-1]:
                    if x is None:
                        x = jnp.where(m, dinv * r, jnp.zeros_like(r))
                    else:
                        x = jnp.where(m, x + dinv * (r - sop.mv(x)), x)
                return x

            return apply
    elif pc == "none":
        pc_state = jnp.zeros(())
        m_of = lambda pc_state: None
    else:
        raise ValueError(f"unknown pc {pc!r}")

    # inner CG iterations per convergence check (PETSc checks every
    # iteration = 1; CG overshoot is harmless — see solve/cg.py).  Whether
    # a larger value pays waits on a measurement of the device's loop-trip
    # cost; until then 1 unless the environment says otherwise.
    import os as _os2

    inner_check_every = int(_os2.environ.get("TPUSPARSE_CHECK_EVERY", "1"))

    if precision == "tf":
        # two-float outer: no f64 on the device hot path at all
        from tpusparse.solve.refine import cg_refined_tf

        op_df = op.to_df()

        def solve_fn(op_df, op_lo, pc_state, b):
            return cg_refined_tf(
                op_df, op_lo.mv, b, rtol=rtol, atol=atol, divtol=divtol,
                m_lo_mv=m_of(pc_state),
                check_every=inner_check_every,
                solver=ksp_solve, history=monitor,
            )
    elif mixed:
        from tpusparse.solve.refine import cg_refined

        def solve_fn(op, op_lo, pc_state, b):
            return cg_refined(
                op.mv, op_lo.mv, b, rtol=rtol, atol=atol, divtol=divtol,
                m_lo_mv=m_of(pc_state),
                check_every=inner_check_every,
                solver=ksp_solve, history=monitor,
            )
    else:
        def solve_fn(op, op_lo, pc_state, b):
            kw = dict(history=monitor)
            if eigs:
                kw = dict(spectrum=True)
            return ksp_solve(
                op.mv, b, rtol=rtol, atol=atol, divtol=divtol,
                maxiter=maxiter, m_mv=m_of(pc_state), **kw,
            )

    if n_devices > 1:
        from tpusparse.dist import (
            field_sharding,
            make_mesh,
            shard_hierarchy,
            shard_system,
        )

        mesh = make_mesh(n_devices)
        op, b, exact = shard_system(op, b, exact, mesh)
        if mixed:
            from tpusparse.dist.mesh import _put

            op_lo = _put(op_lo, field_sharding(mesh))
            if precision == "tf":
                op_df = _put(op_df, field_sharding(mesh))
        else:
            op_lo = op
        if pc == "gamg":
            pc_state = shard_hierarchy(pc_state, mesh)
        elif pc == "jacobi":
            pc_state = jax.device_put(pc_state, field_sharding(mesh))

    op_hi = op_df if precision == "tf" else op
    jitted = jax.jit(solve_fn)
    solve = lambda b: jitted(op_hi, op_lo, pc_state, b)
    _t0 = time.perf_counter()
    jax.block_until_ready(jax.tree.leaves(op))
    if breakdown:
        breakdown["operator_drain"] = round(time.perf_counter() - _t0, 4)
    t_setup = time.perf_counter() - t0 + t_setup_seed
    if breakdown:
        # make the sub-phases sum to t_setup: the remainder is executor
        # plumbing (sharding placement, jit wrapper construction, syncs)
        breakdown["other_plumbing"] = round(
            max(0.0, t_setup - sum(breakdown.values())), 4
        )

    if warmup:
        out = solve(b)
        float((out[0] if (monitor or eigs) else out).resnorm)

    t0 = time.perf_counter()
    res = solve(b)
    hist = spec = None
    if monitor:
        res, hist = res
    elif eigs:
        res, spec = res
    resnorm = float(res.resnorm)
    t_solve = time.perf_counter() - t0

    reason = int(res.reason)
    if reason < 0:
        raise DivergedError(f"Diverged reason: {reason}")

    eig_list = None
    if spec is not None:
        from tpusparse.solve.spectrum import ritz_values

        eig_list = [
            float(v) for v in ritz_values(
                np.asarray(spec[0]), np.asarray(spec[1]), int(res.iters)
            )
        ]

    view_text = None
    if view:
        lines = [
            f"KSP Object: type {ksp}, rtol {rtol:g}, atol {atol:g},"
            f" maxit {maxiter}",
            f"  precision: {precision}",
        ]
        if view_extra:
            lines.append(f"  {view_extra}")
        if pc == "gamg":
            from tpusparse.amg.hierarchy import hierarchy_summary

            lines.append(hierarchy_summary(pc_state))
        else:
            lines.append(f"PC Object: type {pc}")
        view_text = "\n".join(lines)

    history = None
    if hist is not None:
        # trim to the recorded prefix: outer sweeps for mixed precision
        # (RefinedResult), plain iterations otherwise
        count = int(getattr(res, "outer_iters", None) or res.iters)
        history = [float(v) for v in np.asarray(hist)[: count + 1]]

    linf = float(jnp.abs(res.x - exact).max()) if check_error else float("nan")
    return SolveReport(
        nx=nx, ny=ny, nz=nz,
        iters=int(res.iters),
        resnorm=resnorm,
        linf_error=linf,
        reason=reason,
        t_init=t_init,
        t_setup=t_setup,
        t_solve=t_solve,
        rtol=rtol,
        atol=atol,
        pc=pc,
        precision=precision,
        mat_type=mat_type,
        outer_iters=int(getattr(res, "outer_iters", 0)),
        residual_history=history,
        solver_view=view_text,
        setup_breakdown={
            k: round(v, 4) for k, v in breakdown.items()
        } or None,
        eigenvalues=eig_list,
        devices=len(res.x.sharding.device_set),
    )


def _solve_poisson_aij(
    nx: int,
    ny: int,
    nz: int,
    *,
    rtol: float,
    atol: float,
    maxiter: int,
    pc: str,
    divtol: float = 1e5,
    amg_params: AMGParams | None,
    precision: str,
    warmup: bool,
    check_error: bool,
    n_devices: int,
    ksp: str,
    mg_cycle: str,
    monitor: bool,
    view: bool,
    ksp_gmres_restart: int,
    ksp_richardson_scale: float,
    aggregation: str = "auto",
    extent: tuple[float, float, float] | None = None,
    assembly: str = "auto",
    structure_detect: bool = True,
    compute_eigenvalues: bool = False,
) -> SolveReport:
    """The general-matrix driver: the manufactured Poisson system ASSEMBLED
    as an arbitrary host CSR (MATAIJ parity — the reference's actual matrix
    type, ``DMSetMatType(MATAIJ)`` /root/reference/src/helper.cpp:39, solved
    through PETSc's patched general-CSR kernel
    ``src/openacc-step1/MatMult_SeqAIJ.patch:19-30``), then solved through
    gather-free DIA containers + unstructured smoothed-aggregation GAMG.

    Same phase protocol and output contract as the stencil driver
    (src/main_ksp.cpp:80-129): init = system assembly (ON DEVICE by
    default — ``poisson_dia_device``; ``assembly='host'`` forces the
    HostCSR oracle route), setup = GAMG hierarchy build (with a sub-phase
    breakdown in the JSON sidecar), solve = the pre-compiled solve.
    """
    import numpy as np

    from tpusparse.amg.unstructured import gamg_setup_unstructured
    from tpusparse.grid.poisson import assemble_poisson, poisson_dia_device
    from tpusparse.sparse.dia import DIA

    if precision not in ("mixed", "f64", "f32"):
        raise ValueError(
            f"mat_type=aij supports precision mixed|f64|f32, got {precision!r}"
        )
    if n_devices != 1 and not structure_detect:
        # the sharded GENERAL executor lives in dist.general (DistDIA /
        # DistHybridDIA, exercised by __graft_entry__.dryrun_multichip);
        # through THIS driver, multi-device aij requires the star lift —
        # proven-structured matrices ride the structured sharded pipeline
        raise NotImplementedError(
            "mat_type=aij multi-device driver requires structure_detect"
            " (general path: use dist.general.DistDIA)"
        )
    mixed = precision == "mixed"
    hi_dtype = np.float32 if precision == "f32" else np.float64
    if hi_dtype == np.float64 and not jax.config.jax_enable_x64:
        raise RuntimeError("enable jax_enable_x64 before building f64 systems")
    lo_dtype = np.float32
    ksp_solve = _pick_ksp(ksp, precision, ksp_gmres_restart,
                          ksp_richardson_scale)
    if mg_cycle not in ("v", "w"):
        raise ValueError(f"unknown mg_cycle {mg_cycle!r}")
    gamma = 1 if mg_cycle == "v" else 2

    # runtime bring-up outside the timed phases (PetscInitialize analogue)
    float(jax.jit(lambda: jnp.zeros(()))())

    if assembly not in ("auto", "device", "host"):
        raise ValueError(f"unknown assembly {assembly!r}")
    if assembly == "device" and not mixed:
        raise ValueError("assembly='device' requires precision='mixed'")
    if assembly == "device" and pc == "gamg" and (
        aggregation == "greedy" or (amg_params or AMGParams()).bjacobi_bs
    ):
        raise ValueError(
            "assembly='device' leaves no host CSR, but greedy aggregation"
            " / bjacobi_bs require one — use assembly='host'"
        )

    params = amg_params or AMGParams()
    # the fully device-resident setup route (no host matrix anywhere) is
    # taken only by the geometric compiled path, which additionally
    # requires bjacobi_bs == 0 (unstructured.py geo gate) — a device
    # assembly outside that route would leave greedy aggregation with no
    # host CSR to chew on
    geo_route = (
        pc != "gamg"
        or (aggregation != "greedy" and params.bjacobi_bs == 0)
    )
    t0 = time.perf_counter()
    lx, ly, lz = extent or (1.0, 1.0, 1.0)
    grid = Grid3D(nx, ny, nz, lx=lx, ly=ly, lz=lz)
    on_device = assembly == "device" or (
        assembly == "auto" and mixed and geo_route
        and min(nx, ny, nz) >= 2
    )
    if on_device:
        # Assemble ON the accelerator (grid/poisson.poisson_dia_device):
        # exact two-float band split + f64 fields, zero O(n) host work.
        # The host CSR form of the SAME matrix used to cost ~100 s of
        # single-core numpy at 300^3 — the entire init phase.  The setup
        # that follows is the device-resident geometric path, so no stage
        # needs a host matrix; ``assembly='host'`` keeps the original
        # HostCSR route as the parity oracle (and the only route for
        # greedy aggregation, whose graph pass is host-side).
        a = None
        op_hi, op_lo, b, exact = poisson_dia_device(grid)
    else:
        a, b_np, exact_np = assemble_poisson(grid, dtype=hi_dtype)
        b = jnp.asarray(b_np)
        exact = jnp.asarray(exact_np)
        if mixed:
            # ONE f32 upload serves both precisions: the f32 bands are the
            # hierarchy's fine operator AND the hi half of the two-float
            # outer operator (DFDIA); the lo half uploads only if A is not
            # exactly f32-representable.  A true-f64 band upload would cost
            # 8 B/entry of transfer AND HBM traffic (1.5 GB at 300^3).
            from tpusparse.sparse.dia import DFDIA

            bands64, offsets_, shp = DIA.host_bands(a)
            bands32_dev = jax.device_put(bands64.astype(np.float32))
            op_lo = DIA(bands=bands32_dev, offsets=offsets_, shape=shp)
            op_hi = DFDIA.from_host_bands(
                bands64, offsets_, shp, hi_dev=bands32_dev,
            )
        else:
            op_hi = op_lo = DIA.from_csr(a)
    jax.block_until_ready(b)
    t_init = time.perf_counter() - t0

    lift_overhead = 0.0  # failed-proof time, charged to the setup phase
    if (
        structure_detect and pc == "gamg"
        and aggregation != "greedy"  # explicit greedy = explicit request
        # for the unstructured machinery; detection is "auto" behavior
    ):
        # Structure detection (sparse/starlift.py): PROVE the assembled
        # matrix is an exact constant-coefficient 7-point star (+ pin) and,
        # on success, run the structured pipeline (StarStencil3D + the
        # structured GAMG hierarchy) instead of the generic banded
        # executor.  This is what a structure-aware Mat
        # implementation does with the reference's own benchmark matrix
        # (DMDA Poisson forced into MATAIJ, src/helper.cpp:39); matrices
        # that fail the proof keep the general DIA path below.  The proof
        # cost (one pass over the band data + a scalar fetch) is charged
        # to the setup phase.
        from tpusparse.sparse.starlift import star_lift

        if warmup:
            # proof-program build outside the timed phase (same prebuilt-
            # binaries protocol as every other phase); the timed call
            # below hits the in-process jit cache and measures the
            # one-band-pass numeric proof
            star_lift(op_lo, op_hi, grid.shape)
        _t0 = time.perf_counter()
        lifted = star_lift(op_lo, op_hi, grid.shape)
        lift_s = time.perf_counter() - _t0
        if lifted is not None:
            star_hi, star_lo = lifted
            return _setup_and_solve(
                op=star_hi, op_lo=star_lo,
                b=b.reshape(grid.shape), exact=exact.reshape(grid.shape),
                nx=nx, ny=ny, nz=nz, t_init=t_init, mixed=mixed,
                precision=precision, pc=pc, pc_dtype="f32",
                mg_cycle=mg_cycle, amg_params=params, rtol=rtol,
                atol=atol, divtol=divtol, maxiter=maxiter, ksp=ksp,
                ksp_solve=ksp_solve,
                monitor=monitor, view=view, warmup=warmup,
                n_devices=n_devices,
                check_error=check_error, mat_type="aij",
                view_extra=(
                    "mat structure: constant-coefficient star DETECTED"
                    " (exact proof) -> structured executor"
                ),
                breakdown={"star_lift": round(lift_s, 4)},
                t_setup_seed=lift_s,
                eigs=compute_eigenvalues,
            )
        lift_overhead = lift_s

    if n_devices != 1:
        raise NotImplementedError(
            "mat_type=aij multi-device: the matrix did not prove star-"
            "structured (or pc/aggregation preclude the lift) — use "
            "dist.general.DistDIA for sharded general matrices"
        )

    eigs = compute_eigenvalues
    if eigs and (mixed or ksp != "cg" or monitor):
        import warnings

        warnings.warn(
            "-ksp_compute_eigenvalues needs uniform-precision -ksp_type cg"
            " without -ksp_monitor; skipping eigenvalue computation"
        )
        eigs = False
    if warmup and pc == "gamg" and geo_route:
        # Setup-program build outside the timed phase (same protocol as
        # the structured driver and the solve phase: the reference's
        # KSPSetUp runs prebuilt binaries, so timed setup = numeric work).
        # The pre-run pays every JIT trace + executable transport; the
        # timed re-run below executes the in-process-cached programs.
        # Geo-compiled route ONLY: the greedy/host route's dominant cost
        # is host-side scipy aggregation + Galerkin, which no cache
        # covers — a pre-run there would double total setup wall time.
        _pre = gamg_setup_unstructured(
            a, params, dtype=lo_dtype if mixed else None,
            timings={}, aggregation=aggregation, fine_op=op_lo,
        )
        jax.block_until_ready(_pre.levels[-1].rho)
        del _pre

    t0 = time.perf_counter() - lift_overhead
    breakdown: dict = {}
    if lift_overhead:
        breakdown["star_lift_refused"] = round(lift_overhead, 4)
    if pc == "gamg":
        pc_state = gamg_setup_unstructured(
            a, params, dtype=lo_dtype if mixed else None,
            timings=breakdown, aggregation=aggregation,
            fine_op=op_lo,
        )
        op_lo = pc_state.levels[0].op
        m_of = lambda pc_state: (
            lambda r: vcycle(pc_state, r, gamma=gamma)
        )
    elif pc == "jacobi":
        diag = (
            op_lo.diagonal() if a is None
            else jnp.asarray(a.diagonal(), lo_dtype if mixed else hi_dtype)
        )
        pc_state = 1.0 / diag
        m_of = lambda pc_state: (lambda r: pc_state * r)
    elif pc == "bjacobi":
        # standalone PCBJACOBI: batched inverted bs x bs diagonal blocks
        # (solve/bjacobi.py); bs = -pc_bjacobi_bs, 0 = the point-Jacobi
        # degeneracy (the one-block-per-process shape the reference's
        # sub-PC config reduces to)
        from tpusparse.solve.bjacobi import BlockJacobi

        bs = (amg_params or AMGParams()).bjacobi_bs
        if a is None:
            raise ValueError(
                "pc_type='bjacobi' needs the host CSR (assembly='host'"
                " or 'auto' with structure detection off keeps it)"
            )
        if bs and bs > 1:
            pc_state = BlockJacobi.build(
                a, bs, dtype=lo_dtype if mixed else hi_dtype
            )
            m_of = lambda pc_state: pc_state.apply
        else:
            pc_state = 1.0 / jnp.asarray(
                a.diagonal(), lo_dtype if mixed else hi_dtype
            )
            m_of = lambda pc_state: (lambda r: pc_state * r)
    elif pc == "none":
        pc_state = jnp.zeros(())
        m_of = lambda pc_state: None
    else:
        raise ValueError(f"unknown pc {pc!r}")

    if mixed:
        from tpusparse.solve.refine import cg_refined

        def solve_fn(op_hi, op_lo, pc_state, b):
            return cg_refined(
                op_hi.mv, op_lo.mv, b, rtol=rtol, atol=atol, divtol=divtol,
                m_lo_mv=m_of(pc_state), solver=ksp_solve, history=monitor,
            )
    else:
        def solve_fn(op_hi, op_lo, pc_state, b):
            kw = dict(history=monitor)
            if eigs:
                kw = dict(spectrum=True)
            return ksp_solve(
                op_hi.mv, b, rtol=rtol, atol=atol, divtol=divtol,
                maxiter=maxiter,
                m_mv=m_of(pc_state), **kw,
            )

    jitted = jax.jit(solve_fn)
    solve = lambda b: jitted(op_hi, op_lo, pc_state, b)
    float(jnp.sum(jax.tree.leaves(pc_state)[0]))  # sync setup products
    t_setup = time.perf_counter() - t0

    if warmup:
        out = solve(b)
        float((out[0] if (monitor or eigs) else out).resnorm)

    t0 = time.perf_counter()
    res = solve(b)
    hist = spec = None
    if monitor:
        res, hist = res
    elif eigs:
        res, spec = res
    resnorm = float(res.resnorm)
    t_solve = time.perf_counter() - t0

    reason = int(res.reason)
    if reason < 0:
        raise DivergedError(f"Diverged reason: {reason}")

    eig_list = None
    if spec is not None:
        from tpusparse.solve.spectrum import ritz_values

        eig_list = [
            float(v) for v in ritz_values(
                np.asarray(spec[0]), np.asarray(spec[1]), int(res.iters)
            )
        ]

    view_text = None
    if view:
        lines = [
            f"KSP Object: type {ksp}, rtol {rtol:g}, atol {atol:g},"
            f" maxit {maxiter}",
            f"  precision: {precision}, mat_type: aij"
            f" (DIA/HybridDIA containers)",
        ]
        if pc == "gamg":
            from tpusparse.amg.hierarchy import hierarchy_summary

            lines.append(hierarchy_summary(pc_state))
        else:
            lines.append(f"PC Object: type {pc}")
        view_text = "\n".join(lines)

    history = None
    if hist is not None:
        count = int(getattr(res, "outer_iters", None) or res.iters)
        history = [float(v) for v in np.asarray(hist)[: count + 1]]

    linf = float(jnp.abs(res.x - exact).max()) if check_error else float("nan")
    return SolveReport(
        nx=nx, ny=ny, nz=nz,
        iters=int(res.iters),
        resnorm=resnorm,
        linf_error=linf,
        reason=reason,
        t_init=t_init,
        t_setup=t_setup,
        t_solve=t_solve,
        rtol=rtol,
        atol=atol,
        pc=pc,
        precision=precision,
        outer_iters=int(getattr(res, "outer_iters", 0)),
        residual_history=history,
        solver_view=view_text,
        mat_type="aij",
        setup_breakdown={k: round(v, 4) for k, v in breakdown.items()} or None,
        eigenvalues=eig_list,
        devices=len(res.x.sharding.device_set),
    )


def solve_diffusion(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    *,
    contrast: float = 100.0,
    rtol: float = 1e-8,
    atol: float = 1e-12,
    divtol: float = 1e5,
    maxiter: int = 10000,
    precision: str = "mixed",
    amg_params: AMGParams | None = None,
    mg_cycle: str = "v",
    warmup: bool = True,
    view: bool = False,
) -> SolveReport:
    """The framework's SECOND problem family through the driver protocol:
    variable-coefficient diffusion -div(kappa grad u) = f with a
    ``contrast``-to-1 inclusion field (``grid/diffusion.py``) — the
    matrix the reference's constant-coefficient benchmark never produces
    (position-dependent stencil coefficients; the star-structure proof
    fails by construction and the VarStencil27 fine level exercises the
    probed Galerkin on variable coefficients).

    The correctness gate is ALGEBRAIC: exact = smooth manufactured field,
    b = A exact computed in f64, Linf measured against exact — solver
    accuracy, not discretization error.  Phases follow
    ``main_ksp.cpp:80-106``.
    """
    import time

    from tpusparse.amg.hierarchy import gamg_setup_compiled
    from tpusparse.grid.diffusion import assemble_diffusion, default_kappa
    from tpusparse.solve.refine import cg_refined

    ny = ny or nx
    nz = nz or nx
    if precision not in ("mixed", "f64", "f32"):
        raise ValueError(
            f"problem=diffusion supports precision mixed|f64|f32,"
            f" got {precision!r}"
        )
    mixed = precision == "mixed"
    hi_dtype = np.float32 if precision == "f32" else np.float64
    if hi_dtype == np.float64 and not jax.config.jax_enable_x64:
        raise RuntimeError("enable jax_enable_x64 before building f64 systems")
    params = amg_params or AMGParams()
    gamma = 1 if mg_cycle == "v" else 2

    float(jax.jit(lambda: jnp.zeros(()))())  # bring-up outside phases

    t0 = time.perf_counter()
    grid = Grid3D(nx, ny, nz)
    kappa = default_kappa(grid, contrast=contrast)
    op, _, _ = assemble_diffusion(grid, kappa, dtype=hi_dtype)
    op_lo = (
        assemble_diffusion(grid, kappa, dtype=np.float32)[0] if mixed
        else op
    )
    # algebraic manufactured solution: exact is smooth + zero at the pin
    zc, yc, xc = np.meshgrid(
        grid.cell_centers("z"), grid.cell_centers("y"),
        grid.cell_centers("x"), indexing="ij",
    )
    exact = jnp.asarray(
        np.cos(2 * np.pi * xc) * np.cos(2 * np.pi * yc)
        * np.cos(2 * np.pi * zc) - 1.0,   # zero at the pinned cell 0
        hi_dtype,
    )
    b = op.mv(exact)
    float(b.reshape(-1)[0])  # sync assembly+apply into t_init
    t_init = time.perf_counter() - t0

    if warmup:
        _pre = gamg_setup_compiled(op_lo, params)
        float(_pre.levels[-1].rho)
        del _pre
    t0 = time.perf_counter()
    hier = gamg_setup_compiled(op_lo, params)
    jax.block_until_ready(hier.levels[-1].rho)
    t_setup = time.perf_counter() - t0

    if mixed:
        def solve_fn(op, op_lo, hier, b):
            return cg_refined(
                op.mv, op_lo.mv, b, rtol=rtol, atol=atol, divtol=divtol,
                m_lo_mv=lambda r: vcycle(hier, r, gamma=gamma),
            )
    else:
        def solve_fn(op, op_lo, hier, b):
            return cg(
                op.mv, b, rtol=rtol, atol=atol, divtol=divtol,
                maxiter=maxiter,
                m_mv=lambda r: vcycle(hier, r, gamma=gamma),
            )
    jitted = jax.jit(solve_fn)
    if warmup:
        float(jitted(op, op_lo, hier, b).resnorm)
    t0 = time.perf_counter()
    res = jitted(op, op_lo, hier, b)
    resnorm = float(res.resnorm)
    t_solve = time.perf_counter() - t0
    if int(res.reason) < 0:
        raise DivergedError(f"Diverged reason: {int(res.reason)}")

    view_text = None
    if view:
        from tpusparse.amg.hierarchy import hierarchy_summary

        view_text = "\n".join([
            f"KSP Object: type cg, rtol {rtol:g}, atol {atol:g},"
            f" maxit {maxiter}",
            f"  precision: {precision}, problem: diffusion"
            f" (contrast {contrast:g}, VarStencil27 fine level)",
            hierarchy_summary(hier),
        ])

    return SolveReport(
        nx=nx, ny=ny, nz=nz,
        iters=int(res.iters),
        resnorm=resnorm,
        linf_error=float(jnp.abs(res.x - exact).max()),
        reason=int(res.reason),
        t_init=t_init,
        t_setup=t_setup,
        t_solve=t_solve,
        rtol=rtol,
        atol=atol,
        pc="gamg",
        precision=precision,
        outer_iters=int(getattr(res, "outer_iters", 0)),
        mat_type="varstencil",
        solver_view=view_text,
        source=f"diffusion(contrast={contrast:g})",
    )


def solve_from_file(
    path: str,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    divtol: float = 1e5,
    maxiter: int = 10000,
    ksp: str = "cg",
    pc: str = "gamg",
    precision: str = "mixed",
    amg_params: AMGParams | None = None,
    mg_cycle: str = "v",
    ksp_gmres_restart: int = 30,
    ksp_richardson_scale: float = 1.0,
    view: bool = False,
    solution_out: str = "",
) -> SolveReport:
    """Solve a system read from a file — PETSc KSP tutorial ``ex10`` ("solve
    a linear system from a file") with ``MatLoad``/``VecLoad`` parity.

    ``solution_out``: write the solution vector to this path in PETSc
    binary format after a successful solve (``-ksp_view_solution
    binary:<file>`` — loadable by PETSc's ``VecLoad`` or
    ``sparse.io.load_petsc_vec`` here).

    ``path`` is a PETSc binary viewer file (``sparse/io.py``; the format
    ``-ksp_view_mat binary`` writes) or a MatrixMarket ``.mtx``.  Objects in
    a PETSc file, in order: the matrix, optionally the right-hand side,
    optionally the exact solution (then the report gates Linf against it —
    the manufactured-solution check of ``main_ksp.cpp:120-121``).  A file
    with no rhs gets b = ones, ex10's fallback.

    Phases mirror the reference protocol (``main_ksp.cpp:80-106``): t_init =
    file read + upload, t_setup = KSPSetUp (hierarchy build), t_solve = a
    warm KSPSolve (the compile belongs to setup, as in the Poisson driver).
    """
    import time

    from tpusparse.ksp import KSP
    from tpusparse.sparse.csr import HostCSR
    from tpusparse.sparse.io import load_matrix, read_petsc_objects

    t0 = time.perf_counter()
    exact = None
    if path.endswith((".mtx", ".mtx.gz", ".mm")):
        a, rhs = load_matrix(path)
    else:
        objs = read_petsc_objects(path)
        a = next((o for o in objs if isinstance(o, HostCSR)), None)
        if a is None:
            raise ValueError(f"no matrix object in {path}")
        vecs = [o for o in objs if not isinstance(o, HostCSR)]
        rhs = vecs[0] if vecs else None
        exact = vecs[1] if len(vecs) > 1 else None
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"matrix is {a.shape[0]} x {a.shape[1]}, not square")
    if rhs is not None and rhs.size != a.shape[0]:
        raise ValueError(f"rhs length {rhs.size} != rows {a.shape[0]}")
    b_host = np.ones(a.shape[0]) if rhs is None else rhs

    solver = KSP(
        ksp_type=ksp, pc_type=pc, rtol=rtol, atol=atol, divtol=divtol,
        maxiter=maxiter,
        precision=precision, amg_params=amg_params, mg_cycle=mg_cycle,
        gmres_restart=ksp_gmres_restart,
        richardson_scale=ksp_richardson_scale,
    )
    solver.set_operators(a)
    b = jnp.asarray(
        b_host,
        dtype=jnp.float32 if precision == "f32" else jnp.float64,
    )
    float(b[0])  # sync the upload into t_init
    t_init = time.perf_counter() - t0

    t0 = time.perf_counter()
    solver.setup()
    t_setup = time.perf_counter() - t0

    res = solver.solve(b)  # warmup carries the jit compile (KSPSetUp-like)
    t0 = time.perf_counter()
    res = solver.solve(b)
    t_solve = time.perf_counter() - t0

    if res.reason < 0:
        raise DivergedError(f"Diverged reason: {res.reason}")

    if solution_out:
        from tpusparse.sparse.io import save_petsc_vec

        save_petsc_vec(solution_out, np.asarray(res.x, dtype=np.float64))

    view_text = None
    if view:
        lines = [
            f"KSP Object: type {ksp}, rtol {rtol:g}, atol {atol:g},"
            f" maxit {maxiter}",
            f"  precision: {precision}, mat_type: aij"
            f" (loaded from {path})",
        ]
        if pc == "gamg":
            from tpusparse.amg.hierarchy import hierarchy_summary

            lines.append(hierarchy_summary(solver._pc_state))
        else:
            lines.append(f"PC Object: type {pc}")
        view_text = "\n".join(lines)

    linf = (
        float(jnp.abs(res.x - jnp.asarray(exact, res.x.dtype)).max())
        if exact is not None else -1.0
    )
    return SolveReport(
        nx=a.shape[0], ny=a.shape[1], nz=1,
        iters=res.iters,
        resnorm=res.resnorm,
        linf_error=linf,
        reason=res.reason,
        t_init=t_init,
        t_setup=t_setup,
        t_solve=t_solve,
        rtol=rtol,
        atol=atol,
        pc=pc,
        precision=precision,
        outer_iters=res.outer_iters,
        mat_type="aij",
        solver_view=view_text,
        source=path,
        source_is_file=True,
    )
