"""CLI driver — parity with the reference's benchmark binary.

Usage (mirrors ``aprun -n N bin/<exe> -da_grid_x 300 -config file.info``,
``runs/single-node-scaling.pbs:56-67``):

    python -m tpusparse -da_grid_x 300 -da_grid_y 300 -da_grid_z 300 \
        -config configs/SolverOptions_GAMG.info

Prints the reference's output block (``src/main_ksp.cpp:124-129``) plus a
JSON sidecar line prefixed with ``JSON:`` (SURVEY.md section 5.5: the text
format was the metrics API; we keep it AND emit structured data).
"""

from __future__ import annotations

import sys

import jax

from tpusparse.utils.compile_cache import enable_compile_cache

jax.config.update("jax_enable_x64", True)


def _viewer_file(spec: str) -> str:
    """Parse a PETSc viewer spec of the 'binary:<filename>' shape."""
    if not spec:
        return ""
    fmt, _, fname = spec.partition(":")
    if fmt != "binary" or not fname:
        raise ValueError(f"{spec!r}: expected 'binary:<filename>'")
    return fname


def _options_left(opts) -> None:
    """-options_left (PetscOptionsLeft): report never-consumed options at
    the end of the run."""
    if getattr(opts, "options_left", 0):
        from tpusparse.config.options import options_left_report

        print(options_left_report(opts))


def main(argv: list[str] | None = None) -> int:
    from tpusparse.bench.driver import solve_poisson
    from tpusparse.config import load_options

    from tpusparse.utils.profiling import trace

    args = argv if argv is not None else sys.argv[1:]
    if "-help" in args or "--help" in args:
        # PETSc prints its options database under -help
        from tpusparse.config.options import help_text

        print(help_text())
        return 0
    opts = load_options(args)
    if opts.mat_view and not opts.f:
        # -mat_view binary:<file> (MatView parity): write the assembled
        # system — matrix, rhs, exact solution — as PETSc binary objects.
        # The file round-trips: solvable via -f here, or MatLoad in PETSc.
        fname = _viewer_file(opts.mat_view)
        if opts.problem != "poisson":
            # the export below assembles the POISSON system; writing it
            # during a different problem's run would hand the user a file
            # that does not match the solve they exported from
            raise ValueError(
                "-mat_view export supports -problem poisson only (the"
                f" requested problem is {opts.problem!r})"
            )
        from tpusparse.grid.grid3d import Grid3D
        from tpusparse.grid.poisson import assemble_poisson
        from tpusparse.sparse.io import save_petsc_mat, save_petsc_vec

        a, rhs, exact = assemble_poisson(
            Grid3D(opts.da_grid_x, opts.da_grid_y, opts.da_grid_z)
        )
        save_petsc_mat(fname, a)
        save_petsc_vec(fname, rhs, append=True)
        save_petsc_vec(fname, exact, append=True)
        print(
            f"Mat Object: {a.shape[0]} x {a.shape[1]}, nnz {a.nnz} "
            f"written to {fname} (PETSc binary; + rhs and exact vectors)"
        )
    if opts.f:
        # -f <file>: PETSc KSP ex10 parity — solve a system loaded from a
        # PETSc-binary / MatrixMarket file (MatLoad/VecLoad, sparse/io.py)
        from tpusparse.bench.driver import solve_from_file

        with trace(opts.profile):
            rep = solve_from_file(
                opts.f,
                rtol=opts.ksp_rtol,
                atol=opts.ksp_atol,
                divtol=opts.ksp_divtol,
                maxiter=opts.ksp_max_it,
                ksp=opts.ksp_type,
                pc=opts.pc_type,
                precision=opts.precision,
                amg_params=(
                    opts.amg_params() if opts.pc_type == "gamg" else None
                ),
                mg_cycle=opts.pc_mg_cycle_type,
                ksp_gmres_restart=opts.ksp_gmres_restart,
                ksp_richardson_scale=opts.ksp_richardson_scale,
                view=opts.ksp_view,
                solution_out=_viewer_file(opts.ksp_view_solution),
            )
        if opts.ksp_view and rep.solver_view:
            print(rep.solver_view)
        if opts.ksp_converged_reason:
            print(rep.converged_reason_line())
        print(rep.reference_block())
        print("JSON:", rep.json_sidecar())
        _options_left(opts)
        return 0
    if opts.problem == "diffusion":
        # -problem diffusion: the second problem family (variable-
        # coefficient operator; star detection fails by construction).
        # The diffusion driver is cg+gamg; silently substituting the
        # method a user explicitly asked for would violate the options
        # policy (config/options.py::validate) — error, stating why.
        provided = getattr(opts, "_provided", ())
        if "ksp_type" in provided and opts.ksp_type != "cg":
            raise ValueError(
                f"-problem diffusion runs -ksp_type cg (got"
                f" {opts.ksp_type!r}); other Krylov methods are not wired"
                " to the diffusion driver"
            )
        if "pc_type" in provided and opts.pc_type != "gamg":
            raise ValueError(
                f"-problem diffusion runs -pc_type gamg (got"
                f" {opts.pc_type!r})"
            )
        if opts.ksp_monitor or opts.ksp_compute_eigenvalues:
            import warnings

            warnings.warn(
                "-ksp_monitor/-ksp_compute_eigenvalues are not wired to"
                " the diffusion driver; ignoring"
            )
        from tpusparse.bench.driver import solve_diffusion

        with trace(opts.profile):
            rep = solve_diffusion(
                opts.da_grid_x, opts.da_grid_y, opts.da_grid_z,
                contrast=opts.diffusion_contrast,
                rtol=opts.ksp_rtol, atol=opts.ksp_atol,
                divtol=opts.ksp_divtol, maxiter=opts.ksp_max_it,
                precision=opts.precision,
                amg_params=opts.amg_params(),
                mg_cycle=opts.pc_mg_cycle_type,
                view=opts.ksp_view,
            )
        if opts.ksp_view and rep.solver_view:
            print(rep.solver_view)
        if opts.ksp_converged_reason:
            print(rep.converged_reason_line())
        print(rep.reference_block())
        print("JSON:", rep.json_sidecar())
        _options_left(opts)
        return 0
    if opts.problem != "poisson":
        raise ValueError(
            f"unknown -problem {opts.problem!r} (poisson | diffusion)"
        )
    if (
        opts.pc_type == "gamg"
        and opts.mg_levels_ksp_type == "richardson"
        and opts.mg_levels_ksp_max_it == 1
    ):
        # the verbatim reference config's smoother
        # (configs/PETSc_SolverOptions_GAMG.info:10-21) is honored exactly,
        # but it is the slow choice on this hierarchy (root-caused to the
        # smoother by the eigen-oracle in tests/test_amg_quality.py); PETSc
        # stays silent here, we say so once
        print(
            "hint: -mg_levels_ksp_type richardson -mg_levels_ksp_max_it 1"
            " (the reference config's smoother) needs ~20x the inner"
            " iterations of this framework's default chebyshev(2) smoother"
            " at 300^3 (824 vs 35 on an H100); drop those two options to"
            " use the default", file=sys.stderr,
        )
    with trace(opts.profile):  # Score-P/nvprof-parity trace when -profile set
        rep = solve_poisson(
            opts.da_grid_x,
            opts.da_grid_y,
            opts.da_grid_z,
            rtol=opts.ksp_rtol,
            atol=opts.ksp_atol,
            divtol=opts.ksp_divtol,
            maxiter=opts.ksp_max_it,
            pc=opts.pc_type,
            # always built: non-gamg PCs read pc_bjacobi_bs etc. from it
            amg_params=opts.amg_params(),
            n_devices=opts.devices,
            precision=opts.precision,
            ksp=opts.ksp_type,
            pc_dtype=opts.pc_dtype,
            mg_cycle=opts.pc_mg_cycle_type,
            monitor=opts.ksp_monitor,
            ksp_richardson_scale=opts.ksp_richardson_scale,
            view=opts.ksp_view,
            ksp_gmres_restart=opts.ksp_gmres_restart,
            mat_type=opts.mat_type,
            aggregation=opts.pc_gamg_aggregation,
            structure_detect=bool(opts.mat_structure_detect),
            compute_eigenvalues=opts.ksp_compute_eigenvalues,
        )
    if opts.ksp_view and rep.solver_view:
        print(rep.solver_view)
    if opts.ksp_monitor:
        # PETSc streams these during KSPSolve; our solve is one compiled
        # program, so the recorded history prints before the summary block
        print(rep.monitor_block())
    if opts.ksp_converged_reason:
        # PETSc prints this line from KSPSolve when -ksp_converged_reason
        # is set (KSPConvergedReasonView) — after the solve, before the
        # driver's own summary block
        print(rep.converged_reason_line())
    if opts.ksp_compute_eigenvalues and rep.eigenvalues:
        print(rep.eigenvalues_block())
    print(rep.reference_block())
    if opts.log_view:
        print(rep.log_view())
    print("JSON:", rep.json_sidecar())
    _options_left(opts)
    return 0


if __name__ == "__main__":
    enable_compile_cache()
    raise SystemExit(main())
