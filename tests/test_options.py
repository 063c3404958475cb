"""Options parsing tests — the reference's own config file must load."""

import shutil
from pathlib import Path

import pytest

from tpusparse.config import load_options, parse_options_file

REF_CONFIG = Path(__file__).parent / "data" / "SolverOptions_GAMG.info"


def test_reference_config_parses(tmp_path):
    opts = load_options(["-config", str(REF_CONFIG)])
    assert opts.ksp_type == "cg"
    assert opts.ksp_atol == 1e-12
    assert opts.ksp_rtol == 1e-14
    assert opts.ksp_max_it == 10000
    assert opts.pc_type == "gamg"
    assert opts.pc_gamg_agg_nsmooths == 1
    assert opts.pc_gamg_threshold == 0.0
    assert opts.mg_levels_ksp_type == "richardson"


def test_cli_overrides_file():
    opts = load_options(
        ["-config", str(REF_CONFIG), "-ksp_rtol", "1e-8", "-da_grid_x", "300"]
    )
    assert opts.ksp_rtol == 1e-8
    assert opts.da_grid_x == 300
    assert opts.da_grid_y == 100  # untouched default (main_ksp.cpp:33-35)


def test_unknown_option_warns_and_is_ignored():
    """PETSc ignores unused options — a reference user's richer config file
    must still run (only a warning so typos stay visible)."""
    with pytest.warns(UserWarning, match="no_such_thing"):
        opts = load_options(["-no_such_thing", "1", "-ksp_rtol", "1e-9"])
    assert opts.ksp_rtol == 1e-9


def test_petsc_style_file_with_extra_options(tmp_path):
    """A PETSc-era config carrying options we don't model parses with a
    warning; the modeled options take effect."""
    p = tmp_path / "rich.info"
    p.write_text(
        "-ksp_type cg\n-ksp_rtol 1e-10\n"
        "-pc_gamg_square_graph 1\n-mg_levels_esteig_ksp_type cg\n"
        "-ksp_norm_type unpreconditioned\n"
    )
    with pytest.warns(UserWarning, match="pc_gamg_square_graph"):
        opts = load_options(["-config", str(p)])
    assert opts.ksp_rtol == 1e-10


def test_unsupported_value_rejected():
    with pytest.raises(ValueError, match="ksp_type"):
        load_options(["-ksp_type", "tfqmr"])


def test_negative_option_values():
    """PETSc accepts negative values (the reference's own DMDA sentinels are
    negative); '-1e-8'-style tokens are values, not option keys."""
    opts = load_options(["-ksp_atol", "-1", "-mg_levels_ksp_richardson_scale",
                         "-0.5"])
    assert opts.ksp_atol == -1.0
    assert opts.mg_levels_ksp_richardson_scale == -0.5


def test_malformed_syntax_still_hard_fails():
    with pytest.raises(ValueError, match="expected an option"):
        load_options(["ksp_rtol", "1e-9"])


def test_type_error_on_known_name_still_hard_fails():
    with pytest.raises(ValueError):
        load_options(["-ksp_max_it", "many"])


def test_richardson_preonly_accepted():
    assert load_options(["-ksp_type", "richardson"]).ksp_type == "richardson"
    assert load_options(["-ksp_type", "preonly"]).ksp_type == "preonly"


def test_ksp_monitor_flag():
    assert load_options([]).ksp_monitor is False
    assert load_options(["-ksp_monitor"]).ksp_monitor is True
    assert load_options(["-ksp_monitor", "false"]).ksp_monitor is False
    with pytest.raises(ValueError, match="boolean"):
        load_options(["-ksp_monitor", "maybe"])


def test_comments_and_blank_lines(tmp_path):
    p = tmp_path / "o.info"
    p.write_text("# comment\n\n-ksp_rtol 1e-9  # trailing\n-pc_type none\n")
    d = parse_options_file(p)
    assert d == {"ksp_rtol": "1e-9", "pc_type": "none"}


def test_help_flag(capsys):
    """-help prints the full options database (PETSc parity), generated
    from the dataclass so it cannot drift."""
    from tpusparse.__main__ import main

    rc = main(["-help"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "-ksp_rtol" in out and "-pc_gamg_agg_nsmooths" in out
    assert "-config <file>" in out


@pytest.mark.slow
def test_per_level_smoother_specs():
    """-mg_levels_<N>_ksp_type / -mg_levels_<N>_ksp_max_it (PETSc per-level
    PCMG smoother configuration, round-4 verdict item 7): parsed into
    AMGParams.level_spec and honored by the V-cycle."""
    import jax.numpy as jnp
    import numpy as np

    from tpusparse.amg.hierarchy import gamg_setup, vcycle
    from tpusparse.config.options import load_options
    from tpusparse.grid.grid3d import Grid3D
    from tpusparse.grid.poisson import poisson_stencil

    o = load_options([
        "-mg_levels_1_ksp_max_it", "4",
        "-mg_levels_2_ksp_type", "richardson",
    ])
    params = o.amg_params()
    assert params.level_spec == ((1, "", 4), (2, "richardson", 0))

    op, b, _e = poisson_stencil(Grid3D(18, 18, 18))
    hier = gamg_setup(op, params)
    assert hier.level_cfg(0) == ("chebyshev", 2)   # hierarchy-wide default
    assert hier.level_cfg(1) == ("chebyshev", 4)   # degree override
    assert hier.level_cfg(2) == ("richardson", 2)  # smoother override
    # the overridden cycle is still a working preconditioner
    from tpusparse.solve.cg import cg

    res = cg(op.mv, jnp.asarray(b), rtol=1e-8, maxiter=100,
             m_mv=lambda r: vcycle(hier, r))
    assert int(res.reason) > 0
    # and actually differs from the unoverridden cycle
    h0 = gamg_setup(op, o.amg_params().__class__())
    z0 = np.asarray(vcycle(h0, jnp.asarray(b)))
    z1 = np.asarray(vcycle(hier, jnp.asarray(b)))
    assert np.abs(z0 - z1).max() > 1e-12

    import pytest as _pytest

    with _pytest.raises(ValueError, match="per-level smoother"):
        load_options(["-mg_levels_1_ksp_type", "ilu"])


@pytest.mark.parametrize("value", ["padded", "plain", "auto"])
def test_removed_layout_option_is_rejected(value):
    """-layout chose the padded kernel layout, which no longer exists:
    setting it is an error that says so, not a silent no-op."""
    with pytest.raises(ValueError, match="layout.*removed"):
        load_options(["-layout", value])


def test_removed_layout_keyword_is_rejected():
    from tpusparse import KSP
    from tpusparse.bench.driver import solve_poisson

    with pytest.raises(TypeError, match="layout"):
        KSP(layout="padded")
    with pytest.raises(TypeError, match="layout"):
        solve_poisson(6, layout="padded")
