"""chip_smoke.py's phases at a tiny size on the CPU, its refusal to report
without a GPU, and the same checks at the reference's size on a GPU (marked
``gpu``: they skip here; ``python chip_smoke.py`` runs them on the card).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs

N = 12   # smallest grid with a three-level hierarchy


def _on_gpu() -> bool:
    return jax.devices()[0].platform == "gpu"


def test_linf_limit_scales_with_h_squared():
    assert cs.linf_limit(300) == pytest.approx(1e-4)
    assert cs.linf_limit(150) == pytest.approx(4e-4)


def test_phase_device_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.phase_device()
    assert exc.value.code != 0
    assert "platform=cpu" in capsys.readouterr().out


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_phase_headline_tiny(capsys):
    rep = cs.phase_headline(N, "cpu")
    assert rep.reason > 0 and rep.devices == 1
    out = capsys.readouterr().out
    assert "[b]" in out and "peak_bytes_in_use=not available" in out


def test_phase_reference_config_tiny():
    rep = cs.phase_reference_config(N, "cpu")
    assert rep["reason"] > 0
    assert rep["linf_error"] <= cs.linf_limit(N)


def test_phase_kernels_tiny():
    out = cs.phase_kernels(N, seed=0, card="cpu")
    assert out["stencil_float32"] <= cs.MV_TOL[np.float32]
    assert out["dia_float64"] <= cs.MV_TOL[np.float64]
    assert out["tT_apply"] <= cs.TRANSFER_TOL
    assert out["copy_GBps"] > 0


def test_phase_general_tiny():
    rep = cs.phase_general(N, "cpu")
    assert rep.reason > 0 and rep.mat_type == "aij"


def test_phase_four_on_four_virtual_devices():
    """--four's comparison on 4 of the suite's virtual CPU devices."""
    rep4, rep1 = cs.phase_four(N, "cpu")
    assert rep4.devices == 4 and rep1.devices == 1


def test_phase_check_raises():
    with pytest.raises(cs.SmokeFailure, match="boom"):
        cs._check(False, "boom")


@pytest.mark.parametrize("pinned", [True, False])
def test_star_mv_host_matches_stencil(pinned):
    from tpusparse.sparse.stencil import StarStencil3D

    rng = np.random.default_rng(0)
    diag = rng.uniform(-7, -5, (4, 5, 6))
    x = rng.uniform(-1, 1, (4, 5, 6))
    op = StarStencil3D(diag=jnp.asarray(diag), cx=jnp.asarray(1.1),
                       cy=jnp.asarray(0.9), cz=jnp.asarray(1.3),
                       pinned=pinned)
    ref = cs.star_mv_host(diag, 1.1, 0.9, 1.3, x, pinned)
    np.testing.assert_allclose(np.asarray(op.mv(jnp.asarray(x))), ref,
                               rtol=1e-14, atol=1e-13)


def test_host_csr_from_bands_matches_dia():
    from tpusparse.sparse.dia import DIA

    n = 4
    offsets = cs.star7_offsets(n)
    rng = np.random.default_rng(1)
    bands = rng.uniform(-1, 1, (len(offsets), n ** 3))
    x = rng.uniform(-1, 1, n ** 3)
    a = cs.host_csr_from_bands(bands, offsets)
    # band k keeps the rows r with 0 <= r + offsets[k] < n^3
    assert a.nnz == 7 * n ** 3 - 2 * (1 + n + n * n)
    dia = DIA(bands=jnp.asarray(bands), offsets=offsets,
              shape=(n ** 3, n ** 3))
    np.testing.assert_allclose(a.mv(x), np.asarray(dia.mv(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.gpu
def test_headline_on_gpu():
    if not _on_gpu():
        pytest.skip("needs a GPU; python chip_smoke.py runs this on the card")
    rep = cs.phase_headline(300, cs.card_line())
    assert rep.reason > 0


@pytest.mark.gpu
def test_kernels_on_gpu():
    if not _on_gpu():
        pytest.skip("needs a GPU; python chip_smoke.py runs this on the card")
    out = cs.phase_kernels(300, seed=0, card=cs.card_line())
    assert json.dumps(out)
