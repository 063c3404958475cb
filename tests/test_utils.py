"""Unit coverage for the observability utilities: metrics, profiling,
scaling records + plot generation, multihost topology."""

import json
import time

import numpy as np
import pytest


def test_phase_timer_accumulates():
    from tpusparse.utils.metrics import PhaseTimer

    t = PhaseTimer()
    with t.start("a"):
        time.sleep(0.01)
    with t.start("a"):
        time.sleep(0.01)
    with t.start("b"):
        pass
    assert t.phases["a"] >= 0.02
    assert "b" in t.phases


def test_flop_and_traffic_models():
    from tpusparse.utils.metrics import (
        KernelStats,
        ell_mv_traffic,
        spmv_flops,
        stencil_mv_traffic,
    )

    # PETSc's MatMult model: 2*nnz - nonzero rows
    assert spmv_flops(100, 10) == 190
    assert stencil_mv_traffic(1000, 4) == 1000 * 4 * 3
    assert ell_mv_traffic(10, 7, 8) > stencil_mv_traffic(10, 8)
    s = KernelStats(name="k", seconds=0.001, flops=2e9, bytes=1e9, nnz=1e9)
    assert abs(s.gflops - 2000) < 1e-6
    assert abs(s.gb_s - 1000) < 1e-6
    assert "k:" in s.line()


def test_trace_noop_and_annotate():
    from tpusparse.utils.profiling import Stopwatch, annotate, trace

    with trace(None):  # falsy -> no-op
        pass
    with annotate("region"):
        pass
    sw = Stopwatch()
    for _ in range(3):
        with sw.lap():
            time.sleep(0.002)
    assert sw.best <= sw.mean


def test_scaling_efficiency_math():
    from tpusparse.bench.scaling import ScalingPoint, efficiency

    pts = [
        ScalingPoint(1, 32, 32, 32, t_solve=1.0, iters=10, linf_error=0, nnz=1000),
        ScalingPoint(2, 32, 32, 32, t_solve=0.5, iters=10, linf_error=0, nnz=1000),
        ScalingPoint(4, 32, 32, 32, t_solve=0.5, iters=10, linf_error=0, nnz=1000),
    ]
    eff = efficiency(pts, weak=False)
    assert abs(eff[1] - 1.0) < 1e-12
    assert abs(eff[2] - 1.0) < 1e-12   # perfect halving
    assert abs(eff[4] - 0.5) < 1e-12   # no further gain at 4

    # weak scaling: rate-based
    wpts = [
        ScalingPoint(1, 32, 32, 32, t_solve=1.0, iters=10, linf_error=0, nnz=1000),
        ScalingPoint(2, 32, 32, 64, t_solve=1.0, iters=10, linf_error=0, nnz=2000),
    ]
    weff = efficiency(wpts, weak=True)
    assert abs(weff[2] - 1.0) < 1e-12


def test_weak_scaling_projection_model():
    """comm_model: exact halo volumes from the sharding layout; the
    projected efficiency is 1.0 for one device and "not measured" where it
    would need an unmeasured link rate."""
    from tpusparse.bench.scaling import MODEL, ScalingPoint, comm_model

    pts = [
        ScalingPoint(1, 64, 64, 64, t_solve=1.0, iters=20, linf_error=0,
                     nnz=7 * 64 ** 3),
        ScalingPoint(2, 64, 64, 128, t_solve=1.0, iters=20, linf_error=0,
                     nnz=7 * 64 ** 2 * 128),
        ScalingPoint(8, 64, 128, 256, t_solve=1.0, iters=20, linf_error=0,
                     nnz=7 * 64 * 128 * 256),
    ]
    proj = comm_model(pts, t_iter_1dev=0.05)
    assert proj[0]["projected_efficiency"] == 1.0
    assert proj[0]["halo_bytes_per_iter"] == 0
    # 2 devices: (pz, py) = (2, 1): z-faces only, 2 planes of 64*64 f32
    want = 2 * 64 * 64 * 4 * MODEL["fine_applies_per_iter"]
    assert proj[1]["halo_bytes_per_iter"] == want
    # 8 devices (4, 2): both axes exchange, so the volume grows
    assert proj[2]["halo_bytes_per_iter"] > proj[1]["halo_bytes_per_iter"]
    # seam: one ring all-reduce of the n/27 coarse field
    n27 = 64 * 128 * 256 // MODEL["coarsen_ratio"]
    assert proj[2]["coarse_seam_bytes_per_iter"] == int(n27 * 4 * 2 * 7 / 8)
    assert [p["projected_efficiency"] for p in proj[1:]] == [
        "not measured", "not measured"]


@pytest.mark.slow
def test_plots_from_records(tmp_path):
    from tpusparse.bench.plots import plot_efficiency, plot_scaling

    rec = {
        "mode": "strong",
        "backend": "cpu",
        "points": [
            {"n_devices": 1, "t_solve": 1.0},
            {"n_devices": 2, "t_solve": 0.6},
        ],
        "efficiency": {1: 1.0, 2: 0.83},
    }
    p1 = plot_scaling([rec], tmp_path / "s.png")
    p2 = plot_efficiency([rec], tmp_path / "e.png")
    assert p1.exists() and p1.stat().st_size > 1000
    assert p2.exists() and p2.stat().st_size > 1000


def test_multihost_describe_single_process():
    from tpusparse.dist.multihost import describe, initialize

    initialize()  # idempotent no-op in single-process tests
    d = describe()
    assert d["process_count"] == 1
    assert d["global_devices"] >= 1


def test_scaling_json_roundtrip(tmp_path):
    from tpusparse.bench.scaling import ScalingPoint, save_json

    pts = [
        ScalingPoint(1, 16, 16, 16, t_solve=0.1, iters=5, linf_error=1e-3,
                     nnz=100),
    ]
    path = tmp_path / "rec.json"
    save_json(pts, "strong", path)
    rec = json.loads(path.read_text())
    assert rec["mode"] == "strong"
    assert rec["points"][0]["n_devices"] == 1
    assert "efficiency" in rec
