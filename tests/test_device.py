"""Device reporting of the measurement scripts, and their refusal to run a
measurement anywhere but on a GPU."""

import runpy
import sys
from pathlib import Path

import pytest

from tpusparse.bench.device import (
    describe_device,
    peak_bytes_in_use,
    require_gpu,
)

ROOT = Path(__file__).resolve().parents[1]


def test_describe_device_names_platform_kind_count():
    dev = describe_device()
    assert dev["platform"] == "cpu" and dev["count"] >= 1
    assert isinstance(dev["kind"], str) and dev["kind"]


def test_require_gpu_exits_nonzero_on_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        require_gpu("probe")
    assert exc.value.code != 0
    assert "no GPU" in capsys.readouterr().err


def test_peak_bytes_not_available_on_cpu():
    assert peak_bytes_in_use() is None


@pytest.mark.parametrize("script", ["bench.py", "bench_aij.py"])
def test_bench_scripts_refuse_cpu(script, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [script])
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(str(ROOT / script), run_name="__main__")
    assert exc.value.code != 0
    assert "{" not in capsys.readouterr().out
