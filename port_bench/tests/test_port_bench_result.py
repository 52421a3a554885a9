"""The last line's shape, the refusal without a card, and (on the card
alone) a whole run of the first cell."""

import json
import os
import subprocess
import sys

import pytest

from port_bench import cell as C

ROOT = os.path.dirname(C.HERE)


def test_result_line_shape(tiny):
    result, lines = tiny("b1_1hz", 0.125, 2 ** 32 + 3)
    assert list(result)[:3] == ["correct", "attempted", "failed"]
    assert list(result)[-1] == "checks"
    assert set(result) == {"correct", "attempted", "failed", "metrics",
                           "device", "route", "kernel_build_s", "checks"}
    assert result["route"] == "torch_plain"
    assert result["kernel_build_s"] == 0.0
    assert set(result["metrics"]) == {"elem_updates_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for name, v, limit, good in lines:
        assert result["checks"][name] == {"value": v, "limit": limit}
    json.dumps(result)


def test_traced_result_line_shape(tiny):
    result, _ = tiny("loh1_4hz", 1.0, 2 ** 32 + 4, trace=1)
    assert set(result) == {"correct", "attempted", "failed", "metrics",
                           "device", "breakdown", "route", "kernel_build_s",
                           "checks"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    # on the CPU the trace has no device operation: the device metrics
    # find nothing to read and are left out, the program's spans are read
    assert set(result["metrics"]) == {"setup.mesh_s",
                                      "setup.plan_tables_s",
                                      "setup.assemble_s",
                                      "setup.source_forces_s"}


def test_no_card_no_result():
    """Without enough CUDA devices the run exits non-zero and prints no
    result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "-m", "port_bench.run",
                        "--workload", "b1_1hz.stations", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_manifest_no_result(tmp_path):
    """In a directory without BENCHMARK.json the run exits non-zero."""
    import shutil
    shutil.copytree(C.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "port_bench.run",
                        "--workload", "b1_1hz.stations", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_first_cell_on_the_card():
    """One short run of b1_1hz.stations on the card: correct, every
    end-to-end metric, the card's name."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "port_bench.run",
                        "--workload", "b1_1hz.stations", "--seed",
                        str(2 ** 31 + 9), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"elem_updates_per_s", "setup_s"}
