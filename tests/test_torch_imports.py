"""The port imports no jax, loads no kernel at import time, and never
falls back from a CUDA call to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from hercules_tpu_torch.kernels import build
from hercules_tpu_torch.kernels.bkt_chunk import bkt_chunk
from hercules_tpu_torch.kernels.bkt_corner_step import bkt_corner_step
from hercules_tpu_torch.kernels.bkt_node_step import (TAB_SIZE,
                                                      bkt_node_step)
from hercules_tpu_torch.kernels.bkt_step import bkt_step
from hercules_tpu_torch.kernels.brick_chunk import brick_chunk
from hercules_tpu_torch.kernels.brick_step import brick_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("hercules_tpu_torch", "hercules_tpu_torch.cli",
           "hercules_tpu_torch.sim", "hercules_tpu_torch.convert",
           "hercules_tpu_torch.fixtures",
           "hercules_tpu_torch.solver.assemble",
           "hercules_tpu_torch.solver.bricks",
           "hercules_tpu_torch.solver.chunking",
           "hercules_tpu_torch.solver.fused_brick",
           "hercules_tpu_torch.solver.fused_bkt",
           "hercules_tpu_torch.solver.fused_bktq",
           "hercules_tpu_torch.kernels.build",
           "hercules_tpu_torch.kernels.brick_step",
           "hercules_tpu_torch.kernels.brick_chunk",
           "hercules_tpu_torch.kernels.bkt_step",
           "hercules_tpu_torch.kernels.bkt_chunk",
           "hercules_tpu_torch.kernels.bkt_node_step",
           "hercules_tpu_torch.kernels.bkt_corner_step",
           "hercules_tpu_torch.utils.timers")


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from hercules_tpu_torch.kernels import build\n"
            "assert build._LIB is None, 'kernel library loaded at import'\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def _args(device):
    S = torch.zeros((8, 1024), device=device)
    K = torch.zeros((8, 1024), device=device)
    ops = torch.zeros((48, 24), device=device)
    return S, K, (0, 1, 17, 18, 289, 290, 306, 307), ops


def _launches():
    return (brick_step.launches, brick_chunk.launches, bkt_step.launches,
            bkt_chunk.launches, bkt_node_step.launches,
            bkt_corner_step.launches)


@pytest.mark.parametrize("call", ["brick_step", "brick_chunk", "bkt_step",
                                  "bkt_chunk", "bkt_node_step",
                                  "bkt_corner_step"])
def test_non_cpu_tensor_never_runs_plain(call):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    a device with no kernel raises instead of taking the plain
    version."""
    S, K, offs, ops = _args("meta")
    conv = torch.zeros((6, 1024), device="meta")
    fm = torch.zeros((24, 48), device="meta")
    rec = (0.0,) * 9
    srcf = torch.zeros((4, 3, 0), device="meta")
    before = _launches()
    with pytest.raises(ValueError, match="no kernel"):
        if call == "brick_step":
            brick_step(S, K, offs, ops)
        elif call == "brick_chunk":
            brick_chunk(S, torch.empty_like(S), K, offs, ops, srcf)
        elif call == "bkt_step":
            bkt_step(S, conv, K, offs, fm, rec)
        elif call == "bkt_node_step":
            bkt_node_step(S, conv, K, offs,
                          torch.zeros(TAB_SIZE, device="meta"))
        elif call == "bkt_corner_step":
            bkt_corner_step(S, torch.zeros((48, 1024), device="meta"), K,
                            torch.zeros((11, 1024), device="meta"), offs, fm)
        else:
            bkt_chunk(S, torch.empty_like(S), conv, torch.empty_like(conv),
                      K, offs, fm, rec, srcf)
    assert _launches() == before


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """A build without nvcc is an error, not a silent fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "CUDA_ROOTS", ())
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "library_path",
                        lambda: tmp_path / "build" / "libhtkernels_x.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
