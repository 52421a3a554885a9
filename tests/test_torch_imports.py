"""The port imports nothing of jax or of the JAX package, loads no
kernel at import time, runs on the CUDA device unless asked for the
CPU, and never falls back from a CUDA call to the CPU."""

import inspect
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
from hercules_tpu_torch.kernels.stream_add import stream_add

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("hercules_tpu_torch", "hercules_tpu_torch.cli",
           "hercules_tpu_torch.sim", "hercules_tpu_torch.convert",
           "hercules_tpu_torch.fixtures",
           "hercules_tpu_torch.config", "hercules_tpu_torch.cvm",
           "hercules_tpu_torch.material", "hercules_tpu_torch.meshgen",
           "hercules_tpu_torch.native",
           "hercules_tpu_torch.physics", "hercules_tpu_torch.physics.consts",
           "hercules_tpu_torch.physics.kmats",
           "hercules_tpu_torch.etree", "hercules_tpu_torch.etree.morton",
           "hercules_tpu_torch.etree.reader",
           "hercules_tpu_torch.etree.writer",
           "hercules_tpu_torch.mesh", "hercules_tpu_torch.mesh.octree",
           "hercules_tpu_torch.mesh.extract",
           "hercules_tpu_torch.mesh.locate",
           "hercules_tpu_torch.source", "hercules_tpu_torch.source.filter",
           "hercules_tpu_torch.source.slip",
           "hercules_tpu_torch.source.model",
           "hercules_tpu_torch.source.extended",
           "hercules_tpu_torch.io.monitor", "hercules_tpu_torch.io.meshout",
           "hercules_tpu_torch.utils.stats",
           "hercules_tpu_torch.utils.roofline",
           "hercules_tpu_torch.tools.makecvm",
           "hercules_tpu_torch.tools.hbm_ceiling",
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
           "hercules_tpu_torch.kernels.stream_add",
           "hercules_tpu_torch.utils.timers")


def test_port_imports_no_jax(tmp_path):
    """Neither importing every module of the port nor a CLI run on the
    CPU (62.5 m box, 20 steps: the CLI's lazy imports) loads a module
    of jax or of the JAX package hercules_tpu."""
    code = ("import importlib, sys\n"
            "def foreign():\n"
            "    return sorted(m for m in sys.modules\n"
            "                  if m in ('jax', 'hercules_tpu')\n"
            "                  or m.startswith(('jax.', 'hercules_tpu.')))\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from hercules_tpu_torch.kernels import build\n"
            "assert build._LIB is None, 'kernel library loaded at import'\n"
            "assert not foreign(), foreign()\n"
            "from hercules_tpu_torch import cli\n"
            "from hercules_tpu_torch.fixtures import write_box_case\n"
            "paths = write_box_case('.', 62.5, 20, 2)\n"
            "assert cli.main(['--device=cpu', *paths]) == 0\n"
            "assert not foreign(), foreign()\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-3000:]
    assert "solver path: torch_plain" in \
        (tmp_path / "monitor.txt").read_text()


def _args(device):
    S = torch.zeros((8, 1024), device=device)
    K = torch.zeros((8, 1024), device=device)
    ops = torch.zeros((48, 24), device=device)
    return S, K, (0, 1, 17, 18, 289, 290, 306, 307), ops


def _launches():
    return (brick_step.launches, brick_chunk.launches, bkt_step.launches,
            bkt_chunk.launches, bkt_node_step.launches,
            bkt_corner_step.launches, stream_add.launches)


@pytest.mark.parametrize("call", ["brick_step", "brick_chunk", "bkt_step",
                                  "bkt_chunk", "bkt_node_step",
                                  "bkt_corner_step", "stream_add"])
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
        elif call == "stream_add":
            stream_add(S, K, out=S)
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


@pytest.fixture(scope="module")
def small_box(tmp_path_factory):
    from hercules_tpu_torch.fixtures import box_simulation
    from hercules_tpu_torch.solver.bricks import build_plan
    sim = box_simulation(str(tmp_path_factory.mktemp("box")), steps=4)
    return sim, build_plan(sim.mesh)


@pytest.mark.parametrize("entry", ["PallasBrickTables", "run_pallas_solver",
                                   "tables_from_jax"])
def test_entry_points_default_to_cuda(entry, small_box, monkeypatch):
    """The solver's entry points take the CUDA device unless the caller
    asks for the CPU; with no CUDA device they raise instead of running
    on the CPU."""
    from hercules_tpu_torch import convert
    from hercules_tpu_torch.solver import fused_brick
    fn = getattr(convert if entry == "tables_from_jax" else fused_brick,
                 entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim, plan = small_box
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "run_pallas_solver":
            fn(plan, sim.tables, sim.src_ids, sim.src_forces, 4,
               sim.params.delta_t)
        elif entry == "PallasBrickTables":
            fn(plan, sim.tables)
        else:
            fn(sim.tables, plan)
