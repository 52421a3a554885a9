"""The port imports nothing of jax or of the JAX package, loads no
kernel at import time, runs on the CUDA device unless asked for the
CPU, and never falls back from a CUDA call to the CPU."""

import inspect
import os
import subprocess
import sys

import numpy as np
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
           "hercules_tpu_torch.fixtures", "hercules_tpu_torch.nonlinear",
           "hercules_tpu_torch.drm", "hercules_tpu_torch.buildings",
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
           "hercules_tpu_torch.io.matlab",
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
           "hercules_tpu_torch.solver.brickstep",
           "hercules_tpu_torch.solver.planerec",
           "hercules_tpu_torch.solver.fused_mesh",
           "hercules_tpu_torch.solver.step",
           "hercules_tpu_torch.tools.loh1",
           "hercules_tpu_torch.utils.gof",
           "hercules_tpu_torch.kernels.build",
           "hercules_tpu_torch.kernels.brick_step",
           "hercules_tpu_torch.kernels.brick_chunk",
           "hercules_tpu_torch.kernels.bkt_step",
           "hercules_tpu_torch.kernels.bkt_chunk",
           "hercules_tpu_torch.kernels.bkt_node_step",
           "hercules_tpu_torch.kernels.bkt_corner_step",
           "hercules_tpu_torch.kernels.stream_add",
           "hercules_tpu_torch.kernels.tiles",
           "hercules_tpu_torch.utils.timers",
           "hercules_tpu_torch.parallel",
           "hercules_tpu_torch.parallel.partition",
           "hercules_tpu_torch.parallel.ranks",
           "hercules_tpu_torch.parallel.slab",
           "hercules_tpu_torch.parallel.gslab",
           "hercules_tpu_torch.parallel.gmesh",
           "hercules_tpu_torch.parallel.sharded",
           "hercules_tpu_torch.parallel.driver",
           "hercules_tpu_torch.parallel.comm_model",
           "hercules_tpu_torch.mesh.distributed",
           "hercules_tpu_torch.parallel.shardbuild",
           "hercules_tpu_torch.parallel.multihost",
           "hercules_tpu_torch.etree.edit",
           "hercules_tpu_torch.utils.debug",
           "hercules_tpu_torch.tools.cvmtools",
           "hercules_tpu_torch.tools.q4",
           "hercules_tpu_torch.tools.qmesh",
           "hercules_tpu_torch.tools.plotmesh",
           "hercules_tpu_torch.tools.resident_bench",
           "hercules_tpu_torch.tools.perf_ab",
           "hercules_tpu_torch.graft_entry")


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


_MH_CHILD = r'''
import sys
from hercules_tpu_torch.parallel import multihost
pid, port = sys.argv[1:3]
rc = multihost.main(["--coordinator", f"127.0.0.1:{port}", "--nprocs", "2",
                     "--pid", pid, "--device", "cpu", *sys.argv[3:]])
foreign = sorted(m for m in sys.modules if m in ("jax", "hercules_tpu")
                 or m.startswith(("jax.", "hercules_tpu.")))
assert rc == 0 and not foreign, foreign
print("ok", flush=True)
'''


def test_multihost_children_import_no_jax(tmp_path):
    """Both processes of a 2-process gloo run of the multi-process
    launcher (fixture (a) at 62.5 m, 10 steps: sharded meshing, the
    shard-local tables, the slab solve) load no module of jax or of the
    JAX package; each child has 120 seconds."""
    from hercules_tpu_torch.fixtures import write_box_case
    from hercules_tpu_torch.parallel.multihost import free_port
    paths = write_box_case(str(tmp_path), 62.5, 10, 2)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _MH_CHILD, str(k),
                               str(port), *paths], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for k in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), [o[-2000:] for o in outs]
    assert all(o.strip().endswith("ok") for o in outs)


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
    scales, rec = (1.0, 0.0), (0.0,) * 9
    srcf = torch.zeros((4, 3, 0), device="meta")
    before = _launches()
    with pytest.raises(ValueError, match="no kernel"):
        if call == "brick_step":
            brick_step(S, K, offs, ops)
        elif call == "brick_chunk":
            brick_chunk(S, torch.empty_like(S), K, offs, ops, srcf)
        elif call == "bkt_step":
            bkt_step(S, conv, K, offs, scales, rec)
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
                      K, offs, scales, rec, srcf)
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
                                   "tables_from_jax", "MeshPallasTables",
                                   "run_mesh_solver", "run_brick_solver",
                                   "attach_nonlinear_mesh"])
def test_entry_points_default_to_cuda(entry, small_box, monkeypatch):
    """The solver's entry points take the CUDA device unless the caller
    asks for the CPU; with no CUDA device they raise instead of running
    on the CPU."""
    from hercules_tpu_torch import convert
    from hercules_tpu_torch.solver import brickstep, fused_brick, fused_mesh
    module = {"tables_from_jax": convert, "MeshPallasTables": fused_mesh,
              "run_mesh_solver": fused_mesh,
              "attach_nonlinear_mesh": fused_mesh,
              "run_brick_solver": brickstep}.get(entry, fused_brick)
    fn = getattr(module, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim, plan = small_box
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "attach_nonlinear_mesh":
            from hercules_tpu_torch.fixtures import NL_PROPERTIES
            from hercules_tpu_torch.nonlinear import (NonlinearConfig,
                                                      build_nonlinear_tables)
            table = np.array(NL_PROPERTIES)
            cfg = NonlinearConfig(vs_cut=1e9, vs_limits=table[:, 0],
                                  alpha_cohes=table[:, 1],
                                  kay_phis=table[:, 2],
                                  strain_rates=table[:, 3],
                                  sensitivities=table[:, 4],
                                  hardening=table[:, 5])
            fn(sim.mesh, sim.params, sim.tables,
               build_nonlinear_tables(sim.mesh, sim.params, cfg), plan)
        elif entry.startswith("run_"):
            fn(plan, sim.tables, sim.src_ids, sim.src_forces, 4,
               sim.params.delta_t)
        elif entry.endswith("Tables"):
            fn(plan, sim.tables)
        else:
            fn(sim.tables, plan)


@pytest.mark.parametrize("tool", ["resident_bench", "perf_ab"])
def test_timing_tools_default_to_cuda(tool, monkeypatch):
    """The timing tools run on the card unless given --device=cpu: their
    run() defaults to CUDA, and their command line without the flag
    raises without a CUDA device before it builds anything."""
    import importlib
    mod = importlib.import_module(f"hercules_tpu_torch.tools.{tool}")
    assert inspect.signature(mod.run).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mod, "build", lambda *a, **k: pytest.fail("built"))
    argv = ["10", "--elems=2048"] if tool == "resident_bench" else \
        ["rayleigh", "5", "", "--elems=2048"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
