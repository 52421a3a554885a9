"""The multi-chip pipeline on the CPU: ``Simulation.run(ndev=4,
devices=[cpu] * 4)`` and the CLI's ``--ndev`` against the JAX package's
``Simulation.run(ndev=4)`` and CLI on its 8 virtual CPU devices
(tests/conftest.py), in float64, on fixture (a) at 62.5 m: stations,
4-D volume, plane and checkpoint files of the paths "slab", "slab_pallas"
(the kernels' plain versions; JAX's interpret mode) and "sharded", within
2e-13 of their max (the files are not byte-equal: the element-force
product sums in another order, ROADMAP reference behaviour 9); a
multi-chip restart bit for bit; a JAX multi-chip checkpoint resumed by
the port; a checkpoint of another path, rank count or physics refused
before any output file is touched."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hercules_tpu.sim import (SimOutputs as JaxSimOutputs,
                              Simulation as JaxSimulation)
from hercules_tpu_torch.fixtures import (add_output_keys, one_torch_thread,
                                         write_box_case)
from hercules_tpu_torch.io.checkpoint import checkpoint_read
from hercules_tpu_torch.io.output4d import read_4d
from hercules_tpu_torch.sim import SimOutputs, Simulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M = 10, 10          # steps before and after the checkpoint
BOUND = 2e-13

_one_torch_thread = one_torch_thread()


def _case(root, damping="rayleigh", steps=N + M):
    paths = write_box_case(str(root), 62.5, steps, 3, damping=damping)
    add_output_keys(paths[1], paths[2], output_rate=5, planes_rate=2,
                    checkpointing_rate=N)
    return paths


def _run(paths, mc_path=None, ndev=4, **kw):
    """The port's Simulation.run on ndev CPU ranks, outputs on: (sim,
    state, samples)."""
    rundir = os.path.dirname(os.path.dirname(paths[1]))
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    state, samp = sim.run(
        device="cpu", devices=["cpu"] * ndev, mc_path=mc_path,
        rundir=rundir,
        outputs=lambda: SimOutputs(sim.mesh, sim.params, rundir=rundir),
        **kw)
    return sim, state, samp


def _jax_run(paths, mc_path):
    rundir = os.path.dirname(os.path.dirname(paths[1]))
    jsim = JaxSimulation.setup(paths[1], paths[2], cvmdb=paths[0])
    out = JaxSimOutputs(jsim.mesh, jsim.params, rundir=rundir)
    state, samp = jsim.run(dtype=jnp.float64, outputs=out, rundir=rundir,
                           ndev=4, mc_path=mc_path)
    return jsim, state, np.asarray(samp)


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    assert a.shape == b.shape and scale > 0, what
    np.testing.assert_allclose(a, b, rtol=0, atol=BOUND * scale,
                               err_msg=what)


def _checkpoints(d):
    """{step: npz arrays} of a run's two checkpoint files."""
    out = {}
    for f in ("checkpoint.out0", "checkpoint.out1"):
        z = np.load(d / "checkpoints" / f)
        out[int(z["step"])] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("mc_path,damping", [("slab", "bkt"),
                                             ("slab_pallas", "rayleigh"),
                                             ("sharded", "bkt")])
def test_files_match_jax(tmp_path, mc_path, damping):
    """Stations, 4-D displacement and velocity, plane records and both
    checkpoints (fields, carry tail, path name and rank count) against
    the JAX package's multi-chip run of the same path."""
    P, J = tmp_path / "port", tmp_path / "jax"
    sim, _, samp = _run(_case(P, damping), mc_path)
    jsim, _, jsamp = _jax_run(_case(J, damping), mc_path)
    assert sim.solver_path_name == jsim.solver_path_name == f"mc:{mc_path}"
    _close(samp, jsamp, "stations")
    for f in ("disp.h4d", "vel.h4d"):
        hp, dp = read_4d(str(P / f))
        hj, dj = read_4d(str(J / f))
        for k in hp.dtype.names:
            if k != "generation_date":
                assert np.array_equal(hp[k], hj[k]), k
        _close(dp, dj, f)
    _close(np.fromfile(P / "planes" / "planedisplacements.0"),
           np.fromfile(J / "planes" / "planedisplacements.0"), "plane")
    cp, cj = _checkpoints(P), _checkpoints(J)
    assert sorted(cp) == sorted(cj) == [N, N + M]
    for s in cp:
        assert cp[s].keys() == cj[s].keys()
        for k, v in cj[s].items():
            if v.dtype.kind == "f" and np.abs(v).max() > 0:
                _close(cp[s][k], v, f"checkpoint {s} {k}")
            else:
                assert np.array_equal(cp[s][k], v), (s, k)
        assert str(cp[s]["mc_path"]) == mc_path and int(cp[s]["mc_ndev"]) == 4


def _resume_dir(a_dir, b_dir, paths, step):
    """A copy of run A's case in b_dir with A's checkpoint of ``step``
    as checkpoint.in; the copy's paths."""
    shutil.copytree(a_dir / "in", b_dir / "in")
    shutil.copy(paths[0], b_dir / "box.e")
    (b_dir / "checkpoints").mkdir()
    ck = a_dir / "checkpoints"
    for f in ("checkpoint.out0", "checkpoint.out1"):
        if checkpoint_read(str(ck / f))[0] == step:
            shutil.copy(ck / f, b_dir / "checkpoints" / "checkpoint.in")
    return [str(b_dir / os.path.relpath(p, a_dir)) for p in paths]


def _leaves(state):
    out = []
    for s in state:
        stack = [s]
        while stack:
            x = stack.pop(0)
            if isinstance(x, (tuple, list)):
                stack = list(x) + stack
            else:
                out.append(x)
    return out


@pytest.mark.parametrize("mc_path", ["slab", "slab_pallas", "sharded"])
def test_restart_is_bit_exact(tmp_path, mc_path):
    """BKT on 4 ranks: run B from run A's step-N checkpoint ends in A's
    state bit for bit (every rank, the memory variables too), its
    station rows and 4-D frames after step N A's."""
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    paths = _case(a_dir, "bkt")
    sim_a, st_a, smp_a = _run(paths, mc_path)
    sim_b, st_b, smp_b = _run(_resume_dir(a_dir, b_dir, paths, N), mc_path)
    assert (sim_a.start_step, sim_b.start_step) == (0, N)
    la, lb = _leaves(st_a), _leaves(st_b)
    assert len(la) == len(lb) > 4
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert np.array_equal(smp_b, smp_a[N:]) and np.abs(smp_a).max() > 0
    for f in ("disp.h4d", "vel.h4d"):
        _, da = read_4d(str(a_dir / f))
        _, db = read_4d(str(b_dir / f))
        assert np.array_equal(da[N // 5 + 1:], db[N // 5 + 1:])


@pytest.mark.parametrize("mc_path", ["slab", "slab_pallas", "sharded"])
def test_jax_checkpoint_resumes(tmp_path, mc_path):
    """The JAX package's multi-chip BKT checkpoint of step N (its carry
    tail: the memory variables of the same path and rank count; on
    slab_pallas JAX's node basis of 8 rows, fitted to the port's 6)
    resumed by the port ends within the bound of the JAX package's
    straight run."""
    from hercules_tpu_torch.convert import mc_state_from_jax
    j_dir, b_dir = tmp_path / "jax", tmp_path / "port"
    paths = _case(j_dir, "bkt")
    jsim, jstate, jsamp = _jax_run(paths, mc_path)
    sim, state, samp = _run(_resume_dir(j_dir, b_dir, paths, N), mc_path)
    assert sim.start_step == N
    _close(samp, jsamp[N:], "stations")
    jstate = jax.tree.map(np.asarray, jstate)
    _close(sim.mc_path.u_global(state), jsim.mc_path.u_global(jstate), "u")
    if mc_path == "slab_pallas":
        ref = mc_state_from_jax(sim.mc_path, jstate)
        tail = [s[1].numpy() for s in state]
        jtail = [s[1].numpy() for s in ref]
        assert tail[0].shape[0] == 6
    else:
        tail = sim.mc_path.tail(state)
        jtail = jax.tree.leaves(jstate[2:])
        assert len(tail) == len(jtail) == 4
    for k, (a, b) in enumerate(zip(tail, jtail)):
        if np.abs(b).max() == 0:
            assert not a.any()
        else:
            _close(a, b, f"tail {k}")


@pytest.mark.parametrize("change", ["ndev", "path", "single", "damping"])
def test_foreign_checkpoint_refused(tmp_path, change):
    """A BKT checkpoint of slab_pallas on 4 ranks (a carry tail) is
    refused on 2 ranks, on another path, on one device, and under other
    damping -- before any output file is touched."""
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    paths = _case(a_dir, "bkt")
    _run(paths, "slab_pallas")
    bp = _resume_dir(a_dir, b_dir, paths, N)
    (b_dir / "disp.h4d").write_bytes(b"earlier")
    if change == "damping":
        with open(bp[1]) as f:
            text = f.read()
        with open(bp[1], "w") as f:
            f.write(text.replace("type_of_damping             = bkt",
                                 "type_of_damping             = rayleigh"))
    kw = {"ndev": dict(ndev=2, mc_path="slab_pallas"),
          "path": dict(mc_path="sharded"),
          "single": dict(ndev=1),
          "damping": dict(mc_path="slab_pallas")}[change]
    ndev = kw.pop("ndev", 4)
    with pytest.raises(RuntimeError, match="damping=bkt" if change ==
                       "damping" else "shaped for path=slab_pallas/ndev=4"):
        if ndev == 1:
            sim = Simulation.setup(bp[1], bp[2], cvmdb=bp[0])
            sim.run(device="cpu", rundir=str(b_dir), outputs=lambda: (
                SimOutputs(sim.mesh, sim.params, rundir=str(b_dir))))
        else:
            _run(bp, ndev=ndev, **kw)
    assert (b_dir / "disp.h4d").read_bytes() == b"earlier"
    assert not (b_dir / "vel.h4d").exists()


def test_run_arguments(tmp_path, monkeypatch):
    """ndev > 1 never runs a single-device route: a solver name with it
    raises, as do devices or mc_path without it, and more ranks than
    visible CUDA devices; HT_NDEV sets ndev."""
    paths = write_box_case(str(tmp_path), 62.5, 4, 1)
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    with pytest.raises(ValueError, match="single-device route"):
        sim.run(device="cpu", ndev=2, solver="unstructured")
    with pytest.raises(ValueError, match="need ndev > 1"):
        sim.run(device="cpu", mc_path="slab")
    with pytest.raises(ValueError, match="with 3 devices"):
        sim.run(device="cpu", ndev=2, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="only 1 CUDA devices"):
        sim.run(ndev=2)
    monkeypatch.undo()
    monkeypatch.setenv("HT_NDEV", "2")
    sim.run(device="cpu", rundir=str(tmp_path))
    assert sim.solver_path_name == "mc:slab"


def test_cli_station_files_match_jax(tmp_path):
    """Both CLIs with --ndev=4 (the port with --device=cpu) on the BKT
    box: the monitor's pipeline and path lines, station files equal to
    their printed precision."""
    env = dict(os.environ, PYTHONPATH=ROOT, HT_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    procs = []
    for name, cmd in (
            ("port", [sys.executable, "-m", "hercules_tpu_torch.cli",
                      "--device=cpu", "--ndev=4"]),
            ("jax", [sys.executable, "-m", "hercules_tpu.cli",
                     "--ndev=4", "--mc-path=slab"])):
        d = tmp_path / name
        paths = write_box_case(str(d), 62.5, 30, 3, damping="bkt")
        procs.append((d, subprocess.Popen(
            cmd + list(paths), cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for d, p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    (pd, _), (jd, _) = procs
    mon = (pd / "monitor.txt").read_text()
    assert "multi-chip pipeline: 4 devices" in mon
    assert "solver path: mc:slab " in mon
    assert "solver path: mc:slab " in (jd / "monitor.txt").read_text()
    for i in range(3):
        files = [d / "stations" / f"station.{i}" for d in (pd, jd)]
        a, b = (np.loadtxt(f, skiprows=1) for f in files)
        assert a.shape == b.shape == (30, 4)
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b[:, 1:]).max())
