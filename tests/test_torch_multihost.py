"""Multi-process runs (hercules_tpu_torch/parallel/multihost.py) in real
2-process gloo groups on the CPU, float64: the launcher's main, started
by multihost.spawn (each child given at most CHILD_TIMEOUT seconds).

- The O(shard) slab pipeline on fixture (a) at 62.5 m (each process
  meshes and tabulates only its block), with the plain SlabStep and with
  the kernel step (the kernels' plain versions; K1, K2 on the BKT box,
  K4 on the four-layer box): every array of every rank's final state is
  bit-identical to the one-process run at P = 2 (main with two local
  ranks, a RankGroup), and u within 2e-13 of max|u| of the JAX
  package's run_slab_solver on 2 of its 8 virtual CPU devices, built
  from the same in-repo fixture.
- The gather chain: GRADED_LAYERS at 62.5 m (gslab: plane interfaces
  sent across the process boundary) and the basin case at 31.25 m
  (gmesh: the interface allsum across processes), bit-identical to the
  one-process path at P = 2 on the mesh the processes gathered.
- DistRankGroup's byte and phase counts equal RankGroup's, rank by rank.
- The unstructured path is refused for more than one process; the
  one-process entry points equal the existing paths; a failing child
  fails the run."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hercules_tpu.parallel import slab as jslab
from hercules_tpu_torch import config, cvm
from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, GRADED_LAYERS,
                                         four_q_freq, one_torch_thread,
                                         write_basin_case, write_box_case)
from hercules_tpu_torch.mesh import distributed as dist
from hercules_tpu_torch.parallel import driver
from hercules_tpu_torch.parallel import multihost as mh
from hercules_tpu_torch.parallel.ranks import RankGroup
from hercules_tpu_torch.parallel.slab import build_slab_tables
from hercules_tpu_torch.sim import Simulation

from tests.test_torch_distmesh import run_ranks

CHILD_TIMEOUT = 120
STEPS = 40
BOUND = 2e-13
SLAB = ("box", "bkt", "four_q")
CHAIN = {"graded": "gslab", "basin": "gmesh"}

_one_torch_thread = one_torch_thread()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases, and the saved results of two 2-process runs: the
    plain slab step on fixture (a) and the gather chain's two cases,
    and the kernel step on the three slab boxes."""
    root = tmp_path_factory.mktemp("multihost")
    cases = {
        "box": write_box_case(str(root / "box"), 62.5, STEPS, 2),
        "bkt": write_box_case(str(root / "bkt"), 62.5, STEPS, 2,
                              damping="bkt"),
        "four_q": write_box_case(str(root / "four_q"), 62.5, STEPS, 2,
                                 damping="bkt", layers=FOUR_Q_LAYERS,
                                 freq=four_q_freq(62.5)),
        "graded": write_box_case(str(root / "graded"), 62.5, 20, 2,
                                 layers=GRADED_LAYERS,
                                 freq=four_q_freq(62.5)),
        "basin": write_basin_case(str(root / "basin"), 31.25, 20, 2)}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    order = {"plain": ("box", "graded", "basin"), "kernels": SLAB}
    for mode, names in order.items():
        out = mh.spawn(2, ["--device", "cpu", "--dtype", "float64",
                           "--slab-step", mode, "--save",
                           str(root / f"two_{mode}"),
                           *[a for n in names for a in cases[n]]],
                       timeout=CHILD_TIMEOUT, env=env)
        assert all(rc == 0 for rc, _ in out), [o[-3000:] for _, o in out]
    return {"root": root, "cases": cases, "order": order, "refs": {}}


def two_process(runs, mode, name):
    """[(arrays, report)] of the two processes' saved results."""
    k = runs["order"][mode].index(name)
    base = runs["root"] / f"two_{mode}"
    return [(np.load(base / f"case{k}_float64_p{pid}.npz"),
             json.load(open(base / f"case{k}_float64_p{pid}.json")))
            for pid in range(2)]


def one_process(runs, mode, name):
    """(arrays, report) of the one-process run at P = 2: main with two
    local ranks for a slab box, solve_mesh on the gathered mesh for the
    gather chain."""
    key = (mode, name)
    if key not in runs["refs"]:
        save = str(runs["root"] / f"one_{mode}_{name}")
        cv, ph, nu = runs["cases"][name]
        if name in CHAIN:
            p = config.load_params(ph, nu)
            mesh = run_ranks(dist.LocalComm, 2, lambda c: dist.gather_mesh(
                dist.generate_mesh_shard(p, cvm.CVM(cv), c), c))[0]
            mh.solve_mesh(0, mesh, p, RankGroup(["cpu"] * 2),
                          [torch.float64], save=save)
        else:
            assert mh.main(["--device", "cpu", "--local-ranks", "2",
                            "--dtype", "float64", "--slab-step", mode,
                            "--save", save, cv, ph, nu]) == 0
        runs["refs"][key] = (np.load(f"{save}/case0_float64_p0.npz"),
                             json.load(open(f"{save}/case0_float64_p0.json")))
    return runs["refs"][key]


CASES = [("plain", "box")] + [("kernels", n) for n in SLAB] \
    + [("plain", n) for n in CHAIN]


@pytest.mark.parametrize("mode,name", CASES)
def test_two_processes_bit_identical_to_one(runs, mode, name):
    """Every array of every rank's final state, and the slab gather
    maps, as the one-process run at P = 2 holds them."""
    one, rep1 = one_process(runs, mode, name)
    path = CHAIN.get(name, "slab")
    assert rep1["path"] == path
    seen = set()
    for arrs, rep in two_process(runs, mode, name):
        assert rep["path"] == path and rep["nproc"] == 2 and rep["P"] == 2
        if path == "slab":
            # the O(shard) pipeline: the process held its block only
            assert rep["shard_elements"] < rep["e_global"]
            assert rep["table_columns"] < rep["n_global"]
        for f in arrs.files:
            assert arrs[f].dtype == one[f].dtype, f
            assert np.array_equal(arrs[f], one[f]), (f, name)
            seen.add(f)
    assert seen == set(one.files)


@pytest.mark.parametrize("mode,name", CASES)
def test_counts_equal_rank_group(runs, mode, name):
    """The bytes and phases each rank sent, as RankGroup counts them."""
    _, rep1 = one_process(runs, mode, name)
    sent, phases = {}, {}
    for _, rep in two_process(runs, mode, name):
        sent.update(rep["sent"])
        phases.update(rep["phases"])
    assert sent == rep1["sent"] and phases == rep1["phases"]
    assert all(v > 0 for v in sent.values())


@pytest.mark.parametrize("mode", ["plain", "kernels"])
def test_shard_slab_matches_jax(runs, mode):
    """u of the 2-process O(shard) run within 2e-13 of max|u| of the JAX
    package's slab solver (run_slab_solver, or the kernel path in
    interpret mode) at P = 2 on the same fixture."""
    cv, ph, nu = runs["cases"]["box"]
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    jst = jslab.build_slab_tables(sim.mesh, sim.tables, 2,
                                  src_ids=sim.src_ids)
    with Mesh(np.array(jax.devices()[:2]), ("d",)) as m:
        if mode == "kernels":
            carry = jslab.run_slab_pallas_solver(
                jst, m, sim.src_forces, STEPS, sim.params.delta_t,
                dtype=jnp.float64, chunk=10, interpret=True)
            want = jslab.slab_pallas_u_global(jst, np.asarray(carry[0]),
                                              sim.mesh.nnum)
        else:
            carry = jslab.run_slab_solver(jst, m, sim.src_forces, STEPS,
                                          sim.params.delta_t,
                                          dtype=jnp.float64, chunk=10)
            want = jslab.slab_u_global(jst, np.asarray(carry[0]),
                                       sim.mesh.nnum)
    got = np.zeros_like(want)
    for arrs, rep in two_process(runs, mode, "box"):
        for r in rep["ranks"]:
            g = arrs[f"g{r}"]
            got[g] = arrs[f"r{r}_0"][0:3, :len(g)].T
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=BOUND * scale)


def test_sharded_refused_for_several_processes(runs):
    """A mesh every structured path refuses (fixture (a)'s 8 layers on 9
    ranks) takes "sharded" in one process and is refused for two."""
    cv, ph, nu = runs["cases"]["box"]
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    group = RankGroup(["cpu"] * 9)
    name, _ = mh.structured_tables(sim.mesh, sim.tables, group,
                                   sim.src_ids, 1)
    assert name == "sharded"
    with pytest.raises(RuntimeError, match="single-process only"):
        mh.structured_tables(sim.mesh, sim.tables, group, sim.src_ids, 2)


def test_one_process_entry_points(runs):
    """Without a process group: init_multihost is a no-op, the host-0
    broadcast the identity, the rank group a RankGroup; the slab solve
    and main's one-process run equal the driver's slab path, and
    gather_global stacks the ranks' arrays."""
    assert mh.init_multihost() == (1, 0)
    obj = {"a": [1, 2]}
    assert mh.broadcast_from_host0(obj) is obj
    group = mh.rank_group(["cpu"] * 2)
    assert type(group) is RankGroup and mh.local_device_slice(group) == (0, 2)
    cv, ph, nu = runs["cases"]["box"]
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    st = build_slab_tables(sim.mesh, sim.tables, 2, src_ids=sim.src_ids)
    path = driver.SlabXLAPath(st, group, torch.float64, sim.mesh.nnum)
    want, _ = driver.run_multichip(path, sim.src_forces, STEPS,
                                   sim.params.delta_t)
    got = mh.run_slab_multihost(st, sim.src_forces, STEPS,
                                sim.params.delta_t, group, torch.float64)
    one, _ = one_process(runs, "plain", "box")
    for r in range(2):
        for i, (a, b) in enumerate(zip(got[r], want[r])):
            assert torch.equal(a, b)
            assert np.array_equal(one[f"r{r}_{i}"], b.numpy())
    stacked = mh.gather_global([s[0] for s in got], group)
    assert np.array_equal(stacked, np.stack([s[0].numpy() for s in got]))
    # the O(shard) pipeline on one meshing rank: the same tables and
    # sources, so main's one-process state
    p = config.load_params(ph, nu)
    comm, = dist.LocalComm.group(1)
    shard = dist.generate_mesh_shard(p, cvm.CVM(cv), comm)
    st1, got1 = mh.run_shard_slab_pipeline(p, shard, comm, group,
                                           torch.float64)
    assert st1.dev0 == 0 and len(st1.inv_mass) == 2
    for r in range(2):
        for i, b in enumerate(got1[r]):
            assert np.array_equal(one[f"r{r}_{i}"], b.numpy())


def test_failing_child_fails_the_run(tmp_path):
    """A child that cannot read its inputs exits non-zero, and spawn
    returns without waiting for the timeout."""
    out = mh.spawn(2, ["--device", "cpu", str(tmp_path / "missing.e"),
                       str(tmp_path / "physics.in"),
                       str(tmp_path / "numerical.in")],
                   timeout=CHILD_TIMEOUT)
    assert any(rc not in (0, None) for rc, _ in out)
    assert all(rc != 0 for rc, _ in out)
