"""The general graded path on the CPU: the port's ``parallel/gmesh.py`` (a
step kernel per brick fragment, here the kernels' plain versions; the
interfaces reconciled over one allsum; the loose section replicated;
nonlinear soil) against the JAX package's
``run_gmesh_solver(interpret=True)`` and ``Simulation.run(ndev=P)`` on
its 8 virtual CPU devices in float64, with the same mesh, tables,
sources and ranks.

Cases: the basin fixture (``fixtures.write_basin_case``: a soft column
one level finer than the rest, a vertical interface) at 62.5 m (two
bricks of 8 and 4 layers) on 2 ranks, Rayleigh and BKT, and at 31.25 m
(one brick of 16 layers and 1,536 loose elements) on 8; gmesh forced on
``GRADED_LAYERS`` at 15.625 m (two bricks and 1,024 loose elements) on 4;
nonlinear soil on ``NL_LAYERS`` at 62.5 m on 2 ranks and at 31.25 m on
4 (the fine brick nonlinear), through ``Simulation.run`` in both
packages.  Bounds: 2e-13 of max|u| against the JAX path, 5e-12 against
the single-device unstructured solver, 2e-12 on the stations' nonlinear
columns (replayed on the host); replicas bit-identical; a restart bit
for bit; checkpoints across the packages; the refusals of
``build_gmesh_tables`` and the path choice's order and reasons."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hercules_tpu.parallel import gmesh as jgmesh
from hercules_tpu.sim import Simulation as JaxSimulation
from hercules_tpu_torch.convert import mc_state_from_jax, mc_state_to_jax
from hercules_tpu_torch.fixtures import (GRADED_LAYERS, NL_FREQ, NL_LAYERS,
                                         add_nonlinear_keys, add_output_keys,
                                         four_q_freq, one_torch_thread,
                                         write_basin_case, write_box_case)
from hercules_tpu_torch.io.checkpoint import checkpoint_read
from hercules_tpu_torch.parallel import driver
from hercules_tpu_torch.parallel.gmesh import build_gmesh_tables
from hercules_tpu_torch.parallel.gslab import build_gslab_tables
from hercules_tpu_torch.parallel.ranks import RankGroup
from hercules_tpu_torch.sim import SimOutputs, Simulation
from hercules_tpu_torch.solver import step
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.planerec import PlaneReconciler

STEPS = 20
BOUND = 2e-13

_one_torch_thread = one_torch_thread()


def _write(root, name, steps=STEPS, n_st=3):
    if name.startswith("basin"):
        edge = 31.25 if name.startswith("basin31") else 62.5
        return write_basin_case(str(root), edge, steps, n_st,
                                damping="bkt" if "bkt" in name
                                else "rayleigh")
    if name == "graded15":
        return write_box_case(str(root), 15.625, steps, n_st,
                              layers=GRADED_LAYERS,
                              freq=four_q_freq(15.625))
    freq = NL_FREQ if name == "nl62" else 4.0
    edge = 62.5 if name == "nl62" else 31.25
    return write_box_case(str(root), edge, steps, n_st, layers=NL_LAYERS,
                          freq=freq)


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            paths = _write(tmp_path_factory.mktemp(name), name)
            made[name] = Simulation.setup(paths[1], paths[2],
                                          cvmdb=paths[0])
        return made[name]

    return get


def _close(got, want, what, bound=BOUND):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert got.shape == want.shape and scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=bound * scale,
                               err_msg=what)


def assert_replicas_equal(path, state):
    """Both copies of every fragment-shared plane hold the same bits (u,
    u- and K2's memory variables), and every rank's loose section the
    same as rank 0's."""
    uniform = path.step.tier == "uniform"
    for b, fb in enumerate(path.st.bricks):
        pl = fb.plane
        for r in range(path.n_dev - 1):
            zb = int(fb.ez_of[r]) * pl
            lo, hi = state[r], state[r + 1]
            pairs = [(lo[0][b][0:6], hi[0][b][0:6])]
            if uniform:
                pairs.append((lo[2][b][0], hi[2][b][0]))
            for x, y in pairs:
                assert torch.equal(x[:, zb:zb + pl], y[:, :pl]), (b, r)
    for s in state[1:]:
        assert torch.equal(s[1], state[0][1])


def test_basin_plan(sims):
    """The basin fixture: two bricks whose interface is a vertical plane
    (the plane reconciler does not hold it), the soft column one level
    finer; gslab refuses it, gmesh takes it."""
    sim = sims("basin62")
    assert sim.mesh.lenum == 4 * 16 * 8 + 6 * 8 * 4
    plan = build_plan(sim.mesh)
    assert len(plan.bricks) == 2 and not len(plan.loose_eidx)
    assert len(plan.ex_pos) and PlaneReconciler.analyse(plan) is None
    assert abs(plan.bricks[0].level - plan.bricks[1].level) == 1
    with pytest.raises(RuntimeError, match="z-planes"):
        build_gslab_tables(sim.mesh, sim.tables, 2)
    st = build_gmesh_tables(sim.mesh, sim.tables, 2, src_ids=sim.src_ids)
    assert st.K > 0 and len(st.bricks) == 2


def _port(sim, P, min_brick_elems=2048):
    st = build_gmesh_tables(sim.mesh, sim.tables, P, src_ids=sim.src_ids,
                            min_brick_elems=min_brick_elems)
    path = driver.GMeshPath(st, RankGroup(["cpu"] * P), torch.float64,
                            sim.mesh.nnum)
    path.attach_stations(sim.stations.nodes, sim.stations.phi)
    state, samp = driver.run_multichip(path, sim.src_forces, STEPS,
                                       sim.params.delta_t, chunk=7)
    return path, state, samp


def _jax(sim, P):
    jst = jgmesh.build_gmesh_tables(sim.mesh, sim.tables, P,
                                    src_ids=sim.src_ids, dtype=jnp.float64)
    m = Mesh(np.array(jax.devices()[:P]), ("d",))
    carry = jgmesh.run_gmesh_solver(jst, m, sim.src_forces, STEPS,
                                    sim.params.delta_t, dtype=jnp.float64,
                                    chunk=10, interpret=True)
    return jst, jax.tree.map(np.asarray, carry)


@pytest.mark.parametrize("name,P", [("basin62", 2), ("basin31", 8),
                                    ("graded15", 4), ("basin62_bkt", 2)])
def test_gmesh_matches_jax(sims, name, P):
    """u, u- (and with BKT the memory variables) against the JAX gmesh
    path; u and the stations against the single-device unstructured
    solver; replicas bit-identical."""
    sim = sims(name)
    path, state, samp = _port(sim, P)
    assert path.step.tier == ("uniform" if "bkt" in name else "elastic")
    assert (path.st.El > 0) == (name in ("basin31", "graded15"))
    jst, carry = _jax(sim, P)
    N = sim.mesh.nnum
    _close(path.u_global(state), jgmesh.gmesh_u_global(jst, carry, N), "u")
    jup = jgmesh.gmesh_u_global(
        jst, (tuple(a[:, 3:] for a in carry[0]), carry[1][:, 3:]), N)
    _close(path.up_global(state), jup, "u-")
    if "bkt" in name:
        ref = mc_state_from_jax(path, carry)
        for r in range(P):
            for b in range(len(path.st.bricks)):
                _close(state[r][2][b][0].numpy(), ref[r][2][b][0].numpy(),
                       f"conv {r} {b}")
    one, one_samp = step.run_solver(
        sim.tables, sim.src_ids, sim.src_forces, STEPS, sim.params.delta_t,
        st_nodes=sim.stations.nodes, st_phi=sim.stations.phi, device="cpu")
    _close(path.u_global(state), one[0].numpy(), "u single", 5e-12)
    _close(samp, one_samp, "stations", 5e-12)
    assert_replicas_equal(path, state)


def _nl_case(root, name, geostatic=False, cut=2000.0, damping="rayleigh",
             steps=STEPS, checkpoint=None):
    paths = _write(root, name, steps, 5)
    if damping != "rayleigh":
        text = open(paths[1]).read().replace("= rayleigh", f"= {damping}")
        open(paths[1], "w").write(text)
    add_nonlinear_keys(paths[2], cut,
                       **(dict(geostatic_s=0.05, cushion_s=0.01)
                          if geostatic else {}))
    if checkpoint:
        add_output_keys(paths[1], paths[2], checkpointing_rate=checkpoint)
    return paths


@pytest.mark.parametrize("name,P", [("nl62", 2), ("nl31", 4)])
def test_gmesh_nonlinear_matches_jax(tmp_path, name, P):
    """Nonlinear soil through Simulation.run(ndev=P) in both packages:
    both take gmesh (hercules_tpu/sim.py:969-991); u, the stations, the
    plastic state in the JAX package's padded layout (tail) and the
    stations' 17 nonlinear columns against the JAX run's; replicas
    bit-identical."""
    ph, nu, cv = (lambda p: (p[1], p[2], p[0]))(_nl_case(tmp_path, name))
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    state, samp = sim.run(device="cpu", ndev=P, rundir=str(tmp_path))
    jsim = JaxSimulation.setup(ph, nu, cvmdb=cv)
    jstate, jsamp = jsim.run(dtype=jnp.float64, ndev=P, rundir=str(tmp_path))
    jstate = jax.tree.map(np.asarray, jstate)
    assert sim.solver_path_name == jsim.solver_path_name == "mc:gmesh"
    assert sim.solver_path_reason == ""
    _close(sim.mc_path.u_global(state), jsim.mc_path.u_global(jstate), "u")
    _close(samp, np.asarray(jsamp), "stations")
    tail, jtail = sim.mc_path.tail(state), jax.tree.leaves(jstate[2])
    assert len(tail) == len(jtail) == 3 and np.abs(tail[2]).max() > 0
    for k, (a, b) in enumerate(zip(tail, jtail)):
        _close(a, b, f"plastic state {k}", 5e-13)
    assert sim.nl_station_extras.keys() == jsim.nl_station_extras.keys()
    assert sim.nl_station_extras
    for k, v in jsim.nl_station_extras.items():
        _close(sim.nl_station_extras[k], v, f"station {k}", 2e-12)
    assert_replicas_equal(sim.mc_path, state)


def test_gmesh_refusals(sims, tmp_path):
    """build_gmesh_tables raises on each case the JAX package's
    build_gmesh_tables refuses (gmesh.py:118-158, 392-395)."""
    import dataclasses
    from hercules_tpu_torch.fixtures import RHO, VP, VS
    sim = sims("basin62")
    odd = dataclasses.replace(sim.tables, damping="conventional")
    with pytest.raises(RuntimeError, match="unsupported damping"):
        build_gmesh_tables(sim.mesh, odd, 2)
    with pytest.raises(RuntimeError, match="cannot feed"):
        build_gmesh_tables(sim.mesh, sim.tables, 8)
    bkt31 = write_basin_case(str(tmp_path / "bkt31"), 31.25, 4, 1,
                             damping="bkt")
    s = Simulation.setup(bkt31[1], bkt31[2], cvmdb=bkt31[0])
    with pytest.raises(RuntimeError, match="BKT with loose"):
        build_gmesh_tables(s.mesh, s.tables, 2)
    q2 = write_box_case(str(tmp_path / "q2"), 31.25, 4, 1, damping="bkt",
                        layers=((0.0, 2200.0, 1100.0, 2300.0),
                                (125.0, 3000.0, 1500.0, 2300.0),
                                (250.0, VP, VS, RHO)), freq=4.0)
    s = Simulation.setup(q2[1], q2[2], cvmdb=q2[0])
    with pytest.raises(RuntimeError, match="one Q set per brick"):
        build_gmesh_tables(s.mesh, s.tables, 2, min_brick_elems=512)
    for tag, kw, match in (
            ("geo", dict(geostatic=True), "geostatic"),
            # a loose element has no brick column: the table function names it
            # missing from the plan (gmesh.py:144-146 before :147-150)
            ("loose", dict(cut=4000.0), "missing from plan"),
            ("bkt", dict(damping="bkt"), "nonlinear\\+BKT")):
        paths = _nl_case(tmp_path / tag, "nl31", **kw)
        s = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
        with pytest.raises(RuntimeError, match=match):
            build_gmesh_tables(s.mesh, s.tables, 2, nl_tables=s.nl_tables,
                               params=s.params)
        # the automatic choice then takes "sharded" and says why
        s.run(device="cpu", ndev=2, rundir=str(tmp_path / tag),
              total_steps=1)
        assert s.solver_path_name == "mc:sharded"
        assert "nonlinear soil" in s.solver_path_reason
        assert "gmesh: " in s.solver_path_reason


# ---- restart and checkpoints across packages -----------------------------

N_CK, M_CK = 10, 10


def _resume_dir(a_dir, b_dir, paths):
    shutil.copytree(a_dir / "in", b_dir / "in")
    shutil.copy(paths[0], b_dir / "box.e")
    (b_dir / "checkpoints").mkdir()
    for f in ("checkpoint.out0", "checkpoint.out1"):
        src = a_dir / "checkpoints" / f
        if checkpoint_read(str(src))[0] == N_CK:
            shutil.copy(src, b_dir / "checkpoints" / "checkpoint.in")
    return [str(b_dir / os.path.relpath(p, a_dir)) for p in paths]


def _run(paths, **kw):
    rundir = os.path.dirname(os.path.dirname(paths[1]))
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    state, samp = sim.run(
        device="cpu", devices=["cpu"] * 2, rundir=rundir,
        outputs=lambda: SimOutputs(sim.mesh, sim.params, rundir=rundir),
        **kw)
    return sim, state, samp


def test_restart_is_bit_exact(tmp_path):
    """Nonlinear soil on 2 ranks (gmesh): run B from run A's step-N
    checkpoint, whose tail is the padded plastic state, ends in A's
    state bit for bit, its station rows A's."""
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    paths = _nl_case(a_dir, "nl62", steps=N_CK + M_CK, checkpoint=N_CK)
    sim_a, st_a, smp_a = _run(paths)
    sim_b, st_b, smp_b = _run(_resume_dir(a_dir, b_dir, paths))
    assert sim_a.solver_path_name == sim_b.solver_path_name == "mc:gmesh"
    assert (sim_a.start_step, sim_b.start_step) == (0, N_CK)
    la, lb = driver._flat(st_a), driver._flat(st_b)
    assert len(la) == len(lb) == 2 * (2 + 1 + 3)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert np.array_equal(smp_b, smp_a[N_CK:]) and np.abs(smp_a).max() > 0
    assert st_a[0][2][2].abs().max() > 0


def test_checkpoints_cross_packages(tmp_path):
    """BKT on the basin at 62.5 m, 2 ranks: the JAX package's gmesh
    checkpoint of step N (its node basis of 8 rows per brick) resumed by
    the port, and the port's state of step N carried into the JAX layout
    (convert.mc_state_to_jax) resumed by the JAX package's driver, each
    within the bound of the other package's straight run."""
    from hercules_tpu.parallel import driver as jdriver
    from hercules_tpu.sim import SimOutputs as JaxSimOutputs

    def case(root):
        paths = write_basin_case(str(root), 62.5, N_CK + M_CK, 3,
                                 damping="bkt")
        add_output_keys(paths[1], paths[2], checkpointing_rate=N_CK)
        return paths

    j_dir = tmp_path / "jax"
    paths_j = case(j_dir)
    jsim = JaxSimulation.setup(paths_j[1], paths_j[2], cvmdb=paths_j[0])
    jstate, jsamp = jsim.run(
        dtype=jnp.float64, ndev=2, mc_path="gmesh", rundir=str(j_dir),
        outputs=JaxSimOutputs(jsim.mesh, jsim.params, rundir=str(j_dir)))
    jstate, jsamp = jax.tree.map(np.asarray, jstate), np.asarray(jsamp)
    sim, state, samp = _run(case(tmp_path / "port"), mc_path="gmesh")
    assert jsim.solver_path_name == sim.solver_path_name == "mc:gmesh"
    _close(samp, jsamp, "stations")
    ju = jsim.mc_path.u_global(jstate)
    _close(sim.mc_path.u_global(state), ju, "u")
    sim_b, st_b, smp_b = _run(_resume_dir(j_dir, tmp_path / "pb", paths_j),
                              mc_path="gmesh")
    assert sim_b.start_step == N_CK
    _close(smp_b, jsamp[N_CK:], "stations from the JAX checkpoint")
    _close(sim_b.mc_path.u_global(st_b), ju, "u from the JAX checkpoint")
    # the port's state of step N resumed by the JAX package
    half = Simulation.setup(paths_j[1], paths_j[2], cvmdb=paths_j[0])
    st_n, _ = half.run(device="cpu", devices=["cpu"] * 2, mc_path="gmesh",
                       total_steps=N_CK, rundir=str(tmp_path))
    jpath = jsim.mc_path
    carry = mc_state_to_jax(half.mc_path, st_n,
                            jax.tree.map(np.asarray, jpath.init_state()))
    back = mc_state_from_jax(half.mc_path, carry)
    for a, b in zip(driver._flat(st_n), driver._flat(back)):
        assert torch.equal(a, b)
    with Mesh(np.array(jax.devices()[:2]), ("d",)) as m:
        jst_b, jsmp_b = jdriver.run_multichip(
            jpath, m, jsim.src_forces, N_CK + M_CK, jsim.params.delta_t,
            state=jax.tree.map(jnp.asarray, carry), start_step=N_CK)
    _close(np.asarray(jsmp_b), samp[N_CK:],
           "JAX stations from the port's state")
    _close(jpath.u_global(jax.tree.map(np.asarray, jst_b)),
           sim.mc_path.u_global(state), "JAX u from the port's state")


# ---- the path choice -------------------------------------------------------

class _Built:
    """Stands in for a path class: records what choose_path built."""

    def __init__(self, name):
        self.name = name

    def __call__(self, st, group, dtype, N):
        return type("P", (), {"name": self.name, "st": st})()


@pytest.mark.parametrize("name,want", [("nl62", "gslab"),
                                       ("basin62", "gmesh"),
                                       ("graded62", "sharded")])
def test_choose_path_order(tmp_path, monkeypatch, name, want):
    """On CUDA ranks the automatic choice is slab_pallas, gslab, gmesh,
    sharded (hercules_tpu/parallel/driver.py:787-849), each refusal's
    reason recorded; on CPU ranks it skips gslab and gmesh; forced
    graded paths build on the CPU or raise their table function's reason.  (The
    path classes are stood in for: this machine may have no card.)"""
    if name == "graded62":
        paths = write_box_case(str(tmp_path), 62.5, 4, 1,
                               layers=GRADED_LAYERS, freq=four_q_freq(62.5))
    elif name == "nl62":
        paths = write_box_case(str(tmp_path), 62.5, 4, 1, layers=NL_LAYERS,
                               freq=NL_FREQ)
    else:
        paths = write_basin_case(str(tmp_path), 62.5, 4, 1)
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    for cls in ("SlabPallasPath", "GslabPath", "GMeshPath", "ShardedPath"):
        monkeypatch.setattr(driver, cls, _Built(cls))
    cuda = RankGroup([torch.device("cuda", 0)] * 2)
    path, reason = driver.choose_path(sim.mesh, sim.tables, cuda)
    assert path.name == {"gslab": "GslabPath", "gmesh": "GMeshPath",
                         "sharded": "ShardedPath"}[want]
    tried = {"gslab": ["slab"], "gmesh": ["slab", "gslab"],
             "sharded": ["slab", "gslab", "gmesh"]}[want]
    assert reason.startswith("no slab decomposition: ")
    for t in ("gslab", "gmesh"):
        assert (f"no {t}: " in reason) == (t in tried)
    monkeypatch.undo()
    cpu = RankGroup(["cpu"] * 2)
    path, reason = driver.choose_path(sim.mesh, sim.tables, cpu)
    assert path.name == "sharded" and "gslab" not in reason
    assert reason.startswith("no slab decomposition: ")
    for forced in ("gslab", "gmesh"):
        if forced == want or (forced == "gmesh" and want == "gslab"):
            assert driver.choose_path(sim.mesh, sim.tables, cpu,
                                      prefer=forced)[0].name == forced
        else:
            with pytest.raises(RuntimeError):
                driver.choose_path(sim.mesh, sim.tables, cpu, prefer=forced)


@pytest.mark.parametrize("mc_path", ["gslab", "gmesh"])
def test_output_files_match_jax(tmp_path, mc_path):
    """The taps on the graded paths (SimOutputs.make_mc_hook): stations,
    4-D displacement, plane records and both checkpoints (fields, carry
    tail, path name and rank count) of a BKT run on 2 ranks -- gslab on
    NL_LAYERS at 62.5 m, gmesh on the basin -- against the JAX
    package's run of the same path."""
    from hercules_tpu.sim import SimOutputs as JaxSimOutputs
    from hercules_tpu_torch.io.output4d import read_4d

    def case(root):
        if mc_path == "gslab":
            paths = write_box_case(str(root), 62.5, N_CK + M_CK, 3,
                                   damping="bkt", layers=NL_LAYERS,
                                   freq=NL_FREQ)
        else:
            paths = write_basin_case(str(root), 62.5, N_CK + M_CK, 3,
                                     damping="bkt")
        add_output_keys(paths[1], paths[2], output_rate=5, planes_rate=2,
                        checkpointing_rate=N_CK)
        return paths

    P, J = tmp_path / "port", tmp_path / "jax"
    sim, _, samp = _run(case(P), mc_path=mc_path)
    paths = case(J)
    jsim = JaxSimulation.setup(paths[1], paths[2], cvmdb=paths[0])
    _, jsamp = jsim.run(dtype=jnp.float64, ndev=2, mc_path=mc_path,
                        rundir=str(J),
                        outputs=JaxSimOutputs(jsim.mesh, jsim.params,
                                              rundir=str(J)))
    assert sim.solver_path_name == jsim.solver_path_name == f"mc:{mc_path}"
    _close(samp, np.asarray(jsamp), "stations")
    hp, dp = read_4d(str(P / "disp.h4d"))
    hj, dj = read_4d(str(J / "disp.h4d"))
    _close(dp, dj, "disp.h4d")
    _close(np.fromfile(P / "planes" / "planedisplacements.0"),
           np.fromfile(J / "planes" / "planedisplacements.0"), "plane")
    for s in (N_CK, N_CK + M_CK):
        cp = [np.load(P / "checkpoints" / f) for f in
              ("checkpoint.out0", "checkpoint.out1")]
        cj = [np.load(J / "checkpoints" / f) for f in
              ("checkpoint.out0", "checkpoint.out1")]
        a = next(z for z in cp if int(z["step"]) == s)
        b = next(z for z in cj if int(z["step"]) == s)
        assert str(a["mc_path"]) == mc_path and int(a["mc_ndev"]) == 2
        for k in ("u_now", "u_prev"):
            _close(a[k], b[k], f"checkpoint {s} {k}")
