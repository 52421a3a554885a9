"""The graded stacked-slab path on the CPU: the port's
``parallel/gslab.py`` (a step kernel per brick fragment, here the
kernels' plain versions; the plane interfaces reconciled on the fine
plane's rank and sent back) against the JAX package's
``run_gslab_solver(interpret=True)`` on its 8 virtual CPU devices in
float64, with the same mesh, tables, sources and ranks.

The depth-graded case is ``NL_LAYERS`` at 4 Hz: 31.25 m elements in the
top 250 m (8 layers) over 62.5 m ones (4 layers), two bricks with one
2:1 hanging interface, the box's point source on the interface plane;
3 ranks split the layers unevenly (3 + 3 + 2 and 2 + 1 + 1, the JAX
package's tests/test_slab.py:195-196), 4 evenly.  The coarse brick's
1,024 elements need ``min_brick_elems=512`` to stay dense, as in the JAX
test.  ``Q2_LAYERS`` splits the fine layer into two BKT Q sets, which
sends every brick to K4.  Bounds: 2e-13 of max|u| against the JAX path
(tests/test_pallas.py:56), 5e-12 against the single-device unstructured
solver (tests/test_slab.py:233); both copies of every shared plane
bit-identical; a restart bit for bit; a JAX checkpoint resumed by the
port, and the port's state carried into the JAX layout
(``convert.mc_state_to_jax``) resumed by the JAX package."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hercules_tpu.parallel import gslab as jgslab
from hercules_tpu.sim import Simulation as JaxSimulation
from hercules_tpu_torch.convert import mc_state_from_jax, mc_state_to_jax
from hercules_tpu_torch.fixtures import (GRADED_LAYERS, NL_FREQ, NL_LAYERS,
                                         RHO, VP, VS, add_output_keys,
                                         four_q_freq, one_torch_thread,
                                         write_basin_case, write_box_case)
from hercules_tpu_torch.io.checkpoint import checkpoint_read
from hercules_tpu_torch.parallel import driver
from hercules_tpu_torch.parallel.gslab import build_gslab_tables
from hercules_tpu_torch.parallel.ranks import RankGroup
from hercules_tpu_torch.sim import SimOutputs, Simulation
from hercules_tpu_torch.solver import step

STEPS = 20
BOUND = 2e-13
FREQ = 4.0
# the fine layer in two materials of two BKT Q sets (Vs 1100, 1500)
Q2_LAYERS = ((0.0, 2200.0, 1100.0, 2300.0), (125.0, 3000.0, 1500.0, 2300.0),
             (250.0, VP, VS, RHO))
CASES = {"deep": dict(layers=NL_LAYERS, freq=FREQ),
         "deep_bkt": dict(damping="bkt", layers=NL_LAYERS, freq=FREQ),
         "q2": dict(damping="bkt", layers=Q2_LAYERS, freq=FREQ)}

_one_torch_thread = one_torch_thread()


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            root = tmp_path_factory.mktemp(name)
            paths = write_box_case(str(root), 31.25, STEPS, 3, **CASES[name])
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


def _port(sim, P):
    st = build_gslab_tables(sim.mesh, sim.tables, P, src_ids=sim.src_ids,
                            min_brick_elems=512)
    path = driver.GslabPath(st, RankGroup(["cpu"] * P), torch.float64,
                            sim.mesh.nnum)
    path.attach_stations(sim.stations.nodes, sim.stations.phi)
    state, samp = driver.run_multichip(path, sim.src_forces, STEPS,
                                       sim.params.delta_t, chunk=7)
    return path, state, samp


def _jax(sim, P):
    jst = jgslab.build_gslab_tables(sim.mesh, sim.tables, P,
                                    src_ids=sim.src_ids, dtype=jnp.float64,
                                    min_brick_elems=512)
    with Mesh(np.array(jax.devices()[:P]), ("d",)) as m:
        carry = jgslab.run_gslab_solver(jst, m, sim.src_forces, STEPS,
                                        sim.params.delta_t,
                                        dtype=jnp.float64, chunk=10,
                                        interpret=True)
    return jst, jax.tree.map(np.asarray, carry)


def _jax_fields(jst, carry, N):
    if np.shape(carry[0][0])[1] == 8:
        return (jgslab.gslab_u_global(jst, carry[0], N),
                jgslab.gslab_u_global(jst, carry[0], N, row0=3))
    return (jgslab.gslab_u_global(jst, carry[0], N),
            jgslab.gslab_u_global(jst, carry[1], N))


def assert_replicas_equal(path, state):
    """Both copies of every fragment-shared plane of every brick hold
    the same bits: u, u- and K2's node-basis memory variables."""
    uniform = path.step.tier == "uniform"
    for b, fb in enumerate(path.st.bricks):
        pl = fb.plane
        for r in range(path.n_dev - 1):
            zb = int(fb.ez_of[r]) * pl
            lo, hi = state[r], state[r + 1]
            pairs = [(lo[0][b][0:6], hi[0][b][0:6])]
            if uniform:
                pairs.append((lo[-1][b][0], hi[-1][b][0]))
            for x, y in pairs:
                assert torch.equal(x[:, zb:zb + pl], y[:, :pl]), (b, r)


def test_interface_source_and_split(sims):
    """The case's geometry: two bricks, one 2:1 hanging interface from
    the fine brick's bottom plane on the last rank to the coarse brick's
    top plane on rank 0, a source node on the interface plane, and the
    uneven split of 3 ranks."""
    sim = sims("deep")
    st = build_gslab_tables(sim.mesh, sim.tables, 3, src_ids=sim.src_ids,
                            min_brick_elems=512)
    assert len(st.bricks) == 2 and len(st.hang) == 1 and not st.same
    h = st.hang[0]
    assert st.hang_own == [(2, int(st.bricks[h.fi].ez_of[-1]), 0, 0)]
    assert sorted(fb.ez_of.tolist() for fb in st.bricks) == [[2, 1, 1],
                                                             [3, 3, 2]]
    iface = st.plan.gnid_cat[st.plan.bricks[h.ci].off:][:h.nyc * h.nxc]
    assert np.isin(sim.src_ids, iface).any()


@pytest.mark.parametrize("P", [3, 4])
def test_gslab_matches_jax(sims, P):
    """Rayleigh: u and u- against the JAX gslab path and against the
    single-device unstructured solver; the stations against the
    latter's samples; replicas bit-identical."""
    sim = sims("deep")
    path, state, samp = _port(sim, P)
    assert path.step.tier == "elastic"
    jst, carry = _jax(sim, P)
    N = sim.mesh.nnum
    ju, jup = _jax_fields(jst, carry, N)
    _close(path.u_global(state), ju, "u")
    _close(path.up_global(state), jup, "u-")
    one, one_samp = step.run_solver(
        sim.tables, sim.src_ids, sim.src_forces, STEPS, sim.params.delta_t,
        st_nodes=sim.stations.nodes, st_phi=sim.stations.phi, device="cpu")
    _close(path.u_global(state), one[0].numpy(), "u single", 5e-12)
    _close(samp, one_samp, "stations", 5e-12)
    assert_replicas_equal(path, state)


@pytest.mark.parametrize("name,tier,module", [
    ("deep_bkt", "uniform", "BktStep"), ("q2", "corner", "BktCornerStep")])
def test_gslab_bkt_matches_jax(sims, name, tier, module):
    """BKT on 4 ranks: one Q set per brick runs K2 on every fragment,
    a brick of two Q sets sends every brick to K4 (gslab.py:130-139);
    the fields and the memory variables against the JAX path's, the
    replicas bit-identical."""
    sim = sims(name)
    path, state, _ = _port(sim, 4)
    assert path.step.tier == tier
    assert {type(m).__name__ for ms in path.step.mods for m in ms} == \
        {module}
    jst, carry = _jax(sim, 4)
    N = sim.mesh.nnum
    ju, jup = _jax_fields(jst, carry, N)
    _close(path.u_global(state), ju, "u")
    _close(path.up_global(state), jup, "u-")
    ref = mc_state_from_jax(path, carry)
    for r in range(4):
        for b in range(2):
            _close(state[r][1][b][0].numpy(), ref[r][1][b][0].numpy(),
                   f"conv rank {r} brick {b}")
    assert_replicas_equal(path, state)


def test_seeded_state_round_trip(sims):
    """A seeded K4 state carried into the JAX layout and back
    (convert.mc_state_to_jax, mc_state_from_jax) is the same state."""
    sim = sims("q2")
    st = build_gslab_tables(sim.mesh, sim.tables, 3, src_ids=sim.src_ids,
                            min_brick_elems=512)
    path = driver.GslabPath(st, RankGroup(["cpu"] * 3), torch.float64,
                            sim.mesh.nnum)
    g = np.random.default_rng(5)
    state = [(tuple(torch.as_tensor(g.standard_normal(S.shape)) *
                    (torch.arange(S.shape[1]) < len(fb.gnid_local[r]))
                    for S, fb in zip(s[0], st.bricks)),
              tuple((torch.as_tensor(g.standard_normal(c[0].shape)) *
                     (torch.arange(c[0].shape[1])
                      < len(fb.gnid_local[r])),) for c, fb in zip(s[1],
                                                                st.bricks)))
             for r, s in enumerate(path.init_state())]
    for s in state:
        for S in s[0]:
            S[6:8] = 0
    jst = jgslab.build_gslab_tables(sim.mesh, sim.tables, 3,
                                    src_ids=sim.src_ids, dtype=jnp.float64,
                                    min_brick_elems=512)
    u = tuple(np.zeros((3, 3, gb.LEN)) for gb in jst.bricks)
    like = (u, u, tuple(np.zeros((3, 96, gb.LEN)) for gb in jst.bricks))
    back = mc_state_from_jax(path, mc_state_to_jax(path, state, like))
    for a, b in zip(driver._flat(state), driver._flat(back)):
        assert torch.equal(a, b)


def test_gslab_refusals(sims, tmp_path):
    """build_gslab_tables raises, so that the automatic choice falls
    through: loose elements (the default brick floor leaves the coarse
    1,024 elements loose), a laterally graded mesh (interfaces not full
    z-planes), a brick with fewer element layers than ranks, and one
    brick."""
    sim = sims("deep")
    with pytest.raises(RuntimeError, match="no loose elements"):
        build_gslab_tables(sim.mesh, sim.tables, 2)
    with pytest.raises(RuntimeError, match="cannot feed"):
        build_gslab_tables(sim.mesh, sim.tables, 5, min_brick_elems=512)
    paths = write_basin_case(str(tmp_path / "basin"), 62.5, 4, 1)
    basin = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    with pytest.raises(RuntimeError, match="z-planes"):
        build_gslab_tables(basin.mesh, basin.tables, 2)
    paths = write_box_case(str(tmp_path / "box"), 62.5, 4, 1)
    box = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    with pytest.raises(RuntimeError, match=">=2 dense bricks"):
        build_gslab_tables(box.mesh, box.tables, 2)
    paths = write_box_case(str(tmp_path / "graded"), 62.5, 4, 1,
                           layers=GRADED_LAYERS, freq=four_q_freq(62.5))
    graded = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    with pytest.raises(RuntimeError, match="brick 1: 1 element layers"):
        build_gslab_tables(graded.mesh, graded.tables, 2)


# ---- through Simulation.run: restart and checkpoints across packages -----

N_CK, M_CK = 10, 10     # steps before and after the checkpoint


def _case(root):
    """BKT on NL_LAYERS at 62.5 m: bricks of 4 and 2 layers, both under
    the default brick floor, so both stay dense; a checkpoint at
    N_CK."""
    paths = write_box_case(str(root), 62.5, N_CK + M_CK, 3, damping="bkt",
                           layers=NL_LAYERS, freq=NL_FREQ)
    add_output_keys(paths[1], paths[2], checkpointing_rate=N_CK)
    return paths


def _run(paths):
    rundir = os.path.dirname(os.path.dirname(paths[1]))
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    state, samp = sim.run(
        device="cpu", devices=["cpu"] * 2, mc_path="gslab", rundir=rundir,
        outputs=lambda: SimOutputs(sim.mesh, sim.params, rundir=rundir))
    return sim, state, samp


def _jax_run(paths):
    from hercules_tpu.sim import SimOutputs as JaxSimOutputs
    rundir = os.path.dirname(os.path.dirname(paths[1]))
    jsim = JaxSimulation.setup(paths[1], paths[2], cvmdb=paths[0])
    out = JaxSimOutputs(jsim.mesh, jsim.params, rundir=rundir)
    state, samp = jsim.run(dtype=jnp.float64, outputs=out, rundir=rundir,
                           ndev=2, mc_path="gslab")
    return jsim, jax.tree.map(np.asarray, state), np.asarray(samp)


def _resume_dir(a_dir, b_dir, paths):
    shutil.copytree(a_dir / "in", b_dir / "in")
    shutil.copy(paths[0], b_dir / "box.e")
    (b_dir / "checkpoints").mkdir()
    for f in ("checkpoint.out0", "checkpoint.out1"):
        src = a_dir / "checkpoints" / f
        if checkpoint_read(str(src))[0] == N_CK:
            shutil.copy(src, b_dir / "checkpoints" / "checkpoint.in")
    return [str(b_dir / os.path.relpath(p, a_dir)) for p in paths]


def test_restart_is_bit_exact(tmp_path):
    """BKT on 2 ranks: run B from run A's step-N checkpoint ends in A's
    state bit for bit (every rank and brick, the memory variables too),
    its station rows A's."""
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    paths = _case(a_dir)
    sim_a, st_a, smp_a = _run(paths)
    sim_b, st_b, smp_b = _run(_resume_dir(a_dir, b_dir, paths))
    assert sim_a.solver_path_name == "mc:gslab"
    assert (sim_a.start_step, sim_b.start_step) == (0, N_CK)
    la, lb = driver._flat(st_a), driver._flat(st_b)
    assert len(la) == len(lb) == 2 * 2 * 2
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert np.array_equal(smp_b, smp_a[N_CK:]) and np.abs(smp_a).max() > 0
    assert_replicas_equal(sim_a.mc_path, st_a)


def test_checkpoints_cross_packages(tmp_path):
    """The JAX package's gslab BKT checkpoint of step N (its node basis
    of 8 rows per brick, fitted to the port's 6) resumed by the port,
    and the port's state of step N carried into the JAX layout
    (convert.mc_state_to_jax) resumed by the JAX package's driver, each
    end within the bound of the other package's straight run."""
    from hercules_tpu.parallel import driver as jdriver
    j_dir, p_dir = tmp_path / "jax", tmp_path / "port"
    paths_j, paths_p = _case(j_dir), _case(p_dir)
    jsim, jstate, jsamp = _jax_run(paths_j)
    sim, state, samp = _run(paths_p)
    assert jsim.solver_path_name == sim.solver_path_name == "mc:gslab"
    _close(samp, jsamp, "stations")
    ju = jsim.mc_path.u_global(jstate)
    _close(sim.mc_path.u_global(state), ju, "u")
    # the JAX checkpoint resumed by the port
    sim_b, st_b, smp_b = _run(_resume_dir(j_dir, tmp_path / "pb", paths_j))
    assert sim_b.start_step == N_CK
    _close(smp_b, jsamp[N_CK:], "stations from the JAX checkpoint")
    _close(sim_b.mc_path.u_global(st_b), ju, "u from the JAX checkpoint")
    ref = mc_state_from_jax(sim_b.mc_path, jstate)
    for r in range(2):
        for b in range(2):
            _close(st_b[r][1][b][0].numpy(), ref[r][1][b][0].numpy(),
                   f"conv {r} {b}")
    # the port's state of step N resumed by the JAX package
    p_half = Simulation.setup(paths_p[1], paths_p[2], cvmdb=paths_p[0])
    st_n, _ = p_half.run(device="cpu", devices=["cpu"] * 2,
                         mc_path="gslab", total_steps=N_CK,
                         rundir=str(tmp_path))
    jpath = jsim.mc_path
    carry = mc_state_to_jax(p_half.mc_path, st_n,
                            jax.tree.map(np.asarray, jpath.init_state()))
    with Mesh(np.array(jax.devices()[:2]), ("d",)) as m:
        jst_b, jsmp_b = jdriver.run_multichip(
            jpath, m, jsim.src_forces, N_CK + M_CK, jsim.params.delta_t,
            state=jax.tree.map(jnp.asarray, carry), start_step=N_CK)
    _close(np.asarray(jsmp_b), samp[N_CK:],
           "JAX stations from the port's state")
    _close(jpath.u_global(jax.tree.map(np.asarray, jst_b)),
           sim.mc_path.u_global(state), "JAX u from the port's state")
