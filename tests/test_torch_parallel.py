"""The sharded path on the CPU: the port's ``parallel/partition.py`` (the
JAX package's file) and ``parallel/sharded.py`` on P CPU ranks against
the JAX package's ``run_sharded`` and ``Simulation.run(ndev=4,
mc_path="sharded")`` in float64, on in-repo inputs: fixture (a) at
62.5 m, elastic and BKT; the graded box (GRADED_LAYERS at 62.5 m, 264
dangling nodes); nonlinear soil with and without geostatic loading;
DRM part 2; fixed-base buildings.  Bound: 2e-13 of max|u| (the same
algebra; the element-force product sums in BLAS's order, ROADMAP
reference behaviour 9; 2e-12 on the nonlinear station columns, which
the host replays from the sampled corners); every replica of a shared
node bit-identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hercules_tpu.parallel import partition as jpartition
from hercules_tpu.parallel import sharded as jsharded
from hercules_tpu.sim import Simulation as JaxSimulation
from hercules_tpu_torch.fixtures import (BUILDING_DT, GRADED_LAYERS,
                                         NL_FREQ, NL_LAYERS,
                                         add_building_keys, add_drm_keys,
                                         add_nonlinear_keys, box_dt,
                                         four_q_freq, one_torch_thread,
                                         write_box_case)
from hercules_tpu_torch.parallel import driver
from hercules_tpu_torch.parallel.partition import shard_tables
from hercules_tpu_torch.parallel.ranks import RankGroup
from hercules_tpu_torch.sim import Simulation

STEPS = 20
BOUND = 2e-13
CASES = {"box": {}, "bkt": dict(damping="bkt"),
         "graded": dict(layers=GRADED_LAYERS, freq=four_q_freq(62.5)),
         "graded_bkt": dict(damping="bkt", layers=GRADED_LAYERS,
                            freq=four_q_freq(62.5))}

_one_torch_thread = one_torch_thread()


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            root = tmp_path_factory.mktemp(name)
            paths = write_box_case(str(root), 62.5, STEPS, 3, **CASES[name])
            made[name] = Simulation.setup(paths[1], paths[2],
                                          cvmdb=paths[0])
        return made[name]

    return get


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert got.shape == want.shape and scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=BOUND * scale,
                               err_msg=what)


def _assert_replicas_equal(path, state):
    """Every local copy of a node holds the same bits of u and u-."""
    st = path.st
    for k in (0, 1):
        first = {}
        for r, g in enumerate(st.local_globals):
            a = state[r][k].numpy()[:len(g)]
            for n, row in zip(g.tolist(), a):
                if n in first:
                    assert np.array_equal(first[n], row), (k, n, r)
                else:
                    first[n] = row


@pytest.mark.parametrize("name,P", [(n, P) for n in ("box", "bkt")
                                    for P in (2, 4, 8)]
                         + [("graded", 4), ("graded_bkt", 4)])
def test_sharded_matches_jax(sims, name, P):
    """run_multichip on the sharded path against run_sharded: u, u-, the
    memory variables; the replicas bit-identical; the stations against
    the single-device unstructured solver's samples."""
    sim = sims(name)
    if name.startswith("graded"):
        assert len(sim.mesh.dn_ids) == 264
    st = shard_tables(sim.tables, sim.mesh, P, src_ids=sim.src_ids)
    path = driver.ShardedPath(st, RankGroup(["cpu"] * P), torch.float64,
                              sim.mesh.nnum)
    path.attach_stations(sim.stations.nodes, sim.stations.phi)
    state, samp = driver.run_multichip(path, sim.src_forces, STEPS,
                                       sim.params.delta_t, chunk=7)
    jst = jpartition.shard_tables(sim.tables, sim.mesh, P,
                                  src_ids=sim.src_ids)
    with Mesh(np.array(jax.devices()[:P]), ("d",)) as m:
        carry = jsharded.run_sharded(jst, m, sim.src_forces, STEPS,
                                     sim.params.delta_t, dtype=jnp.float64,
                                     chunk=10)
    carry = jax.tree.map(np.asarray, carry)
    N = sim.mesh.nnum
    _close(path.u_global(state), jsharded.gather_global(jst, carry[0], N),
           "u")
    _close(path.up_global(state), jsharded.gather_global(jst, carry[1], N),
           "u-")
    tail = path.tail(state)
    assert len(tail) == len(carry[2]) == (4 if "bkt" in name else 0)
    for k, (a, b) in enumerate(zip(tail, carry[2])):
        if np.abs(b).max() == 0:                 # kappa, shear-only
            assert not a.any()
        else:
            _close(a, b, f"conv{k}")
    _assert_replicas_equal(path, state)
    _, one = sim.run(device="cpu", solver="unstructured")
    _close(samp, one, "stations")


def _mc_pair(root, jroot, ph, nu, cv, rundir=None, **kw):
    """Simulation.run(ndev=4) of the port (CPU ranks) and of the JAX
    package on the same files: (port sim, state, samples, JAX sim,
    state, samples)."""
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    state, samp = sim.run(device="cpu", ndev=4,
                          rundir=rundir or str(root), **kw)
    jsim = JaxSimulation.setup(ph, nu, cvmdb=cv)
    jstate, jsamp = jsim.run(dtype=jnp.float64, ndev=4,
                             rundir=rundir or str(jroot), mc_path="sharded")
    return sim, state, samp, jsim, jax.tree.map(np.asarray, jstate), \
        np.asarray(jsamp)


def _assert_mc_close(sim, state, samp, jsim, jstate, jsamp):
    assert sim.solver_path_name == jsim.solver_path_name == "mc:sharded"
    N = sim.mesh.nnum
    _close(sim.mc_path.u_global(state),
           jsharded.gather_global(jsim.mc_path.st, jstate[0], N), "u")
    _close(samp, jsamp, "stations")
    tail = sim.mc_path.tail(state)
    jtail = jax.tree.leaves(jstate[2:])
    assert len(tail) == len(jtail)
    for k, (a, b) in enumerate(zip(tail, jtail)):
        if np.abs(b).max() == 0:
            assert not a.any(), k
        else:
            _close(a, b, f"tail {k}")
    _assert_replicas_equal(sim.mc_path, state)


@pytest.mark.parametrize("geostatic", [False, True])
def test_sharded_nonlinear_matches_jax(tmp_path, geostatic):
    """Nonlinear soil on 4 ranks (NL_LAYERS: the soft layer nonlinear)
    on the sharded path: with geostatic loading the automatic choice
    (gmesh refuses it), its reason written; without, forced (the
    automatic choice takes gmesh, tests/test_torch_gmesh.py); stations,
    u, the plastic state and the stations' nonlinear columns against the
    JAX package's sharded run."""
    paths = write_box_case(str(tmp_path), 62.5, STEPS, 5, layers=NL_LAYERS,
                           freq=NL_FREQ)
    add_nonlinear_keys(paths[2], 2000.0,
                       **(dict(geostatic_s=0.05, cushion_s=0.01)
                          if geostatic else {}))
    got = _mc_pair(tmp_path, tmp_path, paths[1], paths[2], paths[0],
                   **({} if geostatic else {"mc_path": "sharded"}))
    sim, jsim = got[0], got[3]
    if geostatic:
        assert "nonlinear soil" in sim.solver_path_reason
        assert "gmesh: geostatic loading" in sim.solver_path_reason
    else:
        assert sim.solver_path_reason == ""
    _assert_mc_close(*got)
    assert sim.nl_station_extras.keys() == jsim.nl_station_extras.keys()
    # the stations' columns replay the plastic recursion on the host
    # from the sampled corners, which amplifies their last bits
    for k, v in jsim.nl_station_extras.items():
        scale = np.abs(v).max()
        np.testing.assert_allclose(sim.nl_station_extras[k], v, rtol=0,
                                   atol=2e-12 * scale)


def test_sharded_drm_part2_matches_jax(tmp_path):
    """DRM part 2 on 4 ranks from part-1 records of the single-device
    unstructured solver: the effective forces on the rank that owns
    each node; against the JAX package's sharded run."""
    def case(part):
        paths = write_box_case(str(tmp_path / part), 62.5, STEPS, 2,
                               damping="none",
                               hypocenter=(100.0, 100.0, 100.0))
        add_drm_keys(paths[2], str(tmp_path / "files"), part,
                     box_dt(62.5))
        return paths

    paths = case("part1")
    Simulation.setup(paths[1], paths[2], cvmdb=paths[0]).run(
        device="cpu", solver="unstructured")
    paths = case("part2")
    got = _mc_pair(tmp_path / "part2", tmp_path / "part2", paths[1],
                   paths[2], paths[0])
    assert "DRM part 2" in got[0].solver_path_reason
    _assert_mc_close(*got)


def test_sharded_fixed_base_matches_jax(tmp_path):
    """Fixed-base buildings on 4 ranks: every local copy of a base node
    set to the prescribed series; against the JAX package's run."""
    cv, ph, nu = write_box_case(str(tmp_path), 62.5, STEPS, 5,
                                dt=BUILDING_DT)
    add_building_keys(str(tmp_path), nu, fixed_base=True)
    got = _mc_pair(tmp_path, tmp_path, ph, nu, cv)
    sim, state = got[0], got[1]
    assert "fixed-base" in sim.solver_path_reason
    _assert_mc_close(*got)
    ids, which = sim.mesh.buildings.base_nodes(sim.mesh)
    p = sim.params
    series = sim.mesh.buildings.base_disp_series(
        p.end_time - p.start_time, p.delta_t, STEPS, rundir=str(tmp_path))
    assert np.array_equal(sim.mc_path.u_global(state)[ids],
                          series[-1, which])


def test_physics_refuses_a_slab_path(tmp_path):
    """Nonlinear soil runs on gmesh or the sharded path: forcing a slab
    path, or gslab, raises before the loop; forcing gmesh runs it
    there."""
    paths = write_box_case(str(tmp_path), 62.5, STEPS, 2, layers=NL_LAYERS,
                           freq=NL_FREQ)
    add_nonlinear_keys(paths[2], 2000.0)
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    for forced in ("slab_pallas", "gslab"):
        with pytest.raises(RuntimeError, match="sharded path"):
            sim.run(device="cpu", ndev=2, mc_path=forced,
                    rundir=str(tmp_path))
    sim.run(device="cpu", ndev=2, mc_path="gmesh", rundir=str(tmp_path),
            total_steps=2)
    assert sim.solver_path_name == "mc:gmesh"


def test_seeded_state_into_both(sims):
    """A seeded BKT state (global fields and per-element memory
    variables) given to both packages' sharded paths -- the port's
    through state_from_global, the JAX package's through
    convert.mc_state_to_jax, which mc_state_from_jax inverts exactly --
    ends STEPS steps later within the bound of each other."""
    from hercules_tpu_torch.convert import mc_state_from_jax, mc_state_to_jax
    from hercules_tpu_torch.parallel.partition import _block_bounds
    sim, P = sims("bkt"), 4
    st = shard_tables(sim.tables, sim.mesh, P, src_ids=sim.src_ids)
    path = driver.ShardedPath(st, RankGroup(["cpu"] * P), torch.float64,
                              sim.mesh.nnum)
    g = np.random.default_rng(3)
    N, E = sim.mesh.nnum, sim.mesh.lenum
    u = 1e-3 * g.standard_normal((N, 3))
    up = u - 1e-4 * g.standard_normal((N, 3))
    conv = 1e-4 * g.standard_normal((4, E, 8, 3))
    lo, hi = _block_bounds(E, P)
    tail = np.zeros((4, P, st.E_pad, 8, 3))
    for r in range(P):
        tail[:, r, :hi[r] - lo[r]] = conv[:, lo[r]:hi[r]]
    state = path.state_from_global(u, up, tuple(tail))
    jst = jpartition.shard_tables(sim.tables, sim.mesh, P,
                                  src_ids=sim.src_ids)
    like = jax.tree.map(np.asarray,
                        jsharded.init_sharded_state(jst, jnp.float64))
    jcarry = mc_state_to_jax(path, state, like)
    back = mc_state_from_jax(path, jcarry)
    for a, b in zip(driver._flat(state), driver._flat(back)):
        assert torch.equal(a, b)
    state, _ = driver.run_multichip(path, sim.src_forces, STEPS,
                                    sim.params.delta_t, state=state)
    with Mesh(np.array(jax.devices()[:P]), ("d",)) as m:
        jcarry = jsharded.run_sharded(
            jst, m, sim.src_forces, STEPS, sim.params.delta_t,
            dtype=jnp.float64, state=jax.tree.map(jnp.asarray, jcarry))
    jcarry = jax.tree.map(np.asarray, jcarry)
    _close(path.u_global(state), jsharded.gather_global(jst, jcarry[0], N),
           "u")
    for k, (a, b) in enumerate(zip(path.tail(state), jcarry[2])):
        _close(a, b, f"conv{k}")
