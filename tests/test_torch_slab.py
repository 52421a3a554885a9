"""The slab decomposition on the CPU: the port's ``parallel/slab.py`` and
its driver paths ("slab", the plain step; "slab_pallas", a step kernel
per fragment, here the kernels' plain versions) against the JAX
package's ``run_slab_solver`` and ``run_slab_pallas_solver(interpret=
True)`` in float64, on fixture (a) at 62.5 m (one 16 x 16 x 8-element
brick; 3 and 5 ranks split its 8 layers unevenly, 8 ranks leave one
layer each), with the same tables, sources and ranks.  Bounds: 2e-13 of
max|u| against the same JAX path (tests/test_pallas.py:56), rtol 1e-9
against the single-device solver (tests/test_slab.py:42); both copies of
every shared plane bit-identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hercules_tpu.parallel import slab as jslab
from hercules_tpu_torch.convert import mc_state_from_jax
from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, GRADED_LAYERS,
                                         four_q_freq, one_torch_thread,
                                         write_box_case)
from hercules_tpu_torch.parallel import driver
from hercules_tpu_torch.parallel.ranks import RankGroup
from hercules_tpu_torch.parallel.slab import build_slab_tables
from hercules_tpu_torch.sim import Simulation
from hercules_tpu_torch.solver import step

STEPS = 20
BOUND = 2e-13
CASES = {"box": {}, "bkt": dict(damping="bkt"),
         "four_q": dict(damping="bkt", layers=FOUR_Q_LAYERS,
                        freq=four_q_freq(62.5)),
         "graded": dict(layers=GRADED_LAYERS, freq=four_q_freq(62.5))}

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
    scale = np.abs(want).max()
    assert got.shape == want.shape and scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=BOUND * scale,
                               err_msg=what)


def _port(sim, P, cls):
    """(path, final per-rank state, samples) of the port's path ``cls``
    on P CPU ranks."""
    st = build_slab_tables(sim.mesh, sim.tables, P, src_ids=sim.src_ids)
    path = cls(st, RankGroup(["cpu"] * P), torch.float64, sim.mesh.nnum)
    path.attach_stations(sim.stations.nodes, sim.stations.phi)
    state, samp = driver.run_multichip(path, sim.src_forces, STEPS,
                                       sim.params.delta_t, chunk=7)
    return path, state, samp


def _jax(sim, P, kernels):
    """(tables, final stacked carry) of the JAX slab path."""
    jst = jslab.build_slab_tables(sim.mesh, sim.tables, P,
                                  src_ids=sim.src_ids)
    with Mesh(np.array(jax.devices()[:P]), ("d",)) as m:
        if kernels:
            carry = jslab.run_slab_pallas_solver(
                jst, m, sim.src_forces, STEPS, sim.params.delta_t,
                dtype=jnp.float64, chunk=10, interpret=True)
        else:
            carry = jslab.run_slab_solver(jst, m, sim.src_forces, STEPS,
                                          sim.params.delta_t,
                                          dtype=jnp.float64, chunk=10)
    return jst, jax.tree.map(np.asarray, carry)


def _jax_fields(jst, carry, N, kernels):
    if kernels and carry[0].shape[1] == 8:
        return (jslab.slab_pallas_u_global(jst, carry[0], N),
                jslab.slab_pallas_u_global(jst, carry[0], N, row0=3))
    get = jslab.slab_pallas_u_global if kernels else jslab.slab_u_global
    return get(jst, carry[0], N), get(jst, carry[1], N)


def _assert_replicas_equal(path, state):
    """Both copies of every shared plane hold the same bits (u, u-, and
    K2's node-basis memory variables)."""
    st, pl = path.st, path.st.nyp * path.st.nxp
    for r in range(path.n_dev - 1):
        zb = int(st.ez_of[r]) * pl
        lo, hi = state[r], state[r + 1]
        pairs = list(zip(path.step.fields(lo), path.step.fields(hi)))
        if path.name == "slab_pallas" and path.step.tier == "uniform":
            pairs.append((lo[1], hi[1]))
        for a, b in pairs:
            assert torch.equal(a[:, zb:zb + pl], b[:, :pl]), r


@pytest.mark.parametrize("P", [3, 4, 5, 8])
@pytest.mark.parametrize("kernels", [False, True])
def test_slab_matches_jax(sims, P, kernels):
    """u and u- against the JAX slab path of the same kind and against
    the single-device solver; the stations against the single-device
    samples; replicas bit-identical."""
    sim = sims("box")
    cls = driver.SlabPallasPath if kernels else driver.SlabXLAPath
    path, state, samp = _port(sim, P, cls)
    jst, carry = _jax(sim, P, kernels)
    N = sim.mesh.nnum
    ju, jup = _jax_fields(jst, carry, N, kernels)
    _close(path.u_global(state), ju, "u")
    _close(path.up_global(state), jup, "u-")
    one, one_samp = step.run_solver(
        sim.tables, sim.src_ids, sim.src_forces, STEPS, sim.params.delta_t,
        st_nodes=sim.stations.nodes, st_phi=sim.stations.phi, device="cpu")
    np.testing.assert_allclose(path.u_global(state), one[0].numpy(),
                               rtol=1e-9, atol=1e-18)
    _close(samp, one_samp, "stations")
    _assert_replicas_equal(path, state)


@pytest.mark.parametrize("name,tier", [("bkt", "uniform"),
                                       ("four_q", "corner")])
@pytest.mark.parametrize("kernels", [False, True])
def test_slab_bkt_matches_jax(sims, name, tier, kernels):
    """BKT on 4 ranks: one Q set runs K2 per fragment, four Q sets K4
    (the JAX slab's tiers, never K3); the fields and the memory
    variables against the JAX path's, the replicas bit-identical."""
    sim = sims(name)
    cls = driver.SlabPallasPath if kernels else driver.SlabXLAPath
    path, state, _ = _port(sim, 4, cls)
    jst, carry = _jax(sim, 4, kernels)
    N = sim.mesh.nnum
    ju, jup = _jax_fields(jst, carry, N, kernels)
    _close(path.u_global(state), ju, "u")
    _close(path.up_global(state), jup, "u-")
    if kernels:
        assert path.step.tier == tier
        assert {type(m).__name__ for ms in path.step.mods for m in ms} == \
            {"BktStep" if tier == "uniform" else "BktCornerStep"}
        ref = mc_state_from_jax(path, carry)
        for r in range(4):
            _close(state[r][1].numpy(), ref[r][1].numpy(), f"conv {r}")
    else:
        for k in range(4):
            got = np.stack([s[2][k].numpy() for s in state])
            if np.abs(carry[2][k]).max() == 0:     # kappa, shear-only
                assert not got.any()
            else:
                _close(got, carry[2][k], f"conv{k}")
    _assert_replicas_equal(path, state)


def test_slab_rejects_graded_mesh(sims):
    """A mesh of several bricks has no slab decomposition: forcing a
    slab path raises; the automatic choice on CPU ranks takes "sharded"
    and says why (test_slab_rejects_graded_mesh of the JAX package);
    forcing a graded path raises its table function's reason (bricks of 1 and 2
    element layers cannot feed 4 ranks)."""
    sim = sims("graded")
    with pytest.raises(RuntimeError, match="single uniform brick"):
        build_slab_tables(sim.mesh, sim.tables, 4)
    group = RankGroup(["cpu"] * 4)
    for prefer in ("slab", "slab_pallas"):
        with pytest.raises(RuntimeError):
            driver.choose_path(sim.mesh, sim.tables, group, prefer=prefer)
    path, reason = driver.choose_path(sim.mesh, sim.tables, group)
    assert path.name == "sharded" and "single uniform brick" in reason
    for prefer in ("gslab", "gmesh"):
        with pytest.raises(RuntimeError, match="cannot feed"):
            driver.choose_path(sim.mesh, sim.tables, group, prefer=prefer)


def test_slab_needs_a_layer_per_rank(sims):
    sim = sims("box")
    with pytest.raises(RuntimeError, match="cannot feed"):
        build_slab_tables(sim.mesh, sim.tables, 9)
    path, reason = driver.choose_path(sim.mesh, sim.tables,
                                      RankGroup(["cpu"] * 9))
    assert path.name == "sharded" and "cannot feed" in reason


def test_choose_path_by_device(sims):
    """On CPU ranks the automatic choice is the plain slab step (the JAX
    package's CPU rule); the kernels' path when asked for."""
    sim = sims("box")
    path, reason = driver.choose_path(sim.mesh, sim.tables,
                                      RankGroup(["cpu"] * 2))
    assert (path.name, reason) == ("slab", "")
    path, _ = driver.choose_path(sim.mesh, sim.tables,
                                 RankGroup(["cpu"] * 2),
                                 prefer="slab_pallas")
    assert path.name == "slab_pallas"
