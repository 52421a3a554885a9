"""The unstructured solver on the CPU: the port's ``solver/step.py``
against the JAX package's ``hercules_tpu/solver/step.py`` in float64, on
the same ``assemble`` tables, sources and stations (states carried
across by ``convert``), and ``Simulation.run``'s ``solver=`` choice
against the JAX package's routing.  Bound: 2e-13 of max|u| and of the
largest sample (the same algebra, as tests/test_pallas.py:56)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.sim import Simulation as JaxSimulation
from hercules_tpu.solver import step as jstep
from hercules_tpu_torch.convert import (unstructured_state_from_jax,
                                        unstructured_state_to_global)
from hercules_tpu_torch.fixtures import (GRADED_LAYERS, NL_PROPERTIES,
                                         SOFT_FREQ, SOFT_LAYERS,
                                         four_q_freq, one_torch_thread,
                                         write_box_case)
from hercules_tpu_torch.sim import Simulation
from hercules_tpu_torch.solver import step

STEPS = 40
BOUND = 2e-13
# write_box_case keywords of each 62.5 m case: fixture (a); the graded
# box (592 elements, 264 dangling nodes); BKT shear-only, with the bulk
# attenuation, and on the graded box
CASES = {"box": {},
         "graded": dict(layers=GRADED_LAYERS, freq=four_q_freq(62.5)),
         "bkt": dict(damping="bkt"),
         "soft": dict(damping="bkt", layers=SOFT_LAYERS, freq=SOFT_FREQ),
         "graded_bkt": dict(damping="bkt", layers=GRADED_LAYERS,
                            freq=four_q_freq(62.5))}


_one_torch_thread = one_torch_thread()


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            root = tmp_path_factory.mktemp(name)
            paths = write_box_case(str(root), 62.5, STEPS, 5, **CASES[name])
            made[name] = (Simulation.setup(paths[1], paths[2],
                                           cvmdb=paths[0]), paths)
        return made[name]

    return get


def _close(got, want, what):
    scale = np.abs(want).max()
    assert got.shape == want.shape and scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=BOUND * scale,
                               err_msg=what)


def _both(sim, **kw):
    """run_solver of both packages, float64, STEPS steps, on the case's
    tables, sources and stations: (port (u, up, conv), port samples,
    JAX (u, up, conv), JAX samples), numpy."""
    st = sim.stations
    args = (sim.tables, sim.src_ids, sim.src_forces, STEPS,
            sim.params.delta_t)
    state, samp = step.run_solver(*args, st_nodes=st.nodes, st_phi=st.phi,
                                  device="cpu", **kw)
    jkw = dict(kw)
    if "state" in jkw:
        jkw["state"] = tuple(
            None if x is None else
            tuple(jnp.asarray(c) for c in x) if isinstance(x, tuple)
            else jnp.asarray(x) for x in kw["state"])
    jstate, jsamp = jstep.run_solver(*args, st_nodes=st.nodes,
                                     st_phi=st.phi, dtype=jnp.float64,
                                     **jkw)
    return (unstructured_state_to_global(state), samp,
            unstructured_state_from_jax(jstate), np.asarray(jsamp))


def _assert_states_close(mine, ref, samp, jsamp):
    for k, name in enumerate(("u", "up")):
        _close(mine[k], ref[k], name)
    assert (mine[2] is None) == (ref[2] is None)
    if ref[2] is not None:
        assert len(mine[2]) == len(ref[2]) == 4
        assert np.abs(ref[2][0]).max() > 0
    for i, (a, b) in enumerate(zip(mine[2] or (), ref[2] or ())):
        if np.abs(b).max() == 0:        # kappa, shear-only attenuation
            assert a.shape == b.shape and not a.any(), f"conv{i}"
        else:
            _close(a, b, f"conv{i}")
    _close(samp, jsamp, "samples")


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_solver_matches_jax(sims, name):
    sim, _ = sims(name)
    if name.startswith("graded"):
        assert len(sim.mesh.dn_ids) == 264
    mine, samp, ref, jsamp = _both(sim)
    assert (mine[2] is not None) == (sim.tables.damping == "bkt")
    if mine[2] is not None:
        assert len(mine[2]) == 4 and mine[2][0].shape == (sim.mesh.lenum,
                                                        8, 3)
    _assert_states_close(mine, ref, samp, jsamp)


@pytest.mark.parametrize("name", ["graded", "graded_bkt"])
def test_step_sums_are_bit_equal_to_jax(sims, name):
    """One step's parts on the same seeded input.  The element forces
    agree within the bound (the [E, 48] @ [48, 24] product, whose sum
    order is the BLAS's); given the same element forces, the
    element-to-node sum and the dangling distribution are bit-equal to
    JAX's, both summing each node's rows in the tables' fixed order."""
    sim, _ = sims(name)
    T, N, E = sim.tables, sim.mesh.nnum, sim.mesh.lenum
    rng = np.random.default_rng(11)
    u = rng.standard_normal((N, 3))
    up = u + 1e-3 * rng.standard_normal((N, 3))
    conv = (tuple(1e-3 * rng.standard_normal((E, 8, 3)) for _ in range(4))
            if T.damping == "bkt" else None)
    d = step._dev(T, torch.float64, "cpu")
    dj = jstep._dev(T, jnp.float64)
    f, new = step.element_forces(
        d, T.damping, torch.tensor(u), torch.tensor(up),
        None if conv is None else tuple(map(torch.tensor, conv)))
    fj, newj = jstep.element_forces(
        dj, T.damping, jnp.asarray(u), jnp.asarray(up),
        None if conv is None else tuple(map(jnp.asarray, conv)))
    _close(f.numpy(), np.asarray(fj), "element forces")
    for i, (a, b) in enumerate(zip(new or (), newj or ())):
        _close(a.numpy(), np.asarray(b), f"conv{i}")
    nodes = step.scatter_to_nodes(d, N, torch.tensor(np.asarray(fj)))
    nodes_j = jstep.scatter_to_nodes(dj, N, fj)
    assert np.array_equal(nodes.numpy(), np.asarray(nodes_j))
    assert len(T.dn_ids) == 264
    dist = step.dangling_distribute(d, N, nodes)
    dist_j = jstep.dangling_distribute(dj, N, nodes_j)
    assert np.array_equal(dist.numpy(), np.asarray(dist_j))
    assert not np.array_equal(dist.numpy(), nodes.numpy())


def test_run_solver_resumes_a_jax_state(sims):
    """From a seeded random state (u, u-, and BKT memory variables),
    carried to both packages as numpy, at step 7."""
    sim, _ = sims("graded_bkt")
    rng = np.random.default_rng(20261017)
    N, E = sim.mesh.nnum, sim.mesh.lenum
    u = 1e-3 * rng.standard_normal((N, 3))
    state = (u, u - 1e-5 * rng.standard_normal((N, 3)),
             tuple(1e-4 * rng.standard_normal((E, 8, 3)) for _ in range(4)))
    mine, samp, ref, jsamp = _both(sim, state=state, start_step=7)
    assert samp.shape == (STEPS - 7, 5, 3)
    _assert_states_close(mine, ref, samp, jsamp)


def test_drm_bundle_matches_jax(sims):
    """A synthetic DRM PART2 bundle (seeded effective-force records on 40
    nodes, 3 steps per record, 5 records: the record index clips at the
    last pair after step 9), no source."""
    sim, _ = sims("graded")
    rng = np.random.default_rng(7)
    ids = np.sort(rng.choice(sim.mesh.nnum, 40, replace=False))
    drm = {"ids": ids.astype(np.int32), "aux": 3,
           "F": 1e3 * rng.standard_normal((5, 40, 3))}
    sim_src = sim.src_forces
    try:
        sim.src_forces = np.zeros_like(sim_src)
        mine, samp, ref, jsamp = _both(sim, drm=drm)
    finally:
        sim.src_forces = sim_src
    _assert_states_close(mine, ref, samp, jsamp)


def test_fixed_base_matches_jax(sims):
    """Synthetic fixed-base buildings: 12 nodes held to a seeded
    displacement series [T, 12, 3]."""
    sim, _ = sims("box")
    rng = np.random.default_rng(11)
    fb_ids = np.sort(rng.choice(sim.mesh.nnum, 12, replace=False))
    t = np.arange(STEPS)[:, None, None]
    fb_series = 1e-4 * np.sin(0.2 * t + rng.uniform(0, 6, (1, 12, 3)))
    mine, samp, ref, jsamp = _both(sim, fb_ids=fb_ids, fb_series=fb_series)
    np.testing.assert_array_equal(mine[0][fb_ids], fb_series[-1])
    _assert_states_close(mine, ref, samp, jsamp)


def test_nonlinear_branch_runs(sims):
    """The nonlinear branch on fixture (a), every element nonlinear with
    the linear material model: the stress integral (2x2x2 Gauss, exact
    for trilinear hexahedra) takes the place of the linear stiffness,
    so the run matches the linear one's (the JAX package's
    test_linear_model_matches_stiffness), with the plastic state in the
    carry and in the JAX package's layout."""
    from hercules_tpu.nonlinear import (NonlinearConfig as JaxConfig,
                                        build_nonlinear_tables as jax_build)
    from hercules_tpu_torch.nonlinear import (NonlinearConfig,
                                              build_nonlinear_tables)
    sim, _ = sims("box")
    table = np.array(NL_PROPERTIES)

    def config(cls):
        return cls(vs_cut=1e9, vs_limits=table[:, 0],
                   alpha_cohes=table[:, 1], kay_phis=table[:, 2],
                   strain_rates=table[:, 3], sensitivities=table[:, 4],
                   hardening=table[:, 5])

    nlt = build_nonlinear_tables(sim.mesh, sim.params,
                                 config(NonlinearConfig))
    assert nlt.n == sim.mesh.lenum
    nl = step.attach_nonlinear(sim.mesh, sim.params, sim.tables, nlt,
                               device="cpu")
    st = sim.stations
    args = (sim.tables, sim.src_ids, sim.src_forces, STEPS,
            sim.params.delta_t)
    state, samp = step.run_solver(*args, st_nodes=st.nodes, st_phi=st.phi,
                                  nl=nl, device="cpu")
    lin, lsamp = step.run_solver(*args, st_nodes=st.nodes, st_phi=st.phi,
                                 device="cpu")
    assert len(state) == 4 and [tuple(a.shape) for a in state[3]] == [
        (nlt.n, 8, 6), (nlt.n, 8, 6), (nlt.n, 8)]
    # the two operators round differently: JAX's bound for this check
    # (tests/test_nonlinear.py:78-82), 1e-9 of max|u|
    scale = np.abs(lin[0].numpy()).max()
    np.testing.assert_allclose(state[0].numpy(), lin[0].numpy(), rtol=0,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(samp, lsamp, rtol=0,
                               atol=1e-9 * np.abs(lsamp).max())
    jnlt = jax_build(sim.mesh, sim.params, config(JaxConfig))
    jstate, _ = jstep.run_solver(
        *args, dtype=jnp.float64,
        nl=jstep.attach_nonlinear(sim.mesh, sim.params, sim.tables, jnlt))
    sig, pstr, ep = unstructured_state_to_global(state)[3]
    _close(sig, np.asarray(jstate[3][0]), "stresses")
    # the linear model leaves the plastic strains and ep at zero
    for a, b in ((pstr, jstate[3][1]), (ep, jstate[3][2])):
        assert not a.any() and not np.asarray(b).any()


def test_repeat_runs_are_bit_identical(sims):
    """Two runs of the graded BKT case give the same bits (every sum in
    a fixed order)."""
    sim, _ = sims("graded_bkt")
    a = step.run_solver(sim.tables, sim.src_ids, sim.src_forces, 10,
                        sim.params.delta_t, device="cpu")[0]
    b = step.run_solver(sim.tables, sim.src_ids, sim.src_forces, 10,
                        sim.params.delta_t, device="cpu")[0]
    for x, y in zip(a[:2] + a[2], b[:2] + b[2]):
        assert torch.equal(x, y)


# ---- Simulation.run(solver=...) ---------------------------------------

def test_auto_runs_unstructured_where_build_plan_raises(sims, monkeypatch):
    """Where build_plan raises, "auto" runs the unstructured solver: its
    samples are run_solver's."""
    from hercules_tpu_torch.solver import bricks

    def no_plan(mesh, **kw):
        raise RuntimeError("no brick decomposition")

    sim, _ = sims("graded")
    monkeypatch.setattr(bricks, "build_plan", no_plan)
    # the plan an earlier run kept (Simulation.brick_plan) is set aside
    monkeypatch.setattr(sim, "_plans", {})
    (u, _, conv), samp = sim.run(device="cpu", total_steps=STEPS)
    assert sim.solver_path_name == "unstructured"
    assert u.shape == (sim.mesh.nnum, 3) and conv is None
    _, want = step.run_solver(sim.tables, sim.src_ids, sim.src_forces,
                              STEPS, sim.params.delta_t,
                              st_nodes=sim.stations.nodes,
                              st_phi=sim.stations.phi, device="cpu")
    assert np.array_equal(samp, want)
    for solver in ("bricks", "pallas"):
        with pytest.raises(RuntimeError, match="no brick decomposition"):
            sim.run(device="cpu", total_steps=2, solver=solver)


def test_conventional_stiffness_runs_bricks(tmp_path):
    """stiffness_calculation_method = conventional under "auto" runs the
    plain brick solver, as the JAX package's auto does."""
    paths = write_box_case(str(tmp_path), 62.5, STEPS, 2)
    with open(paths[2], "a") as f:
        f.write("stiffness_calculation_method = conventional\n")
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    assert sim.params.stiffness_method == "conventional"
    _, samp = sim.run(device="cpu")
    assert sim.solver_path_name == "bricks"
    jsim = JaxSimulation.setup(paths[1], paths[2], cvmdb=paths[0])
    _, jsamp = jsim.run(dtype=jnp.float64, ndev=1)
    assert jsim.solver_path_name == "bricks"
    _close(samp, np.asarray(jsamp), "samples")
    sim.run(device="cpu", total_steps=2, solver="pallas")
    assert sim.solver_path_name == "torch_plain"


@pytest.mark.parametrize("solver", ["bricks", "unstructured"])
@pytest.mark.parametrize("name", ["graded", "graded_bkt"])
def test_solver_choice_matches_jax(sims, name, solver):
    """The port's Simulation.run(solver=...) against the JAX package's
    on the graded box (three bricks, dangling nodes): the same route
    name, global u and samples within the bound."""
    sim, paths = sims(name)
    state, samp = sim.run(device="cpu", solver=solver)
    assert sim.solver_path_name == solver
    jsim = JaxSimulation.setup(paths[1], paths[2], cvmdb=paths[0])
    jstate, jsamp = jsim.run(dtype=jnp.float64, solver=solver, ndev=1)
    assert jsim.solver_path_name == solver
    if solver == "unstructured":
        u, ju = state[0].numpy(), np.asarray(jstate[0])
    else:
        from hercules_tpu.solver.brickstep import brick_u_global
        from hercules_tpu_torch.solver.bricks import build_plan
        plan = build_plan(sim.mesh)
        u = brick_u_global(plan, state[0].numpy(), sim.mesh.nnum)
        ju = brick_u_global(plan, np.asarray(jstate[0]), sim.mesh.nnum)
    _close(u, ju, "u")
    _close(samp, np.asarray(jsamp), "samples")


def test_unknown_solver_and_damping_refused_by_pallas(sims, tmp_path):
    sim, _ = sims("box")
    with pytest.raises(ValueError, match="solver='fused'"):
        sim.run(device="cpu", solver="fused")
    paths = write_box_case(str(tmp_path), 62.5, 4, 2, damping="kelvin")
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    with pytest.raises(RuntimeError, match="damping=kelvin"):
        sim.run(device="cpu", solver="pallas")
    sim.run(device="cpu")
    assert sim.solver_path_name == "bricks"


def test_run_solver_defaults_to_cuda(sims, monkeypatch):
    import inspect
    assert inspect.signature(step.run_solver).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim, _ = sims("box")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        step.run_solver(sim.tables, sim.src_ids, sim.src_forces, 2,
                        sim.params.delta_t)


def test_unstructured_cost_counts_the_tables(sims):
    """utils/roofline.unstructured_cost: each table and field the step
    needs read once (indices as int32), u+ written once; elastic only."""
    from hercules_tpu_torch.utils import roofline
    sim, _ = sims("box")
    t = sim.tables
    c = roofline.unstructured_cost(t, torch.float64)
    fields = 3 * t.N * 3 * 8                      # u, u-, u+
    tabs = 8 * sum(getattr(t, k).size for k in ("c1", "c2", "c3", "c4",
                                                 "inv_mass", "mass_minusaM"))
    idx = 4 * (t.lnid.size + t.scat_perm.size + t.N)
    assert c.bytes == fields + tabs + idx
    assert c.flop > 2 * 48 * 24 * t.E and c.bound_ms > 0
    with pytest.raises(ValueError, match="elastic"):
        roofline.unstructured_cost(sims("bkt")[0].tables)
