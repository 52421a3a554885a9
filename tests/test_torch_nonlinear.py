"""Nonlinear soil on the CPU: the port's ``nonlinear.py``, the
unstructured solver's nonlinear branch (``solver/step.py``) and the mesh
route's subset pass (``solver/fused_mesh.py``, plain versions) against
the JAX package in float64, on the same in-repo inputs: fixture (a) with
a soft layer over the stiff halfspace (``NL_LAYERS`` at ``NL_FREQ``, two
bricks; the JAX package's own mixed-mesh case,
tests/test_pallas_mesh.py:371-445, built without reference data), a
nonlinear cut of 2000 m/s selecting the layer, with and without
geostatic loading.  Bounds: 1e-13 relative on the plastic update of
seeded inputs, 2e-13 of max on the unstructured route, 5e-12 of max on
the mesh route (JAX's test_mesh_pallas_nonlinear_matches_unstructured),
bit for bit on restart."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu import nonlinear as jnl
from hercules_tpu.sim import Simulation as JaxSimulation
from hercules_tpu.solver import bricks as jbricks
from hercules_tpu.solver import pallas_mesh as jpm
from hercules_tpu.solver import step as jstep
from hercules_tpu_torch import nonlinear as nl
from hercules_tpu_torch.convert import (mesh_state_to_global,
                                        nonlinear_state,
                                        unstructured_state_to_global)
from hercules_tpu_torch.fixtures import (NL_FREQ, NL_LAYERS,
                                         add_building_keys,
                                         add_nonlinear_keys, add_output_keys,
                                         one_torch_thread, write_box_case)
from hercules_tpu_torch.sim import SimOutputs, Simulation
from hercules_tpu_torch.solver import fused_mesh, step
from hercules_tpu_torch.solver.bricks import build_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 40
VS_CUT = 2000.0
# geostatic loading over 50 ms + 10 ms: 14 steps of 4.17 ms, so the
# bottom reactions are captured at step 14 and replayed after it
GEOSTATIC = dict(geostatic_s=0.05, cushion_s=0.01)

_one_torch_thread = one_torch_thread()


def _nl_case(root, steps=STEPS, geostatic=False, n_stations=5):
    paths = write_box_case(str(root), 62.5, steps, n_stations,
                           layers=NL_LAYERS, freq=NL_FREQ)
    add_nonlinear_keys(paths[2], VS_CUT, **(GEOSTATIC if geostatic else {}))
    return paths


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{geostatic: (port Simulation, JAX Simulation, seeded forces at a
    node of the layer)}: the same run directory set up by both."""
    made = {}
    for geo in (False, True):
        root = tmp_path_factory.mktemp(f"nl{int(geo)}")
        cv, ph, nu = _nl_case(root, geostatic=geo)
        sim = Simulation.setup(ph, nu, cvmdb=cv)
        jsim = JaxSimulation.setup(ph, nu, cvmdb=cv)
        t = sim.nl_tables
        assert 0 < t.n < sim.mesh.lenum
        nid = np.array([sim.mesh.elem_lnid[t.eidx[t.n // 2], 0]], np.int32)
        forces = np.random.default_rng(9).standard_normal(
            (STEPS, 1, 3)) * 1e9
        made[geo] = (sim, jsim, nid, forces)
    return made


def _close(got, want, bound, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert got.shape == want.shape and scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=bound * scale,
                               err_msg=what)


def _jax_run(sim, jsim, nid, forces):
    st = sim.stations
    jb = jstep.attach_nonlinear(jsim.mesh, jsim.params, jsim.tables,
                                jsim.nl_tables, dtype=jnp.float64)
    state, samp = jstep.run_solver(
        jsim.tables, nid, forces, STEPS, jsim.params.delta_t,
        st_nodes=st.nodes, st_phi=st.phi, dtype=jnp.float64, nl=jb)
    return ([np.asarray(x) for x in state[:2]],
            [np.asarray(a) for a in state[3]], np.asarray(samp))


# ---- the plastic update on seeded inputs --------------------------------

MODELS = [("linear", "rate_independant"), ("vonmises", "rate_independant"),
          ("vonmises", "rate_dependant"),
          ("druckerprager", "rate_independant"),
          ("druckerprager", "rate_dependant")]


@pytest.mark.parametrize("model,plasticity", MODELS)
def test_state_update_and_force_match_jax(model, plasticity):
    """nl_state_update and nl_force of both packages on seeded [E, 24]
    displacements large enough to yield most quadrature points, from a
    seeded plastic state, with seeded per-element constants."""
    rng = np.random.default_rng(20261017)
    E = 64
    mu = rng.uniform(1e8, 1e9, E)
    cols = dict(
        eidx=np.arange(E), mu=mu, lam=rng.uniform(1e8, 2e9, E),
        alpha=(np.zeros(E) if model != "druckerprager"
               else rng.uniform(0.05, 0.3, E)),
        k=rng.uniform(1e4, 1e5, E), hard=rng.uniform(0.0, 1e7, E),
        strainrate=rng.uniform(1e-4, 1e-2, E),
        sensitivity=rng.uniform(0.5, 2.0, E), h=rng.uniform(10.0, 70.0, E))
    state = (1e5 * rng.standard_normal((E, 8, 6)),
             1e-5 * rng.standard_normal((E, 8, 6)),
             1e-5 * rng.uniform(0, 1, (E, 8)))
    ue = 1e-2 * rng.standard_normal((E, 24))
    dt = 1e-3

    def tables(mod):
        cfg = mod.NonlinearConfig(material_model=model,
                                  plasticity_type=plasticity)
        return mod.nl_device_tables(mod.NLTables(cfg=cfg, **cols),
                                    torch.float64, "cpu") \
            if mod is nl else mod.nl_device_tables(
                mod.NLTables(cfg=cfg, **cols), jnp.float64)

    d, jd = tables(nl), tables(jnl)
    got = nl.nl_state_update(d, torch.tensor(ue),
                             tuple(map(torch.tensor, state)), dt)
    want = jnl.nl_state_update(jd, jnp.asarray(ue),
                               tuple(map(jnp.asarray, state)), dt)
    if model != "linear":
        assert (np.asarray(want[2]) > state[2]).mean() > 0.5   # yielded
    for name, a, b in zip(("stresses", "plastic strains", "ep"), got, want):
        _close(a.numpy(), b, 1e-13, name)
    _close(nl.nl_force(d, got, dt * dt).numpy(),
           jnl.nl_force(jd, want, dt * dt), 1e-13, "force")


# ---- the unstructured route ----------------------------------------------

@pytest.mark.parametrize("geostatic", [False, True])
def test_unstructured_nonlinear_matches_jax(cases, geostatic):
    """step.run_solver(nl=) against the JAX package's: u, u-, the
    plastic state and the samples within 2e-13 of their max."""
    sim, jsim, nid, forces = cases[geostatic]
    st = sim.stations
    bundle = step.attach_nonlinear(sim.mesh, sim.params, sim.tables,
                                   sim.nl_tables, device="cpu")
    state, samp = step.run_solver(
        sim.tables, nid, forces, STEPS, sim.params.delta_t,
        st_nodes=st.nodes, st_phi=st.phi, nl=bundle, device="cpu")
    fields, plastic, jsamp = _jax_run(sim, jsim, nid, forces)
    mine = unstructured_state_to_global(state)
    for name, a, b in zip(("u", "u-"), mine, fields):
        _close(a, b, 2e-13, name)
    assert len(plastic) == (4 if geostatic else 3)
    for i, (a, b) in enumerate(zip(nonlinear_state(state), plastic)):
        _close(a, b, 2e-13, f"plastic state {i}")
    assert plastic[2].max() > 0                     # plastic flow fired
    _close(samp, jsamp, 2e-13, "samples")


# ---- the mesh route ------------------------------------------------------

def _assert_plans_equal(mine, theirs):
    """attach_nonlinear_mesh's gather and scatter plans against the JAX
    package's: the same columns, entries and inv_mass, and each scatter
    summing its entries in the JAX package's order."""
    assert len(mine["gather"]) == len(theirs["gather"])
    for (b, loc, dst), (jb, jloc, jdst) in zip(mine["gather"],
                                               theirs["gather"]):
        jdst = np.asarray(jdst)
        assert b == jb and np.array_equal(loc.numpy(), np.asarray(jloc))
        assert np.array_equal(np.arange(len(jdst)) if dst is None
                              else dst.numpy(), jdst)
    for (b, dst, s, invm), (jb, perm, seg, nseg, uniq, jinvm) in zip(
            mine["scatter"], theirs["scatter"]):
        entries = (np.arange(len(np.asarray(perm))) if dst is None
                   else dst.numpy())
        order = entries if s.perm is None else entries[s.perm.numpy()]
        assert b == jb and np.array_equal(order, np.asarray(perm))
        assert np.array_equal(s.ids.numpy(), np.asarray(uniq))
        assert len(s.ids) == nseg
        assert np.array_equal(invm.numpy(), np.asarray(jinvm))


@pytest.mark.parametrize("geostatic", [False, True])
def test_mesh_nonlinear_plans_match_jax(cases, geostatic):
    sim, jsim, _, _ = cases[geostatic]
    plan = build_plan(sim.mesh)
    mine = fused_mesh.attach_nonlinear_mesh(
        sim.mesh, sim.params, sim.tables, sim.nl_tables, plan,
        torch.float64, "cpu")
    theirs = jpm.attach_nonlinear_mesh(
        jsim.mesh, jsim.params, jsim.tables, jsim.nl_tables,
        jbricks.build_plan(jsim.mesh), dtype=jnp.float64)
    assert np.array_equal(mine["cols"], theirs["cols"])
    _assert_plans_equal(mine, theirs)
    assert mine["geostatic"] == theirs["geostatic"] == geostatic
    if not geostatic:
        return
    assert mine["final_step"] == theirs["final_step"] == 14
    assert np.array_equal(mine["rise"].numpy(), np.asarray(theirs["rise"]))
    for b, row, jrow in zip(plan.bricks, mine["grav_nb"],
                            theirs["grav_nb"]):
        assert np.array_equal(row.numpy()[:b.nb], jrow)
        assert not row.numpy()[b.nb:].any()
    _assert_plans_equal(mine["bot"], theirs["bot"])
    assert [(a, c.numpy().tolist()) for a, c in mine["pin"]] == \
        [(a, np.asarray(c).tolist()) for a, c in theirs["pin"]]


@pytest.mark.parametrize("geostatic", [False, True])
def test_mesh_nonlinear_matches_jax_unstructured(cases, geostatic):
    """The mesh route (K1 per brick on the plain versions, the
    nonlinear elements masked; the subset pass before the plane
    reconciler) against the JAX package's unstructured solver: u and
    the plastic state within 5e-12 of their max."""
    sim, jsim, nid, forces = cases[geostatic]
    st = sim.stations
    plan = build_plan(sim.mesh)
    bundle = fused_mesh.attach_nonlinear_mesh(
        sim.mesh, sim.params, sim.tables, sim.nl_tables, plan,
        torch.float64, "cpu")
    mt = fused_mesh.MeshPallasTables(plan, sim.tables, dtype=torch.float64,
                                     device="cpu", nl=bundle)
    assert mt.reconciler == "plane" and len(plan.bricks) == 2
    # K1's table leaves the nonlinear elements out: c1, c2, beta = 0
    cols = bundle["cols"]
    for b, brick in enumerate(plan.bricks):
        c = cols[(cols >= brick.off) & (cols < brick.off + brick.nb)]
        assert not mt.steps[b].K[:3, c - brick.off].any()
        assert len(c) == (sim.nl_tables.n if b == 0 else 0)
    state, samp = fused_mesh.run_mesh_solver(
        plan, sim.tables, nid, forces, STEPS, sim.params.delta_t,
        st_nodes=st.nodes, st_phi=st.phi, dtype=torch.float64,
        device="cpu", nl=bundle, chunk=15)
    fields, plastic, jsamp = _jax_run(sim, jsim, nid, forces)
    _close(mesh_state_to_global(state[0], plan, sim.mesh.nnum), fields[0],
           5e-12, "u")
    for i, (a, b) in enumerate(zip(nonlinear_state(state), plastic)):
        _close(a, b, 5e-12, f"plastic state {i}")
    _close(samp, jsamp, 5e-12, "samples")


@pytest.mark.parametrize("route", ["unstructured", "mesh"])
def test_jax_state_resumes(cases, route):
    """The JAX package's unstructured carry after 20 steps of the
    geostatic case (the reactions captured at step 14 in it), carried
    to the port (convert) and run 20 more steps on either route, against
    the JAX package's 40-step run."""
    from hercules_tpu_torch.convert import (mesh_state_from_jax,
                                            unstructured_state_from_jax)
    sim, jsim, nid, forces = cases[True]
    jb = jstep.attach_nonlinear(jsim.mesh, jsim.params, jsim.tables,
                                jsim.nl_tables, dtype=jnp.float64)
    args = (jsim.tables, nid, forces)
    half, _ = jstep.run_solver(*args, STEPS // 2, jsim.params.delta_t,
                               dtype=jnp.float64, nl=jb)
    full, _ = jstep.run_solver(*args, STEPS, jsim.params.delta_t,
                               dtype=jnp.float64, nl=jb)
    carry = unstructured_state_from_jax(half)
    assert np.abs(carry[3][3]).max() > 0
    kw = dict(start_step=STEPS // 2, device="cpu")
    if route == "unstructured":
        state, _ = step.run_solver(
            sim.tables, nid, forces, STEPS, sim.params.delta_t,
            state=carry, nl=step.attach_nonlinear(
                sim.mesh, sim.params, sim.tables, sim.nl_tables,
                device="cpu"), **kw)
        u, bound = state[0].numpy(), 2e-13
    else:
        plan = build_plan(sim.mesh)
        state, _ = fused_mesh.run_mesh_solver(
            plan, sim.tables, nid, forces, STEPS, sim.params.delta_t,
            dtype=torch.float64, state=mesh_state_from_jax(
                carry[:2], plan, plastic=carry[3]),
            nl=fused_mesh.attach_nonlinear_mesh(
                sim.mesh, sim.params, sim.tables, sim.nl_tables, plan,
                torch.float64, "cpu"), **kw)
        u, bound = mesh_state_to_global(state[0], plan, sim.mesh.nnum), 5e-12
    _close(u, full[0], bound, "u")
    for i, (a, b) in enumerate(zip(nonlinear_state(state), full[3])):
        _close(a, b, bound, f"plastic state {i}")


# ---- routing -------------------------------------------------------------

def test_routes_and_reasons(tmp_path):
    """Simulation.run's rules: the two-brick case takes the mesh route;
    BKT with nonlinear soil, and nonlinear elements in the loose section
    (the carved building: the foundation, Vs 1000 m/s, is loose), take
    the unstructured solver with the reason; solver="pallas" raises
    there; the index epilogue refuses the subset pass."""
    cv, ph, nu = _nl_case(tmp_path / "ok", steps=2)
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    assert sim.route("auto")[::2] == ("mesh", "")
    plan = build_plan(sim.mesh)
    bundle = fused_mesh.attach_nonlinear_mesh(
        sim.mesh, sim.params, sim.tables, sim.nl_tables, plan,
        torch.float64, "cpu")
    with pytest.raises(ValueError, match="plane reconciler"):
        fused_mesh.MeshPallasTables(plan, sim.tables, device="cpu",
                                    reconciler="index", nl=bundle)

    cv, ph, nu = write_box_case(str(tmp_path / "bkt"), 62.5, 2, 0,
                                damping="bkt")
    add_nonlinear_keys(nu, 4000.0)
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    route, _, reason = sim.route("auto")
    assert route == "unstructured" and "BKT" in reason
    sim.run(device="cpu")
    assert sim.solver_path_name == "unstructured"
    with pytest.raises(RuntimeError, match="BKT"):
        sim.route("pallas")

    root = tmp_path / "bldg"
    cv, ph, nu = write_box_case(str(root), 62.5, 2, 0, dt=1e-3)
    add_building_keys(str(root), nu)
    add_nonlinear_keys(nu, 1000.0, geostatic_s=0.05)
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    assert sim.route("auto")[2] == "nonlinear soil: geostatic loading " \
                                   "with loose elements"
    sim.nl_tables.cfg.geostatic_loading_t = 0.0
    assert sim.route("auto")[2] == "nonlinear soil: a nonlinear element " \
                                   "in the loose section"


# ---- the CLI and restart -------------------------------------------------

def test_cli_station_files_match_jax(tmp_path):
    """Both CLIs on the nonlinear case (the port's mesh route on the
    CPU, the JAX package's unstructured solver): station files with the
    17 nonlinear columns, equal to their printed precision."""
    env = dict(os.environ, PYTHONPATH=ROOT, HT_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    procs = []
    for name, cmd in (
            ("port", [sys.executable, "-m", "hercules_tpu_torch.cli",
                      "--device=cpu"]),
            ("jax", [sys.executable, "-m", "hercules_tpu.cli",
                     "--ndev=1"])):
        d = tmp_path / name
        paths = _nl_case(d, steps=60, n_stations=2)
        with open(paths[1]) as f:
            text = f.read()
        # a source strong enough to yield the layer
        src = os.path.join(d, "in", "src", "source.in")
        with open(src) as f:
            s = f.read().replace("moment_magnitude     = 4.0",
                                 "moment_magnitude     = 6.0")
        with open(src, "w") as f:
            f.write(s)
        assert "type_of_damping" in text
        procs.append((d, subprocess.Popen(
            cmd + list(paths), cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for d, p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    (port_dir, _), (jax_dir, _) = procs
    assert "solver path: torch_plain" in \
        (port_dir / "monitor.txt").read_text()
    yielded = False
    for i in range(2):
        files = [d / "stations" / f"station.{i}" for d in (port_dir,
                                                           jax_dir)]
        heads = [f.read_text().splitlines()[0] for f in files]
        assert heads[0] == heads[1] and heads[0].endswith("kh(Pa)")
        a, b = (np.loadtxt(f, skiprows=1) for f in files)
        assert a.shape == b.shape == (60, 4 + 17)
        scale = np.abs(b[:, 1:]).max(axis=0)
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-12 * scale.max())
        yielded = yielded or (b[:, 4 + 14] > 0).any()
    assert yielded


def _resume_pair(root, solver):
    """A 40-step run with a checkpoint at step 20, then the run resumed
    from that checkpoint: (the straight run's state and samples, the
    resumed run's)."""
    cv, ph, nu = _nl_case(root, geostatic=True, n_stations=2)
    add_output_keys(ph, nu, checkpointing_rate=20)
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    rundir = str(root)
    full = sim.run(device="cpu", solver=solver, rundir=rundir,
                   outputs=SimOutputs(sim.mesh, sim.params, rundir))
    ck = os.path.join(rundir, "checkpoints")
    picked = [f for f in os.listdir(ck)
              if np.load(os.path.join(ck, f))["step"] == 20]
    assert len(picked) == 1
    shutil.copy(os.path.join(ck, picked[0]),
                os.path.join(ck, "checkpoint.in"))
    again = sim.run(device="cpu", solver=solver, rundir=rundir)
    assert sim.start_step == 20
    return sim, full, again


@pytest.mark.parametrize("solver", ["auto", "unstructured"])
def test_restart_is_bit_exact(tmp_path, solver):
    """Geostatic nonlinear run (the reactions captured at step 14 ride
    the checkpoint) resumed from its step-20 checkpoint: the final
    fields, the plastic state and the samples of steps 20-39 bit for bit,
    on the mesh route (torch_plain) and the unstructured route."""
    sim, (s1, smp1), (s2, smp2) = _resume_pair(tmp_path, solver)
    assert sim.solver_path_name == {"auto": "torch_plain"}.get(
        solver, solver)
    assert np.array_equal(smp2, smp1[20:])
    a, b = nonlinear_state(s1), nonlinear_state(s2)
    assert len(a) == 4 and np.abs(a[3]).max() > 0
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    if solver == "auto":
        s1, s2 = s1[0], s2[0]
    for x, y in zip(s1[:2], s2[:2]):
        assert np.array_equal(torch.as_tensor(x).numpy(),
                              torch.as_tensor(y).numpy())


def test_jax_checkpoint_resumes(tmp_path):
    """A checkpoint the JAX package wrote at step 20 of the geostatic
    case resumes on both of the port's routes: the final u within
    2e-13 (unstructured) and 5e-12 (mesh route) of the JAX package's
    straight run."""
    cv, ph, nu = _nl_case(tmp_path, geostatic=True, n_stations=2)
    add_output_keys(ph, nu, checkpointing_rate=20)
    rundir = str(tmp_path)
    from hercules_tpu.sim import SimOutputs as JaxOutputs
    jsim = JaxSimulation.setup(ph, nu, cvmdb=cv)
    jstate, _ = jsim.run(dtype=jnp.float64, rundir=rundir, ndev=1,
                         outputs=JaxOutputs(jsim.mesh, jsim.params, rundir))
    assert jsim.solver_path_name == "unstructured"
    want = np.asarray(jstate[0])
    ck = os.path.join(rundir, "checkpoints")
    picked = [f for f in os.listdir(ck)
              if np.load(os.path.join(ck, f))["step"] == 20]
    shutil.copy(os.path.join(ck, picked[0]),
                os.path.join(ck, "checkpoint.in"))
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    for solver, bound in (("unstructured", 2e-13), ("auto", 5e-12)):
        state, _ = sim.run(device="cpu", solver=solver, rundir=rundir)
        assert sim.start_step == 20
        u = (state[0].numpy() if solver == "unstructured" else
             mesh_state_to_global(state[0], build_plan(sim.mesh),
                                  sim.mesh.nnum))
        _close(u, want, bound, solver)
