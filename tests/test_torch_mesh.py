"""The graded multi-brick path on the CPU: the port's plain brick solver
(``solver/brickstep.py``) and its mesh route (``solver/fused_mesh.py``
on the kernels' plain versions, with ``solver/planerec.py``) against the
JAX package's brick solver, in float64, on the graded fixtures
(``hercules_tpu_torch/fixtures.py``) and the TeraShake copy; numpy
inputs made from a seed go to both packages."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.solver import brickstep as jbs
from hercules_tpu.solver.assemble import assemble as jax_assemble
from hercules_tpu.solver.bricks import build_plan as jax_build_plan
from hercules_tpu.solver.pallas_mesh import (
    interface_epilogue_consts as jax_epilogue_consts)
from hercules_tpu.solver.planerec import \
    PlaneReconciler as JaxPlaneReconciler
from hercules_tpu_torch.convert import (mesh_state_from_jax,
                                        mesh_state_to_global,
                                        tables_from_jax)
from hercules_tpu_torch.fixtures import (GRADED_LAYERS, GRADED_Q_LAYERS,
                                         GRADED_THIN_LAYERS, four_q_freq,
                                         one_torch_thread, terashake_case,
                                         write_box_case)
from hercules_tpu_torch.sim import Simulation
from hercules_tpu_torch.solver import bricks as port_bricks
from hercules_tpu_torch.solver import brickstep, fused_mesh
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.planerec import PlaneReconciler

STEPS = 40
F64 = torch.float64
# (layers, edge) of the graded box cases; "tera" is the TeraShake copy
CASES = {"graded62": (GRADED_LAYERS, 62.5),
         "graded15": (GRADED_LAYERS, 15.625),
         "q7": (GRADED_Q_LAYERS, 7.8125),
         "thin15": (GRADED_THIN_LAYERS, 15.625)}


_one_torch_thread = one_torch_thread()


class _Cases:
    """Simulations and JAX references, each made once per module."""

    def __init__(self, root):
        self.root = root
        self.sims = {}
        self.refs = {}

    def sim(self, name, damping="rayleigh"):
        key = (name, damping)
        if key not in self.sims:
            d = str(self.root / f"{name}_{damping}")
            if name == "tera":
                cv, ph, nu = terashake_case(d)
            else:
                layers, edge = CASES[name]
                cv, ph, nu = write_box_case(d, edge, STEPS, 5,
                                            damping=damping, layers=layers,
                                            freq=four_q_freq(edge))
            sim = Simulation.setup(ph, nu, cvmdb=cv)
            self.sims[key] = (sim, build_plan(sim.mesh))
        return self.sims[key]

    def stations(self, name, damping="rayleigh"):
        """(st_nodes, st_phi): the case's stations, or for the TeraShake
        copy (which has none) three elements' corners."""
        sim, _ = self.sim(name, damping)
        if sim.stations is not None:
            return sim.stations.nodes, sim.stations.phi
        m = sim.mesh
        return (m.elem_lnid[[4, m.lenum // 2, m.lenum - 3]],
                np.full((3, 8), 0.125))

    def jax_ref(self, name, damping="rayleigh"):
        """JAX run_brick_solver, float64, STEPS steps: (global u,
        samples)."""
        key = (name, damping)
        if key not in self.refs:
            sim, plan = self.sim(name, damping)
            st_nodes, st_phi = self.stations(name, damping)
            state, samp = jbs.run_brick_solver(
                plan, sim.tables, sim.src_ids, sim.src_forces, STEPS,
                sim.params.delta_t, st_nodes=st_nodes, st_phi=st_phi,
                dtype=jnp.float64)
            self.refs[key] = (jbs.brick_u_global(plan, state[0],
                                                 sim.mesh.nnum),
                              np.asarray(samp))
        return self.refs[key]

    def mesh_run(self, name, damping="rayleigh", **kw):
        """The port's mesh route on the CPU, float64, STEPS steps:
        (tables, global u, samples)."""
        sim, plan = self.sim(name, damping)
        st_nodes, st_phi = self.stations(name, damping)
        mt = fused_mesh.MeshPallasTables(
            plan, sim.tables, sim.src_ids, st_nodes, st_phi, F64, "cpu",
            **kw)
        (Ss, _, _), samp = fused_mesh.run_mesh(
            mt, sim.src_forces, STEPS, sim.params.delta_t, chunk=15)
        return mt, fused_mesh.mesh_u_global(plan, Ss, sim.mesh.nnum), samp


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return _Cases(tmp_path_factory.mktemp("mesh"))


def _close(u, samp, u_ref, samp_ref, bound):
    scale = np.abs(u_ref).max()
    sscale = np.abs(samp_ref).max()
    assert scale > 0 and sscale > 0
    assert samp.shape == samp_ref.shape
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=bound * scale)
    np.testing.assert_allclose(samp, samp_ref, rtol=0, atol=bound * sscale)


@pytest.mark.parametrize("name,damping,nb,loose", [
    ("graded62", "rayleigh", 3, 0), ("graded62", "bkt", 3, 0),
    ("graded15", "rayleigh", 2, 1024), ("graded15", "bkt", 2, 1024)])
def test_brick_solver_matches_jax(cases, name, damping, nb, loose):
    """The port's run_brick_solver against the JAX package's, float64,
    40 steps, within 2e-13 of max|u| and of the largest sample (the
    same algebra)."""
    sim, plan = cases.sim(name, damping)
    assert (len(plan.bricks), len(plan.loose_eidx)) == (nb, loose)
    st_nodes, st_phi = cases.stations(name, damping)
    (u, _, conv), samp = brickstep.run_brick_solver(
        plan, sim.tables, sim.src_ids, sim.src_forces, STEPS,
        sim.params.delta_t, st_nodes=st_nodes, st_phi=st_phi, dtype=F64,
        device="cpu", chunk=15)
    assert len(conv) == (nb + bool(loose) if damping == "bkt" else 0)
    u_ref, samp_ref = cases.jax_ref(name, damping)
    _close(brickstep.brick_u_global(plan, u, sim.mesh.nnum), samp, u_ref,
           samp_ref, 2e-13)


@pytest.mark.parametrize("name,damping,tiers,reconciler", [
    ("graded62", "rayleigh", ("elastic",) * 3, "plane"),
    ("graded62", "bkt", ("uniform",) * 3, "plane"),
    ("graded62", "mass", ("elastic",) * 3, "plane"),
    ("graded62", "none", ("elastic",) * 3, "plane"),
    ("graded15", "rayleigh", ("elastic",) * 2, "index"),
    ("graded15", "bkt", ("uniform",) * 2, "index"),
    ("q7", "bkt", ("uniform", "uniform", "node"), "plane"),
    ("thin15", "bkt", ("uniform", "corner"), "index"),
    ("tera", "rayleigh", ("elastic",), "index")])
def test_mesh_route_matches_jax(cases, name, damping, tiers, reconciler):
    """The mesh route on the plain versions (route torch_plain) against
    the JAX package's run_brick_solver, float64, 40 steps, within
    5e-12 of max|u| and of the largest sample (the JAX package's bound
    for its mesh route, tests/test_pallas_mesh.py:75-80).  Each brick's
    BKT tier is the single-brick rule's: the node tier (K3) on the fine
    brick of GRADED_Q_LAYERS at 7.8125 m, the corner tier (K4) on that
    of GRADED_THIN_LAYERS at 15.625 m."""
    mt, u, samp = cases.mesh_run(name, damping)
    assert tuple(mt.tiers) == tiers
    assert mt.reconciler == reconciler
    assert fused_mesh.route_name(mt) == "torch_plain"
    u_ref, samp_ref = cases.jax_ref(name, damping)
    _close(u, samp, u_ref, samp_ref, 5e-12)


@pytest.mark.parametrize("damping", ["rayleigh", "bkt"])
def test_plane_reconciler_matches_index_epilogue(cases, damping):
    """On the 3-brick plan the plane reconciler and the forced index
    epilogue give the same run, within 5e-12."""
    mt, u, samp = cases.mesh_run("graded62", damping)
    mti, ui, sampi = cases.mesh_run("graded62", damping,
                                    reconciler="index")
    assert (mt.reconciler, mti.reconciler) == ("plane", "index")
    _close(u, samp, ui, sampi, 5e-12)


@pytest.mark.parametrize("name,damping", [("graded62", "rayleigh"),
                                          ("graded62", "bkt"),
                                          ("graded15", "rayleigh")])
def test_source_on_shared_node(cases, name, damping):
    """One source on a dangling node's anchor (a node of the interface
    plane, with a copy in each brick) and one off the interface,
    random forces: the mesh route adds each once and matches the JAX
    brick solver; on the 3-brick plan the plane reconciler (which adds
    the shared one) and the index epilogue agree
    (tests/test_pallas_mesh.py:test_plane_reconciler_depth_graded)."""
    sim, plan = cases.sim(name, damping)
    mesh = sim.mesh
    rng = np.random.default_rng(5)
    anchor = int(mesh.dn_anchors[mesh.dn_weights > 0][0])
    nid = np.array([mesh.elem_lnid[mesh.lenum // 3, 0], anchor], np.int32)
    assert np.isin(anchor, plan.grp_node)
    assert not np.isin(nid[0], plan.grp_node)
    forces = rng.standard_normal((STEPS, 2, 3)) * 1e8
    st_nodes, st_phi = cases.stations(name, damping)
    run = dict(st_nodes=st_nodes, st_phi=st_phi)
    state, samp_ref = jbs.run_brick_solver(
        plan, sim.tables, nid, forces, STEPS, sim.params.delta_t,
        dtype=jnp.float64, **run)
    u_ref = jbs.brick_u_global(plan, state[0], mesh.nnum)
    for rec in ("plane", "index") if name == "graded62" else ("index",):
        (Ss, _, _), samp = fused_mesh.run_mesh_solver(
            plan, sim.tables, nid, forces, STEPS, sim.params.delta_t,
            dtype=F64, device="cpu", reconciler=rec, **run)
        _close(fused_mesh.mesh_u_global(plan, Ss, mesh.nnum), samp, u_ref,
               np.asarray(samp_ref), 5e-12)


def _reordered(monkeypatch):
    """Shrink both packages' tile so the 62.5 m plan takes the reordered
    storage axes (1, 2, 0) of the 3.90625 m plan: y outermost, z in the
    middle, x inner."""
    monkeypatch.setenv("HT_PALLAS_TILE", "256")
    monkeypatch.setattr(port_bricks, "JAX_DEFAULT_TILE", 256)


@pytest.mark.parametrize("damping", ["rayleigh", "bkt"])
def test_reordered_axes_mesh_matches_jax(cases, monkeypatch, damping):
    """The 62.5 m plan with the reordered storage axes: the planes of
    the reconciler sit in the middle axis; the mesh route matches the
    JAX brick solver on the same (reordered) plan within 5e-12."""
    _reordered(monkeypatch)
    sim, _ = cases.sim("graded62", damping)
    plan = build_plan(sim.mesh)
    assert all(b.axes == (1, 2, 0) for b in plan.bricks)
    st_nodes, st_phi = cases.stations("graded62", damping)
    run = dict(st_nodes=st_nodes, st_phi=st_phi)
    args = (plan, sim.tables, sim.src_ids, sim.src_forces, STEPS,
            sim.params.delta_t)
    mt = fused_mesh.MeshPallasTables(plan, sim.tables, dtype=F64,
                                     device="cpu")
    assert mt.reconciler == "plane"
    assert {h.zpos_f for h in mt.plane_rec.hang} == {1}
    (Ss, _, _), samp = fused_mesh.run_mesh_solver(*args, dtype=F64,
                                                  device="cpu", **run)
    state, samp_ref = jbs.run_brick_solver(*args, dtype=jnp.float64, **run)
    _close(fused_mesh.mesh_u_global(plan, Ss, sim.mesh.nnum), samp,
           jbs.brick_u_global(plan, state[0], sim.mesh.nnum),
           np.asarray(samp_ref), 5e-12)


def _assert_same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k}]")
    else:
        assert a == b, where


def _plans_equal(mine, ref):
    assert len(mine.bricks) == len(ref.bricks)
    for bm, br in zip(mine.bricks, ref.bricks):
        for name in ("level", "origin", "shape", "off", "nb", "gnid",
                     "eidx", "axes"):
            assert np.array_equal(np.asarray(getattr(bm, name)),
                                  np.asarray(getattr(br, name))), name
        assert bm.corner_offsets() == br.corner_offsets()
    for f in dataclasses.fields(ref):
        if f.name not in ("bricks", "mesh"):
            assert np.array_equal(getattr(mine, f.name),
                                  getattr(ref, f.name)), f.name


@pytest.mark.parametrize("name,reorder", [("graded62", False),
                                          ("graded62", True),
                                          ("graded15", False),
                                          ("q7", False), ("tera", False)])
def test_build_plan_matches_jax_graded(cases, monkeypatch, name, reorder):
    """tests/test_torch_tables.py:test_build_plan_matches_jax on the
    graded plans (and the 62.5 m plan with reordered axes): the port's
    tables and brick plan equal the JAX package's."""
    if reorder:
        _reordered(monkeypatch)
    sim, _ = cases.sim(name)
    ref = jax_assemble(sim.mesh, sim.params)
    for f in dataclasses.fields(ref):
        _assert_same(getattr(sim.tables, f.name), getattr(ref, f.name),
                     f.name)
    _plans_equal(build_plan(sim.mesh), jax_build_plan(sim.mesh))


@pytest.mark.parametrize("name,reorder", [("graded62", False),
                                          ("graded62", True),
                                          ("q7", False)])
def test_plane_reconciler_tables_match_jax(cases, monkeypatch, name,
                                           reorder):
    """PlaneReconciler.build (the port's copy) gives the JAX package's
    interfaces and tables, with a source on an interface node; and the
    index epilogue's constants equal the JAX package's."""
    if reorder:
        _reordered(monkeypatch)
    sim, _ = cases.sim(name)
    plan = build_plan(sim.mesh)
    anchor = int(sim.mesh.dn_anchors[sim.mesh.dn_weights > 0][0])
    src = np.concatenate([sim.src_ids, [anchor]]).astype(np.int32)
    mine = PlaneReconciler.build(plan, sim.tables, src, dtype=F64)
    ref = JaxPlaneReconciler.build(plan, sim.tables, src,
                                   dtype=jnp.float64)
    assert mine is not None and ref is not None
    assert len(mine.hang) == len(ref.hang) and len(mine.same) == len(
        ref.same)
    assert sum(len(h.src) for h in mine.hang + mine.same) >= 1
    for a, b in zip(mine.hang + mine.same, ref.hang + ref.same):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert np.array_equal(x.numpy(), np.asarray(y)), f.name
            else:
                assert x == y, f.name
    ep = fused_mesh.interface_epilogue_consts(plan, sim.tables, src, F64,
                                              "cpu")
    jep = jax_epilogue_consts(plan, sim.tables, src, jnp.float64)
    for k in ("ex_arr", "ex_loc", "ex_seg", "grp_first", "mass_ex",
              "invm_ex", "mm_ex", "dn_grp", "dn_anc_grp", "dn_wgt",
              "dnc_k", "dnc_src", "src_grp_idx", "src_grp_rows"):
        assert np.array_equal(np.asarray(ep[k]), np.asarray(jep[k])), k
    assert [(a, p.tolist(), r.tolist()) for a, p, r, _ in ep["src_direct"]] \
        == [(a, np.asarray(p).tolist(), np.asarray(r).tolist())
            for a, p, r, _ in jep["src_direct"]]


# slow and fast layers in turns: the mesh refines again under each fast
# layer, so the 62.5 m plan has 8 bricks of 75 nodes and 896 loose
# elements
ALTERNATING_LAYERS = ((0.0, 1200.0, 600.0, 2000.0),
                      (125.0, 5000.0, 2900.0, 2600.0),
                      (250.0, 1200.0, 600.0, 2000.0),
                      (375.0, 5000.0, 2900.0, 2600.0))


@pytest.mark.parametrize("damping", ["rayleigh", "bkt"])
def test_many_bricks_take_the_mesh_route(tmp_path, damping):
    """Simulation.run sends a plan of many bricks (8, and 896 loose
    elements) to the mesh route, whatever its brick count (route
    torch_plain on the CPU), and that route matches the port's plain
    brick solver on it within 5e-12 of max|u| and of the largest
    sample."""
    cv, ph, nu = write_box_case(str(tmp_path), 62.5, STEPS, 5,
                                damping=damping, layers=ALTERNATING_LAYERS,
                                freq=four_q_freq(62.5))
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    plan = build_plan(sim.mesh)
    assert (len(plan.bricks), len(plan.loose_eidx)) == (8, 896)
    (Ss, _, _), samp = sim.run(device="cpu")
    assert sim.solver_path_name == "torch_plain"
    assert Ss[0].device.type == "cpu" and Ss[0].dtype == F64
    st = sim.stations
    (u, _, _), samp_b = brickstep.run_brick_solver(
        plan, sim.tables, sim.src_ids, sim.src_forces, STEPS,
        sim.params.delta_t, st_nodes=st.nodes, st_phi=st.phi, dtype=F64,
        device="cpu")
    N = sim.mesh.nnum
    _close(fused_mesh.mesh_u_global(plan, Ss, N), samp,
           brickstep.brick_u_global(plan, u, N), samp_b, 5e-12)


def test_mesh_state_round_trip(cases):
    """mesh_state_from_jax carries a global pair, a JAX packed carry and
    a legacy carry into the port's per-brick layout, and
    mesh_state_to_global back; a state so carried starts the port's mesh
    route and the JAX brick solver alike (elastic, 10 steps, 5e-12)."""
    sim, plan = cases.sim("graded15")
    N = sim.mesh.nnum
    rng = np.random.default_rng(3)
    u = 1e-3 * rng.standard_normal((N, 3))
    up = u - 1e-5 * rng.standard_normal((N, 3))
    Ss, convs, lconv = mesh_state_from_jax((u, up), plan)
    assert len(Ss) == len(plan.bricks) + 1 and convs == lconv == ()
    assert np.array_equal(mesh_state_to_global(Ss, plan, N), u)
    for S, b in zip(Ss, plan.bricks):
        assert not S[:, b.nb:].any() and not S[6:].any()
    # the same state as a JAX packed carry (padded to other lengths) and
    # as a legacy (us, ups, conv) carry
    packed = tuple(np.pad(S, ((0, 0), (0, 37))) for S in Ss[:-1]) \
        + (Ss[-1],)
    legacy = (tuple(S[0:3] for S in packed), tuple(S[3:6] for S in packed),
              ())
    for carry in ((packed,), legacy):
        again = mesh_state_from_jax(carry, plan)[0]
        assert all(np.array_equal(a, b) for a, b in zip(again, Ss))
    T = 10
    (Sm, _, _), _ = fused_mesh.run_mesh_solver(
        plan, sim.tables, sim.src_ids, sim.src_forces, T,
        sim.params.delta_t, dtype=F64, device="cpu",
        state=(Ss, (), ()))
    jstate = (jnp.asarray(u[plan.gnid_cat].T), jnp.asarray(up[plan.gnid_cat].T),
              ())
    state, _ = jbs.run_brick_solver(plan, sim.tables, sim.src_ids,
                                    sim.src_forces, T, sim.params.delta_t,
                                    dtype=jnp.float64, state=jstate)
    u_ref = jbs.brick_u_global(plan, state[0], N)
    np.testing.assert_allclose(fused_mesh.mesh_u_global(plan, Sm, N), u_ref,
                               rtol=0, atol=5e-12 * np.abs(u_ref).max())


def test_tables_from_jax_per_brick(cases):
    """tables_from_jax's per-brick form: the JAX package's tables give
    each brick's K as the mesh route builds it from the port's."""
    sim, plan = cases.sim("q7", "bkt")
    jtab = jax_assemble(sim.mesh, sim.params)
    mt = fused_mesh.MeshPallasTables(plan, sim.tables, dtype=F64,
                                     device="cpu")
    for b in range(len(plan.bricks)):
        K = tables_from_jax(jtab, plan, dtype=F64, device="cpu", brick=b)
        assert torch.equal(K, mt.steps[b].K)


def test_cli_graded_station_files_match_jax(tmp_path):
    """The port's CLI on the CPU (the mesh route on the plain versions)
    and the JAX CLI (its brick solver on the CPU) on GRADED_LAYERS at
    62.5 m: station files equal to their printed precision."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, HT_PLATFORM="cpu")
    procs = []
    for name, cmd in (
            ("port", [sys.executable, "-m", "hercules_tpu_torch.cli",
                      "--device=cpu"]),
            ("jax", [sys.executable, "-m", "hercules_tpu.cli",
                     "--ndev=1"])):
        d = tmp_path / name
        paths = write_box_case(str(d), 62.5, 100, 2, layers=GRADED_LAYERS,
                               freq=four_q_freq(62.5))
        procs.append((d, subprocess.Popen(
            cmd + list(paths), cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for d, p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out[-3000:]
    (port_dir, _), (jax_dir, _) = procs
    assert "solver path: torch_plain" in \
        (port_dir / "monitor.txt").read_text()
    assert "solver path: bricks" in (jax_dir / "monitor.txt").read_text()
    for i in range(2):
        a, b = (np.loadtxt(d / "stations" / f"station.{i}", skiprows=1)
                for d in (port_dir, jax_dir))
        assert a.shape == b.shape == (100, 4)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        scale = np.abs(b[:, 1:]).max()
        assert scale > 0
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=1e-6,
                                   atol=1e-12 * scale)
