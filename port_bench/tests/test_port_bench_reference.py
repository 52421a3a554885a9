"""The plain reference against the port's plain CPU route, on small
meshes of both configurations: the mesh, the tables, the source and the
receivers, and whole runs of the harness that come out correct."""

import json
import os
import tempfile

import numpy as np
import pytest

from port_bench import cell as C
from port_bench import check
from port_bench.reference import fem


def _cfg(name, fmax):
    cfg = C.load_json(os.path.join(C.HERE, "configs", name + ".json"))
    cfg["fmax_hz"] = fmax
    return cfg


def test_unit_stiffness_is_the_ports_operators():
    """h (mu Kmu + lambda Klam) is the element stiffness the port's
    c1 M1 + c2 M2 applies (c = dt^2 h {mu, lambda} / 9)."""
    from hercules_tpu_torch.physics.kmats import stiffness_matrices_24
    M1, M2 = stiffness_matrices_24()
    Kmu, Klam = fem.unit_stiffness()
    np.testing.assert_allclose(Kmu * 9, M1, atol=1e-12)
    np.testing.assert_allclose(Klam * 9, M2, atol=1e-12)
    # rigid motions and rotations have no force
    rigid = np.zeros((24, 6))
    xyz = fem.CORNER_BITS.astype(float)
    for c in range(3):
        rigid[c::3, c] = 1.0
    rigid[0::3, 3], rigid[1::3, 3] = -xyz[:, 1], xyz[:, 0]
    for K in (Kmu, Klam):
        np.testing.assert_allclose(K @ rigid[:, :4], 0, atol=1e-12)


@pytest.mark.parametrize("name,fmax", [("b1_1hz", 0.125),
                                       ("loh1_4hz", 1.0)])
def test_mesh_tables_source_receivers(name, fmax):
    from hercules_tpu_torch.sim import Simulation
    cfg = _cfg(name, fmax)
    rows = fem.element_rows(cfg)
    src = C.draw_source(cfg, 2 ** 31 + 5, rows)
    recv = C.receivers(cfg)
    with tempfile.TemporaryDirectory() as w:
        sim = Simulation.setup(*C.write_inputs(w, cfg, src, recv, 300)[1:],
                               cvmdb=os.path.join(w, "medium.e"))
    mesh = fem.build_mesh(cfg)
    assert (sim.mesh.lenum, sim.mesh.nnum, len(sim.mesh.dn_ids)) == \
        (mesh.E, mesh.N, len(mesh.dn_ids))
    pm = check.node_map(sim.mesh, mesh)
    assert len(np.unique(pm)) == mesh.N
    mass, damped = fem.node_tables(cfg, mesh)
    np.testing.assert_allclose(1 / sim.tables.inv_mass, mass[pm],
                               rtol=1e-12)
    np.testing.assert_allclose(sim.tables.mass_minusaM, damped[pm],
                               rtol=1e-12, atol=1e-9 * damped.max())
    sn, sw = fem.source_weights(mesh, src)
    assert sorted(pm[sim.src_ids]) == sorted(sn)
    d = fem.time_function(cfg, 300)
    o = np.argsort(pm[sim.src_ids])
    np.testing.assert_allclose(
        sim.src_forces[:, o], d[:, None, None] * sw[np.argsort(sn)][None],
        rtol=0, atol=1e-12 * np.abs(sw).max())
    e, loc = fem.locate(mesh, recv)
    np.testing.assert_allclose(sim.stations.phi, fem.shape_values(loc),
                               atol=1e-12)
    assert (pm[sim.stations.nodes] == mesh.lnid[e]).all()
    if name == "loh1_4hz":
        assert len(mesh.dn_ids) > 0


@pytest.mark.parametrize("name,fmax", [("b1_1hz", 0.125),
                                       ("b1_1hz_f64", 0.125),
                                       ("loh1_4hz", 1.0)])
def test_harness_run_is_correct(tiny, name, fmax):
    result, lines = tiny(name, fmax, 2 ** 31 + 77)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    for n in ("first_chunk", "window_chunk", "window_field"):
        assert result["checks"][n]["value"] < 1e-4


def test_held_forces_continue_the_job():
    f = np.arange(5 * 2 * 3, dtype=np.float64).reshape(5, 2, 3)
    h = C.HeldForces(f)
    np.testing.assert_array_equal(h[1:4], f[1:4])
    got = h[3:8]
    np.testing.assert_array_equal(got[:2], f[3:5])
    np.testing.assert_array_equal(got[2:], np.broadcast_to(f[4], (3, 2, 3)))
    np.testing.assert_array_equal(h[6:9], np.broadcast_to(f[4], (3, 2, 3)))


def test_same_seed_same_inputs():
    cfg = _cfg("loh1_4hz", 1.0)
    rows = fem.element_rows(cfg)
    a = C.draw_source(cfg, 2 ** 33 + 1, rows)
    b = C.draw_source(cfg, 2 ** 33 + 1, rows)
    c = C.draw_source(cfg, 2 ** 33 + 2, rows)
    assert a == b and a != c
    assert json.dumps(a)


@pytest.mark.parametrize("name,fmax", [("b1_1hz", 0.25), ("loh1_4hz", 1.0)])
def test_legs_in_turns_are_the_runs_alone(name, fmax):
    """Two legs stepped in turns (``run_legs``, the check's set-up chunk
    and window chunk), one of them on a copy of the solver
    (``Solver.on``, a second card in a run that has one), give the bits
    of each leg run alone."""
    import torch
    cfg = _cfg(name, fmax)
    rows = fem.element_rows(cfg)
    mesh = fem.build_mesh(cfg)
    ref = fem.Solver(cfg, mesh, C.draw_source(cfg, 3, rows),
                     C.receivers(cfg), 50, torch.float64, "cpu")
    u, up, ys = ref.run(*ref.zeros(), 0, 40)
    other = ref.on("cpu")
    assert other is not ref and other.device == torch.device("cpu")
    legs = fem.run_legs([(ref, *ref.zeros(), 0, 40),
                         (other, u, up, 40, 25)])
    alone = ref.run(u, up, 40, 25)
    for got, want in zip(legs, [(u, up, ys), alone]):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ys.abs().max() > 0
