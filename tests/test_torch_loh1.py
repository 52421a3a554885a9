"""LOH.1 (validation B2) on the port, on the CPU in float64: the
benchmark of ``hercules_tpu_torch/tools/loh1.py`` (the JAX package's
definition, its base parameters written by ``fixtures``), scored against
the committed golden ``tests/goldens/loh1_fine_f64.npz`` with the port's
``utils/gof.py``, as ``tests/test_validation_loh1.py`` scores the JAX
package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.solver.step import run_solver as jax_run_solver
from hercules_tpu_torch.fixtures import one_torch_thread
from hercules_tpu_torch.meshgen import generate_mesh
from hercules_tpu_torch.solver.assemble import assemble
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.source.model import SourceModel
from hercules_tpu_torch.tools import loh1
from hercules_tpu_torch.utils.gof import gof_score


_one_torch_thread = one_torch_thread()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(params, graded mesh, fine mesh, graded samples, fine samples):
    the unstructured solver's float64 runs."""
    tmp = str(tmp_path_factory.mktemp("loh1"))
    cvm = loh1.build_cvm(tmp)
    p = loh1.make_params(tmp)
    graded = generate_mesh(p, cvm)
    fine = loh1.fine_mesh(p, cvm)
    return p, graded, fine, loh1.run(graded, p, device="cpu"), \
        loh1.run(fine, p, device="cpu")


def test_loh1_mesh_is_graded_with_correct_materials(case):
    p, graded, fine, _, _ = case
    loh1.check_meshes(graded, fine)
    assert p.total_steps == 200 and p.type_of_damping == "none"
    assert (graded.lenum, graded.nnum, len(graded.dn_ids)) == (5632, 7179,
                                                               800)
    plan = build_plan(graded)
    assert len(plan.bricks) == 1 and len(plan.loose_eidx) == 1536


def test_loh1_graded_gof_vs_committed_golden(case):
    """The graded mesh on the unstructured solver: GOF >= 8 on every
    energetic component, at least 6 of them."""
    _, _, _, sg, _ = case
    scores = loh1.gof_scores(sg)
    assert len(scores) >= 6
    assert min(scores.values()) >= 8.0, scores


def test_loh1_golden_regenerates(case):
    """The fine-mesh run scores GOF >= 9.9 against the golden on every
    component above 0.05 of the overall RMS."""
    _, _, _, _, sf = case
    ref = np.load(loh1.GOLDEN)["samples"]
    st_rms = np.sqrt(np.mean(ref ** 2))
    scored = 0
    for s in range(ref.shape[1]):
        for c in range(3):
            if np.sqrt(np.mean(ref[:, s, c] ** 2)) < 0.05 * st_rms:
                continue
            assert float(gof_score(ref[:, s, c], sf[:, s, c])) >= 9.9
            scored += 1
    assert scored >= 6


def test_loh1_graded_matches_converged_reference(case):
    """Graded-interface seismograms against the uniformly fine run."""
    _, _, _, sg, sf = case
    assert np.abs(sf).max() > 0
    for s in range(len(loh1.STATIONS)):
        scale = np.sqrt(np.mean(sf[:, s] ** 2))
        for c in range(3):
            mis = np.sqrt(np.mean((sg[:, s, c] - sf[:, s, c]) ** 2)) / scale
            assert mis < 0.08, (s, c, mis)


def test_loh1_p_arrival_matches_ray_theory(case):
    """First motion at the surface station against the Fermat travel
    time of the refracted direct P through the interface."""
    _, _, _, _, sf = case
    st = 0                               # (9000, 9000): 4243 m offset
    R = np.hypot(loh1.STATIONS[st][0] - loh1.SRC[0],
                 loh1.STATIONS[st][1] - loh1.SRC[1])
    d_half = loh1.SRC[2] - 1000.0        # source below the interface
    a = np.linspace(0.0, R, 20001)       # crossing-point offset
    t_p = (np.sqrt(a ** 2 + d_half ** 2) / 6000.0
           + np.sqrt((R - a) ** 2 + 1000.0 ** 2) / 4000.0).min()
    u = np.linalg.norm(sf[:, st, :], axis=1)
    t_detect = loh1.DT * np.argmax(u > 0.01 * u.max())
    assert t_p - 2 * loh1.DT < t_detect < t_p + 1.0, (t_detect, t_p)


def test_loh1_graded_matches_jax(case):
    """The graded run against the JAX package's unstructured solver on
    the same tables, sources and stations: within 2e-13 of the largest
    sample."""
    p, graded, _, sg, _ = case
    tables = assemble(graded, p)
    src_ids, forces = SourceModel.parse(p).compute_forces(graded, p)
    st_nodes, st_phi = loh1.station_tables(graded)
    _, want = jax_run_solver(tables, src_ids, forces, p.total_steps,
                             p.delta_t, st_nodes=st_nodes, st_phi=st_phi,
                             dtype=jnp.float64)
    want = np.asarray(want)
    np.testing.assert_allclose(sg, want, rtol=0,
                               atol=2e-13 * np.abs(want).max())


@pytest.fixture(scope="module")
def routes(tmp_path_factory):
    """solver -> (route name, samples): Simulation.run in float64 on the
    case ``fixtures.loh1_case`` writes, "auto" and "unstructured"."""
    sim = loh1.simulation(str(tmp_path_factory.mktemp("loh1_sim")))
    out = {}
    for solver in ("auto", "unstructured"):
        _, samples = sim.run(device="cpu", dtype=torch.float64,
                             solver=solver)
        out[solver] = (sim.solver_path_name, samples)
    return out


@pytest.mark.parametrize("solver", ["auto", "unstructured"])
def test_loh1_simulation_routes_score(routes, solver):
    """Through Simulation.run on the case ``fixtures.loh1_case`` writes:
    "auto" takes the mesh route (its plain versions on the CPU), and
    both routes score GOF >= 8 on every energetic component."""
    route, samples = routes[solver]
    assert route == {"auto": "torch_plain",
                     "unstructured": "unstructured"}[solver]
    scores = loh1.gof_scores(samples)
    assert len(scores) >= 6 and min(scores.values()) >= 8.0, scores


def test_loh1_mesh_route_matches_unstructured(routes):
    """The mesh route (one brick stepped by K1's plain version, 1,536
    loose elements, the interface reconciled) against the unstructured
    solver on the same case: within 2e-13 of the largest sample."""
    mesh, want = routes["auto"][1], routes["unstructured"][1]
    assert mesh.shape == want.shape == (200, 3, 3)
    np.testing.assert_allclose(mesh, want, rtol=0,
                               atol=2e-13 * np.abs(want).max())
