"""The domain reduction method on the CPU: the port's ``drm.py`` and DRM
part 2 on the unstructured solver and on the mesh route (plain
versions) against the JAX package in float64, on in-repo inputs:
fixture (a) undamped (one brick: part 2 rides the mesh route there too)
and the graded box (GRADED_LAYERS' three bricks at 62.5 m), with the
JAX DRM tests' box (tests/test_drm.py:19-29) and a source outside it.
Bounds: part 2 reproduces part 1's field inside the box within 1e-9 of
its max and leaves at most 1e-9 outside (JAX's
test_drm_reproduces_interior_field), the mesh route within 5e-12 of the
unstructured route, part-1 records within 2e-13 of the JAX package's."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from hercules_tpu import drm as jdrm
from hercules_tpu.sim import Simulation as JaxSimulation
from hercules_tpu_torch import drm
from hercules_tpu_torch.fixtures import (DRM_BOX, GRADED_LAYERS,
                                         add_drm_keys, box_dt, four_q_freq,
                                         one_torch_thread, write_box_case)
from hercules_tpu_torch.sim import Simulation
from hercules_tpu_torch.solver import fused_mesh
from hercules_tpu_torch.solver.bricks import build_plan

STEPS = 80
CASES = {"box": {},
         "graded": dict(layers=GRADED_LAYERS, freq=four_q_freq(62.5))}

_one_torch_thread = one_torch_thread()


def _case(root, name, part, steps=STEPS):
    """The case ``name`` undamped, the source at (100, 100, 100) m,
    outside DRM_BOX, with DRM part ``part`` on the files of ``root``."""
    paths = write_box_case(str(root / f"{name}_{part}"), 62.5, steps, 2,
                           damping="none", hypocenter=(100.0, 100.0, 100.0),
                           **CASES[name])
    add_drm_keys(paths[2], str(root / f"{name}_files"), part, box_dt(62.5))
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (part-1 Simulation, its final u, part-2 Simulation with a
    zero source)}: part 1 through Simulation.run on the unstructured
    route, which writes the records part 2 reads."""
    root = tmp_path_factory.mktemp("drm")
    made = {}
    for name in CASES:
        cv, ph, nu = _case(root, name, "part1")
        s1 = Simulation.setup(ph, nu, cvmdb=cv)
        state, _ = s1.run(device="cpu", solver="unstructured")
        cv, ph, nu = _case(root, name, "part2")
        s2 = Simulation.setup(ph, nu, cvmdb=cv)
        s2.src_forces = np.zeros_like(s2.src_forces)
        made[name] = (s1, state[0].numpy(), s2)
    return made


@pytest.mark.parametrize("name", sorted(CASES))
def test_classify_and_part0_files_match_jax(tmp_path, name):
    cv, ph, nu = _case(tmp_path, name, "part0", steps=2)
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    jax_dir = tmp_path / "jax"
    with open(nu) as f:
        text = f.read()
    with open(nu, "w") as f:
        f.write(text.replace(str(tmp_path / f"{name}_files"),
                             str(jax_dir)))
    jsim = JaxSimulation.setup(ph, nu, cvmdb=cv)
    plan, jplan = sim.drm_plan, jsim.drm_plan
    assert len(plan.elem_idx) > 0
    for k in ("elem_idx", "mask_b", "node_ids", "node_coords",
              "elem_node_rows"):
        assert np.array_equal(getattr(plan, k), getattr(jplan, k)), k
        assert getattr(plan, k).dtype == getattr(jplan, k).dtype, k
    for f in ("drm_coordinates.bin", "drm_information"):
        with open(os.path.join(sim.drm_dir, f), "rb") as a, \
                open(os.path.join(jax_dir, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("name", sorted(CASES))
def test_attach_drm_matches_jax(runs, name):
    _, _, s2 = runs[name]
    mine = drm.attach_drm(s2.drm_plan, s2.tables, s2.params, s2.drm_dir)
    theirs = jdrm.attach_drm(s2.drm_plan, s2.tables, s2.params, s2.drm_dir)
    assert isinstance(mine["ids"], np.ndarray)
    assert np.array_equal(mine["ids"], np.asarray(theirs["ids"]))
    assert np.array_equal(mine["F"], theirs["F"])
    assert mine["aux"] == theirs["aux"] == 1
    assert mine["F"].shape[0] == STEPS + 1 and np.abs(mine["F"]).max() > 0


def _box_masks(sim):
    m, ts = sim.mesh, sim.mesh.ticksize
    x, y, z = (getattr(m, f"node_{c}").astype(np.float64) * ts
               for c in "xyz")
    x0, y0, x1, y1, depth = DRM_BOX
    inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1) & (z <= depth)
    on = np.zeros(m.nnum, bool)
    on[sim.drm_plan.node_ids] = True
    return inside & ~on, ~inside & ~on


@pytest.mark.parametrize("solver", ["unstructured", "auto"])
def test_part2_reproduces_the_interior_field(runs, solver):
    """On fixture (a): the replayed effective forces give part 1's field
    inside the box and none outside, on the unstructured route and on
    the mesh route ("auto": the one-brick plan takes the mesh route with
    DRM part 2)."""
    s1, u1, s2 = runs["box"]
    state, _ = s2.run(device="cpu", solver=solver)
    assert s2.solver_path_name == {"auto": "torch_plain"}.get(solver,
                                                              solver)
    u2 = (state[0].numpy() if solver == "unstructured" else
          fused_mesh.mesh_u_global(build_plan(s2.mesh), state[0],
                                   s2.mesh.nnum))
    interior, exterior = _box_masks(s2)
    scale = np.abs(u1).max()
    assert scale > 0 and np.abs(u1[interior]).max() > 1e-3 * scale
    np.testing.assert_allclose(u2[interior] / scale, u1[interior] / scale,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(u2[exterior] / scale, 0, atol=1e-9)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_route_matches_unstructured(runs, name):
    """Part 2 on the mesh route (the lerped forces added at each DRM
    node's first copy before the reconciliation) within 5e-12 of the
    unstructured route: one brick, and three with the plane reconciler."""
    _, _, s2 = runs[name]
    plan = build_plan(s2.mesh)
    us, ms = (s2.run(device="cpu", solver=s)[0]
              for s in ("unstructured", "auto"))
    assert s2.solver_path_name == "torch_plain"
    assert s2.solver_path_reason == ""
    u = fused_mesh.mesh_u_global(plan, ms[0], s2.mesh.nnum)
    scale = np.abs(us[0].numpy()).max()
    assert scale > 0
    np.testing.assert_allclose(u, us[0].numpy(), rtol=0,
                               atol=5e-12 * scale)


@pytest.mark.parametrize("solver", ["auto", "unstructured"])
def test_part1_records_match_jax(tmp_path, solver):
    """Part 1 through Simulation.run (the interface nodes sampled in
    the loop and streamed to drm_disp.bin, the step-0 record first) on
    the graded box, against the JAX package's part 1: the records within
    2e-13 of their max, the station samples unpolluted."""
    cv, ph, nu = _case(tmp_path, "graded", "part1", steps=40)
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    _, samp = sim.run(device="cpu", solver=solver, chunk=15)
    mine = drm.read_displacements(sim.drm_dir, len(sim.drm_plan.node_ids))
    jsim = JaxSimulation.setup(ph, nu, cvmdb=cv)
    _, jsamp = jsim.run(dtype=jnp.float64, ndev=1, chunk=15)
    theirs = jdrm.read_displacements(jsim.drm_dir,
                                     len(jsim.drm_plan.node_ids))
    assert samp.shape == np.asarray(jsamp).shape == (40, 2, 3)
    assert mine.shape == (40, len(sim.drm_plan.node_ids), 3)
    assert not mine[0].any()
    scale = np.abs(theirs).max()
    assert scale > 0
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=2e-13 * scale)
    np.testing.assert_allclose(samp, jsamp, rtol=0,
                               atol=2e-13 * np.abs(jsamp).max())
