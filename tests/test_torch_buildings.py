"""Buildings on the CPU: the port's ``buildings.py`` (a copy of the JAX
package's), the carved mesh, the base nodes and their prescribed
displacement series, the station and source depth shifts, and the runs
through ``Simulation.run`` against the JAX package's in float64, on
fixture (a) with the JAX building tests' one building
(tests/test_buildings.py:15-24; ``fixtures.BUILDING``, at the time step
``BUILDING_DT`` its 7.8125 m elements need).  Bound: 2e-13 of the
largest sample."""

import numpy as np
import pytest

import jax.numpy as jnp

from hercules_tpu.buildings import Buildings as JaxBuildings
from hercules_tpu.config import ConfigFile as JaxConfigFile
from hercules_tpu.sim import Simulation as JaxSimulation
from hercules_tpu_torch.buildings import Buildings
from hercules_tpu_torch.config import ConfigFile
from hercules_tpu_torch.fixtures import (BUILDING_DT, add_building_keys,
                                         one_torch_thread, write_box_case)
from hercules_tpu_torch.sim import Simulation

STEPS = 40

_one_torch_thread = one_torch_thread()


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """{fixed base: (port Simulation, JAX Simulation, run directory)}."""
    made = {}
    for fb in (False, True):
        root = tmp_path_factory.mktemp(f"bldg{int(fb)}")
        cv, ph, nu = write_box_case(str(root), 62.5, STEPS, 5,
                                    dt=BUILDING_DT)
        add_building_keys(str(root), nu, fixed_base=fb)
        made[fb] = (Simulation.setup(ph, nu, cvmdb=cv),
                    JaxSimulation.setup(ph, nu, cvmdb=cv), str(root))
    return made


def test_parse_matches_jax(twins):
    for fb, (sim, jsim, _) in twins.items():
        b, jb = sim.mesh.buildings, jsim.mesh.buildings
        assert b.fixed_base == jb.fixed_base == fb
        assert b.surface_shift == jb.surface_shift == 62.5
        for k, v in vars(jb).items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(getattr(b, k), v), k
            else:
                assert getattr(b, k) == v, k
        np.testing.assert_array_equal(b.zmax, [125.0])
        path = sim.params.numerical_path
        assert vars(Buildings.parse(ConfigFile(path))).keys() == \
            vars(JaxBuildings.parse(JaxConfigFile(path))).keys()


def test_carved_mesh_matches_jax(twins):
    """The mesh carved and refined for the building, array for array;
    the building's vs-rule refines its footprint to 7.8125 m."""
    sim, jsim, _ = twins[False]
    m, jm = sim.mesh, jsim.mesh
    assert m.lenum == jm.lenum and m.lenum > 2048
    for f in ("elem_x", "elem_y", "elem_z", "elem_level", "elem_lnid",
              "node_x", "node_y", "node_z", "dn_ids", "dn_anchors",
              "dn_weights", "edge_m"):
        assert np.array_equal(getattr(m, f), getattr(jm, f)), f
    for k in ("Vp", "Vs", "rho"):
        assert np.array_equal(m.props[k], jm.props[k]), k
    assert (m.props["Vp"] > 0).all()
    assert np.allclose(np.unique(m.props["Vs"]), [500.0, 1000.0, 3464.0])
    assert m.edge_m.min() == 7.8125


def test_base_nodes_and_series_match_jax(twins):
    sim, jsim, root = twins[True]
    b, jb = sim.mesh.buildings, jsim.mesh.buildings
    ids, which = b.base_nodes(sim.mesh)
    jids, jwhich = jb.base_nodes(jsim.mesh)
    assert len(ids) == 17 * 17
    assert np.array_equal(ids, jids) and np.array_equal(which, jwhich)
    p = sim.params
    series = b.base_disp_series(p.end_time - p.start_time, p.delta_t,
                                STEPS, rundir=root)
    jseries = jb.base_disp_series(p.end_time - p.start_time, p.delta_t,
                                  STEPS, rundir=root)
    assert series.shape == (STEPS, 1, 3)
    assert np.array_equal(series, jseries) and np.abs(series).max() > 0


def test_depth_shifts_match_jax(twins):
    """Stations sit surface_shift deeper, as in the JAX package (the
    surface is pushed down under the building); the sources are parsed
    with the same shift (it moves srfh sources; the box's point source
    keeps its depth in both packages)."""
    sim, jsim, _ = twins[False]
    st, jst = sim.stations, jsim.stations
    np.testing.assert_array_equal(st.coords[:, 2],
                                  sim.params.stations[st.ids, 2] + 62.5)
    for k in ("ids", "nodes", "phi", "coords", "eidx"):
        assert np.array_equal(getattr(st, k), getattr(jst, k)), k
    assert np.array_equal(sim.src_ids, jsim.src_ids)
    assert np.array_equal(sim.src_forces, jsim.src_forces)
    assert sim.source.hypo_depth == jsim.source.hypo_depth == 250.0


@pytest.mark.parametrize("fixed_base", [False, True])
def test_simulation_matches_jax(twins, fixed_base):
    """The carved mesh (one brick and loose elements) on "auto", the
    mesh route; with fixed base on the unstructured solver, which holds
    the base nodes to the prescribed series."""
    sim, jsim, root = twins[fixed_base]
    state, samp = sim.run(device="cpu", rundir=root)
    if fixed_base:
        assert sim.solver_path_name == "unstructured"
        assert "fixed-base" in sim.solver_path_reason
        ids, which = sim.mesh.buildings.base_nodes(sim.mesh)
        p = sim.params
        series = sim.mesh.buildings.base_disp_series(
            p.end_time - p.start_time, p.delta_t, STEPS, rundir=root)
        assert np.array_equal(state[0].numpy()[ids], series[-1, which])
    else:
        assert (sim.solver_path_name, sim.solver_path_reason) == \
            ("torch_plain", "")
    _, jsamp = jsim.run(dtype=jnp.float64, rundir=root, ndev=1)
    scale = np.abs(jsamp).max()
    assert samp.shape == np.asarray(jsamp).shape == (STEPS, 5, 3)
    assert scale > 0
    np.testing.assert_allclose(samp, jsamp, rtol=0, atol=2e-13 * scale)
