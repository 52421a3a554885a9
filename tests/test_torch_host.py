"""The port's copies of the host layers against the JAX package's
originals: on the same box cases every copy gives exactly the same
bytes and arrays (np.array_equal, no tolerance)."""

import dataclasses

import numpy as np
import pytest

from hercules_tpu import config as jconfig
from hercules_tpu import cvm as jcvm
from hercules_tpu import meshgen as jmeshgen
from hercules_tpu.etree.reader import EtreeReader as JaxEtreeReader
from hercules_tpu.io.meshout import write_mesh_etree as jax_write_mesh
from hercules_tpu.mesh import locate as jlocate
from hercules_tpu.physics import consts as jconsts
from hercules_tpu.physics import kmats as jkmats
from hercules_tpu.source import model as jmodel
from hercules_tpu.tools.makecvm import build_layered_cvm as jax_makecvm
from hercules_tpu_torch import config, cvm, meshgen
from hercules_tpu_torch.etree.reader import EtreeReader
from hercules_tpu_torch.fixtures import (DEPTH_M, EAST_M, FOUR_Q_LAYERS,
                                         LAYERS, NORTH_M, four_q_freq,
                                         write_box_case)
from hercules_tpu_torch.io.meshout import write_mesh_etree
from hercules_tpu_torch.mesh import locate
from hercules_tpu_torch.physics import consts, kmats
from hercules_tpu_torch.source import model
from hercules_tpu_torch.tools.makecvm import build_layered_cvm

# the 62.5 m box (elastic), the BKT box, the four-layer box (four Q sets)
CASES = {"box": dict(layers=LAYERS),
         "bkt": dict(layers=LAYERS, damping="bkt"),
         "four_q": dict(layers=FOUR_Q_LAYERS, damping="bkt",
                        freq=four_q_freq(62.5))}


def assert_same(a, b, where="value"):
    """a and b hold equal values: arrays element for element (NaN equal
    to NaN) with one dtype, containers and objects field by field."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif hasattr(a, "__dict__") and not callable(a):
        # an object of the port against its JAX twin: same class name
        assert type(a).__name__ == type(b).__name__, where
        assert_same(vars(a), vars(b), f"{where}.{type(a).__name__}")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    else:
        assert type(a) is type(b) and a == b, where


@dataclasses.dataclass
class Twin:
    """One box case set up by the port's host layers and by the JAX
    package's, from the same run directory."""

    root: str
    paths: tuple
    layers: tuple
    params: object
    jparams: object
    mesh: object
    jmesh: object


@pytest.fixture(scope="module", params=sorted(CASES))
def twin(request, tmp_path_factory):
    case = CASES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    paths = write_box_case(str(root), 62.5, 10, 5, **case)
    cv, ph, nu = paths
    params = config.load_params(ph, nu)
    jparams = jconfig.load_params(ph, nu)
    mesh = meshgen.generate_mesh(params, cvm.open_material_db(cv, params))
    jmesh = jmeshgen.generate_mesh(jparams,
                                   jcvm.open_material_db(cv, jparams))
    return Twin(str(root), paths, case["layers"], params, jparams, mesh,
                jmesh)


def test_makecvm_writes_the_same_bytes(twin, tmp_path):
    """The fixture's CVM (the port's makecvm) is byte for byte the one
    the JAX package's makecvm writes from the same layer table."""
    ref = str(tmp_path / "jax.e")
    jax_makecvm(ref, EAST_M, NORTH_M, DEPTH_M, 62.5,
                [list(r) for r in twin.layers])
    mine = str(tmp_path / "port.e")
    build_layered_cvm(mine, EAST_M, NORTH_M, DEPTH_M, 62.5,
                      [list(r) for r in twin.layers])
    with open(ref, "rb") as f:
        want = f.read()
    for path in (mine, twin.paths[0]):
        with open(path, "rb") as f:
            assert f.read() == want, path


def test_load_params_equal(twin):
    assert type(twin.params).__name__ == "Params"
    for f in dataclasses.fields(twin.jparams):
        assert_same(getattr(twin.params, f.name),
                    getattr(twin.jparams, f.name), f.name)


def test_generate_mesh_equal(twin):
    assert twin.mesh.lenum == 2048
    for f in dataclasses.fields(twin.jmesh):
        assert_same(getattr(twin.mesh, f.name), getattr(twin.jmesh, f.name),
                    f.name)


def test_source_forces_equal(twin):
    ids, forces = model.SourceModel.parse(twin.params).compute_forces(
        twin.mesh, twin.params)
    jids, jforces = jmodel.SourceModel.parse(twin.jparams).compute_forces(
        twin.jmesh, twin.jparams)
    assert len(ids) == 8
    assert_same(ids, jids, "source node ids")
    assert_same(np.asarray(forces), np.asarray(jforces), "force stream")


def test_station_location_equal(twin):
    p = twin.params
    lat, lon, depth = (p.stations[:, i] for i in range(3))
    got = []
    for mod, loc, mesh in ((model, locate, twin.mesh),
                           (jmodel, jlocate, twin.jmesh)):
        x, y = mod.compute_domain_coords_linearinterp(
            lon, lat, p.domain_surface_corners[:, 0],
            p.domain_surface_corners[:, 1], p.region_length_east_m,
            p.region_length_north_m)
        found, eidx = loc.locate_points(mesh, x, y, depth)
        got.append((x, y, found, eidx,
                    loc.local_coords(mesh, eidx, x, y, depth)))
    assert got[0][2].all()
    assert_same(got[0], got[1], "stations")


def test_physics_equal(twin):
    assert_same(kmats.XI, jkmats.XI, "XI")
    for fn in ("build_k_matrices", "stiffness_matrices_24",
               "bkt_matrices_24", "spectral_factors",
               "spectral_bkt_factors", "hadamard8_matrix"):
        assert_same(getattr(kmats, fn)(), getattr(jkmats, fn)(), fn)
    assert_same(kmats.effective_matrix(0.3, 0.7),
                jkmats.effective_matrix(0.3, 0.7), "effective_matrix")
    m, jm, p, jp = twin.mesh, twin.jmesh, twin.params, twin.jparams
    ab = consts.compute_setab(p.freq, p.type_of_damping)
    assert_same(ab, jconsts.compute_setab(jp.freq, jp.type_of_damping),
                "compute_setab")
    coeffs = consts.element_coefficients(m.props, m.edge_m, p, *ab)
    jcoeffs = jconsts.element_coefficients(jm.props, jm.edge_m, jp, *ab)
    assert_same(coeffs, jcoeffs, "element_coefficients")
    assert_same(consts.node_masses(m, m.props, coeffs, p),
                jconsts.node_masses(jm, jm.props, jcoeffs, jp),
                "node_masses")
    assert_same(consts.boundary_dashpots(m, m.props),
                jconsts.boundary_dashpots(jm, jm.props), "dashpots")
    assert_same(consts.critical_dt(m.props, m.edge_m),
                jconsts.critical_dt(jm.props, jm.edge_m), "critical_dt")
    assert_same(consts.critical_dt_factors(m.props, m.edge_m, p),
                jconsts.critical_dt_factors(jm.props, jm.edge_m, jp),
                "critical_dt_factors")


def test_mesh_etree_round_trip_equal(twin, tmp_path):
    """The mesh written as an etree is byte for byte the JAX package's,
    and reads back the same through either reader."""
    mine, ref = str(tmp_path / "port.e"), str(tmp_path / "jax.e")
    write_mesh_etree(mine, twin.mesh)
    jax_write_mesh(ref, twin.jmesh)
    with open(mine, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    r, jr = EtreeReader(mine), JaxEtreeReader(ref)
    assert r.total_count() == jr.total_count() == twin.mesh.lenum
    assert_same(r.octants(), jr.octants(), "octants")
    idx = np.arange(twin.mesh.lenum)
    assert_same(r.records(idx), jr.records(idx), "records")
