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


def test_matlab_mesh_equal(twin, tmp_path):
    """The MATLAB mesh files are byte for byte the JAX package's, for the
    whole domain and for a box of corners."""
    from hercules_tpu.io.matlab import write_matlab_mesh as jax_write
    from hercules_tpu_torch.io.matlab import write_matlab_mesh
    for bbox in (None, (0.0, 500.0, 250.0, 1000.0, 0.0, 125.0)):
        mine, ref = tmp_path / "port", tmp_path / "jax"
        n = write_matlab_mesh(str(mine), twin.mesh, twin.params, bbox=bbox)
        assert n == jax_write(str(ref), twin.jmesh, twin.jparams, bbox=bbox)
        assert 0 < n <= twin.mesh.lenum
        for f in ("mesh_coordinates.0", "mesh_data.0"):
            assert (mine / f).read_bytes() == (ref / f).read_bytes(), f


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


@pytest.mark.parametrize("module", ["checkpoint", "output4d", "planes"])
def test_io_copy_is_byte_equal(module):
    """The port's io/checkpoint.py, io/output4d.py and io/planes.py are
    the JAX package's files byte for byte (numpy and threads only; the
    relative imports of planes.py resolve to the port's own copies)."""
    import importlib
    import inspect
    mine = importlib.import_module(f"hercules_tpu_torch.io.{module}")
    ref = importlib.import_module(f"hercules_tpu.io.{module}")
    with open(inspect.getfile(mine), "rb") as f, \
            open(inspect.getfile(ref), "rb") as g:
        assert f.read() == g.read()
    if module == "planes":
        assert mine.locate_points is locate.locate_points


def test_gof_copy_is_byte_equal():
    """The port's utils/gof.py (numpy only) is the JAX package's file
    byte for byte, and scores alike."""
    import inspect

    from hercules_tpu.utils import gof as jgof
    from hercules_tpu_torch.utils import gof
    with open(inspect.getfile(gof), "rb") as f, \
            open(inspect.getfile(jgof), "rb") as g:
        assert f.read() == g.read()
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((200, 3))
    sim = ref + 0.1 * rng.standard_normal((200, 3))
    assert np.array_equal(gof.gof_score(ref, sim), jgof.gof_score(ref, sim))


def test_buildings_copy_is_byte_equal():
    """The port's buildings.py (numpy only) is the JAX package's file
    byte for byte."""
    import inspect

    from hercules_tpu import buildings as jbuildings
    from hercules_tpu_torch import buildings
    with open(inspect.getfile(buildings), "rb") as f, \
            open(inspect.getfile(jbuildings), "rb") as g:
        assert f.read() == g.read()


def test_partition_is_a_copy():
    """parallel/partition.py (numpy, and the port's own
    nonlinear.smooth_rise_factor) is the JAX package's file byte for
    byte."""
    import inspect

    from hercules_tpu.parallel import partition as jpartition
    from hercules_tpu_torch.parallel import partition
    with open(inspect.getfile(partition), "rb") as f, \
            open(inspect.getfile(jpartition), "rb") as g:
        assert f.read() == g.read()


def test_partition_tables_equal(twin):
    """On the same box, the port's shard_tables gives the JAX package's
    tables array for array."""
    from hercules_tpu.parallel.partition import shard_tables as jshard
    from hercules_tpu.solver.assemble import assemble as jassemble
    from hercules_tpu_torch.parallel.partition import shard_tables
    from hercules_tpu_torch.solver.assemble import assemble
    t, jt = assemble(twin.mesh, twin.params), jassemble(twin.jmesh,
                                                        twin.jparams)
    src = np.array([int(twin.mesh.elem_lnid[0, 7])])
    for P in (3, 8):
        a = shard_tables(t, twin.mesh, P, src_ids=src)
        b = jshard(jt, twin.jmesh, P, src_ids=src)
        assert_same(vars(a), vars(b), f"ShardedTables P={P}")


# the numpy parts of nonlinear.py and drm.py, copied with their names
COPIES = {
    "nonlinear": ("_dxi_unit", "_grad_table", "strain_operator",
                  "force_operator", "NonlinearConfig", "NLTables",
                  "build_nonlinear_tables", "smooth_rise_factor",
                  "nonlinear_station_series", "station_constants"),
    "drm": ("DRMConfig", "DRMPlan", "classify", "write_coords",
            "read_coords", "write_info", "sanity_check", "DRMRecorder",
            "read_displacements", "effective_force_records"),
}


@pytest.mark.parametrize("module", sorted(COPIES))
def test_numpy_parts_are_copies(module):
    """Each numpy function and class of nonlinear.py and drm.py is the
    JAX package's source text, and so are their constants (drm.py's
    attach_drm differs only in returning numpy node ids)."""
    import importlib
    import inspect
    mine = importlib.import_module(f"hercules_tpu_torch.{module}")
    ref = importlib.import_module(f"hercules_tpu.{module}")
    for name in COPIES[module]:
        assert inspect.getsource(getattr(mine, name)) == \
            inspect.getsource(getattr(ref, name)), name
    for name, v in vars(ref).items():
        if isinstance(v, (int, float, str, np.ndarray)) \
                and not name.startswith("__"):
            assert_same(getattr(mine, name), v, name)


def test_nonlinear_host_parts_equal(twin, tmp_path):
    """On the same box: the parsed configuration, the nonlinear tables
    (geostatic loading on), the operators, the smooth rise factor, and a
    station's replayed plastic series, array for array."""
    from hercules_tpu import nonlinear as jnl
    from hercules_tpu_torch import nonlinear as nl
    from hercules_tpu_torch.fixtures import add_nonlinear_keys
    path = str(tmp_path / "numerical.in")
    add_nonlinear_keys(path, 4000.0, model="druckerprager",
                       properties_type="cohefriction",
                       properties=((0.0, 3e4, 30.0, 1e-3, 1.0, 1e5),
                                   (5000.0, 5e4, 35.0, 1e-3, 1.0, 2e5)),
                       geostatic_s=0.05)
    cfg = nl.NonlinearConfig.parse(config.ConfigFile(path))
    jcfg = jnl.NonlinearConfig.parse(jconfig.ConfigFile(path))
    assert_same(vars(cfg), vars(jcfg), "NonlinearConfig")
    t = nl.build_nonlinear_tables(twin.mesh, twin.params, cfg)
    jt = jnl.build_nonlinear_tables(twin.jmesh, twin.jparams, jcfg)
    assert t.n == 2048 and len(t.bot_eidx) == 256
    for f in dataclasses.fields(jt):
        if f.name != "cfg":
            assert_same(getattr(t, f.name), getattr(jt, f.name), f.name)
    for fn in ("strain_operator", "force_operator"):
        assert_same(getattr(nl, fn)(), getattr(jnl, fn)(), fn)
    steps = np.arange(200)
    assert_same(nl.smooth_rise_factor(steps, 120),
                jnl.smooth_rise_factor(steps, 120), "smooth_rise_factor")
    con = nl.station_constants(t, 7)
    assert_same(con, jnl.station_constants(jt, 7), "station_constants")
    u8 = 1e-3 * np.random.default_rng(5).standard_normal((30, 8, 3))
    for rate_dep in (False, True):
        assert_same(
            nl.nonlinear_station_series(u8, con["h"], con, 1e-3,
                                        cfg.material_model, rate_dep),
            jnl.nonlinear_station_series(u8, con["h"], con, 1e-3,
                                         jcfg.material_model, rate_dep),
            "nonlinear_station_series")


# the tool copies: the module's code after its docstring
TOOL_COPIES = ("etree.edit", "tools.cvmtools", "tools.q4", "tools.qmesh",
               "tools.plotmesh")


def _after_docstring(path):
    import ast
    with open(path) as f:
        text = f.read()
    return "\n".join(text.splitlines()[ast.parse(text).body[0].end_lineno:])


@pytest.mark.parametrize("module", TOOL_COPIES)
def test_tool_copies_are_the_jax_code(module):
    """etree/edit.py and tools/{cvmtools,q4,qmesh,plotmesh}.py are the
    JAX package's files after the module docstring (which differs only
    in naming the port's commands and whose copy it is); their relative
    imports resolve to the port's own modules."""
    import importlib
    import inspect
    mine = importlib.import_module(f"hercules_tpu_torch.{module}")
    ref = importlib.import_module(f"hercules_tpu.{module}")
    assert _after_docstring(inspect.getfile(mine)) == \
        _after_docstring(inspect.getfile(ref))
    assert "The port's copy of ``hercules_tpu/" in mine.__doc__
    for name, v in vars(mine).items():
        mod = getattr(v, "__module__", None) or ""
        if mod.startswith("hercules_tpu") and name != "__builtins__":
            assert mod.startswith("hercules_tpu_torch"), (name, mod)


def test_tool_copies_give_the_same_output(twin, tmp_path):
    """On the same box: the editor opens the fixture's CVM into equal
    arrays and commits it to the same bytes; cvmtools' scancvm and
    showdbctl print the same text; qmesh's mesh.e (the port's mesh
    through the port's writer) is byte-equal to the JAX package's."""
    import io

    from hercules_tpu.etree.edit import EtreeEditor as JaxEditor
    from hercules_tpu.tools import cvmtools as jcvmtools
    from hercules_tpu_torch.etree.edit import EtreeEditor
    from hercules_tpu_torch.tools import cvmtools
    cv = twin.paths[0]
    ed, jed = EtreeEditor.open(cv), JaxEditor.open(cv)
    for name in ("x", "y", "z", "level", "payload"):
        assert_same(getattr(ed, name), getattr(jed, name), name)
    ed.commit(str(tmp_path / "a.e"))
    jed.commit(str(tmp_path / "b.e"))
    assert (tmp_path / "a.e").read_bytes() == (tmp_path / "b.e").read_bytes()
    for fn in ("scancvm", "showdbctl"):
        a, b = io.StringIO(), io.StringIO()
        getattr(cvmtools, fn)(cv, out=a)
        getattr(jcvmtools, fn)(cv, out=b)
        assert a.getvalue() == b.getvalue(), fn
    write_mesh_etree(str(tmp_path / "m.e"), twin.mesh)
    jax_write_mesh(str(tmp_path / "jm.e"), twin.jmesh)
    assert (tmp_path / "m.e").read_bytes() == (tmp_path / "jm.e").read_bytes()
