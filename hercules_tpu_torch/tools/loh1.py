"""The LOH.1 (validation B2) benchmark on the port: its definition, and
the scoring against the committed golden seismograms.

Counterpart of ``hercules_tpu/tools/loh1.py``, with the same medium,
source, stations and meshes (doc/validationtests.pdf, Table B2): a 1 km
layer Vp=4000/Vs=2000/rho=2600 over a halfspace Vp=6000/Vs=3464/
rho=2700, strike-slip point double-couple at 2 km depth, exponential
moment ramp M0*(1-(1+t/T)e^{-t/T}) low-pass filtered at 0.5 Hz,
stations off the nodal planes, 200 steps of 0.02 s.  The JAX package
reads its base parameters from the reference's simple example; the port
writes them with ``fixtures.write_box_case`` and applies the same LOH.1
values on top (``write_inputs``), so it needs no reference data.

``GOLDEN`` is the committed converged float64 run of the uniformly fine
(375 m) mesh on the JAX package's unstructured solver
(``tests/goldens/loh1_fine_f64.npz``, samples [200, 3, 3]).
``main`` regenerates it (``python -m hercules_tpu_torch.tools.loh1
[out.npz] [--device=cpu]``; the default path is the committed file).
``gof_scores`` scores a run against it as
``tests/test_validation_loh1.py`` does: the envelope+phase GOF
(``utils/gof.py``) of every energetic component (at least 0.1 of its
station's RMS), where >= 8 is "excellent".
"""

from __future__ import annotations

import os

import numpy as np

# Table B2 medium
LAYERS = [[0.0, 4000.0, 2000.0, 2600.0],
          [1000.0, 6000.0, 3464.0, 2700.0]]
EAST = NORTH = 12000.0
DEEP = 6000.0
SRC = (6000.0, 6000.0, 2000.0)       # x, y, depth -- in the halfspace
STATIONS = [(9000.0, 9000.0), (9674.0, 8121.0), (8121.0, 9674.0)]
F = 0.5
DT = 0.02
T_END = 4.0

SOURCE_IN = """
type_of_source = point
lonlat_or_cartesian = 1
hypocenter_x = {x}
hypocenter_y = {y}
hypocenter_depth_m = {z}
source_strike_deg = 90
source_dip_deg = 90
source_rake_deg = 0
moment_amplitude = 1e18
source_function_type = exponential
average_risetime_sec = 0.8
source_is_filtered = 1
threshold_frequency = 0.5
number_of_poles = 14
number_of_time_windows = 1
time_windows =
0
domain_surface_corners =
  0.0   0.0
  0.0   0.1
  0.1   0.1
  0.1   0.0
"""

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))),
    "tests", "goldens", "loh1_fine_f64.npz")


def build_cvm(tmp):
    """Write the layered CVM (250 m octants) to ``tmp/loh1.e`` and open
    it."""
    from ..cvm import CVM
    from .makecvm import build_layered_cvm
    path = os.path.join(tmp, "loh1.e")
    build_layered_cvm(path, EAST, NORTH, DEEP, 250.0, LAYERS)
    return CVM(path)


def write_inputs(tmp):
    """Write the run's ``in/physics.in``, ``in/numerical.in`` and
    ``in/src/source.in`` under ``tmp``: the box case's files
    (``fixtures.write_box_case``, no stations) with the LOH.1 region,
    frequency, time step, end time, shear-velocity floor, no damping,
    and the LOH.1 source.  Returns (physics_in, numerical_in)."""
    from ..fixtures import _set_keys, write_box_case
    cvmdb, physics, numerical = write_box_case(
        tmp, steps=1, n_stations=0, damping="none", freq=F)
    os.remove(cvmdb)                 # the box's own CVM; build_cvm's serves
    _set_keys(physics, [
        (r"^(region_length_east_m\s*=\s*)\S+", rf"\g<1>{EAST:g}"),
        (r"^(region_length_north_m\s*=\s*)\S+", rf"\g<1>{NORTH:g}"),
        (r"^(region_depth_deep_m\s*=\s*)\S+", rf"\g<1>{DEEP:g}")])
    _set_keys(numerical, [
        (r"^(simulation_shear_velocity_min\s*=\s*)\S+", r"\g<1>500"),
        (r"^(simulation_start_time_sec\s*=\s*)\S+", r"\g<1>0"),
        (r"^(simulation_end_time_sec\s*=\s*)\S+", rf"\g<1>{T_END!r}"),
        (r"^(simulation_delta_time_sec\s*=\s*)\S+", rf"\g<1>{DT!r}")])
    with open(os.path.join(tmp, "in", "src", "source.in"), "w") as f:
        f.write(SOURCE_IN.format(x=SRC[0], y=SRC[1], z=SRC[2]))
    return physics, numerical


def make_params(tmp):
    """The run's Params, from the files ``write_inputs`` writes."""
    from ..config import load_params
    return load_params(*write_inputs(tmp))


def fine_mesh(p, cvm):
    """Uniform 375 m mesh: the halfspace at 2x the vs-rule resolution."""
    from ..material import MeshOrigin, correct_properties
    from ..mesh import Octree, extract_mesh
    tree = Octree.newtree(EAST, NORTH, DEEP)

    def setrec(tr, hi, lo, lv):
        return {"lv": lv}

    def toexpand(tr, hi, lo, lv, rec):
        return np.full(np.shape(hi), lv < 5)

    tree.refine(setrec, toexpand)
    tree.balance()
    mesh = extract_mesh(tree)
    correct_properties(mesh, cvm, p, MeshOrigin.from_params(p, cvm.ctl))
    return mesh


def station_tables(mesh):
    """(nodes [S, 8], phi [S, 8]) of the surface stations."""
    from ..mesh.locate import local_coords, locate_points
    from ..physics.kmats import XI
    x = np.array([s[0] for s in STATIONS])
    y = np.array([s[1] for s in STATIONS])
    z = np.zeros(len(STATIONS))
    found, eidx = locate_points(mesh, x, y, z)
    if not found.all():
        raise RuntimeError("an LOH.1 station lies outside the mesh")
    cx, cy, cz = local_coords(mesh, eidx, x, y, z)
    phi = ((1 + XI[0][None] * cx[:, None])
           * (1 + XI[1][None] * cy[:, None])
           * (1 + XI[2][None] * cz[:, None]) / 8.0)
    return mesh.elem_lnid[eidx], phi


def check_meshes(graded, fine):
    """Raise unless the graded mesh is what the benchmark needs
    (tests/test_validation_loh1.py:test_loh1_mesh_is_graded_with_
    correct_materials): two or more levels with dangling nodes, the B2
    materials by depth, smaller elements in the layer than in the
    halfspace; and the fine mesh uniform."""
    ts = graded.ticksize
    z = graded.elem_z.astype(np.float64) * ts
    e = ts * (np.int64(1) << (30 - graded.elem_level.astype(np.int64)))
    layer = z + e <= 1000.0 + 1e-6
    half = z >= 1000.0 - 1e-6
    checks = {
        "two or more levels": len(np.unique(graded.elem_level)) >= 2,
        "dangling nodes": len(graded.dn_ids) > 0,
        "layer and halfspace elements": layer.any() and half.any(),
        "layer Vs 2000": np.allclose(graded.props["Vs"][layer], 2000.0),
        "halfspace Vs 3464": np.allclose(graded.props["Vs"][half], 3464.0),
        "halfspace Vp 6000": np.allclose(graded.props["Vp"][half], 6000.0),
        "layer finer than halfspace": e[layer].max() < e[half].max(),
        "fine mesh uniform": len(np.unique(fine.elem_level)) == 1,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"LOH.1 mesh checks failed: {bad}")


def simulation(root):
    """The port's Simulation of LOH.1 (``fixtures.loh1_case`` under
    ``root``: the graded mesh of the vs-rule), sampling the benchmark's
    stations."""
    from ..fixtures import loh1_case
    from ..sim import Simulation, StationSet
    cvmdb, physics, numerical = loh1_case(root)
    sim = Simulation.setup(physics, numerical, cvmdb=cvmdb)
    nodes, phi = station_tables(sim.mesh)
    sim.stations = StationSet(
        ids=np.arange(len(STATIONS), dtype=np.int32), nodes=nodes, phi=phi,
        coords=np.array([(x, y, 0.0) for x, y in STATIONS]))
    return sim


def run(mesh, p, dtype=None, device="cuda"):
    """The unstructured solver's run (float64 unless ``dtype``) on
    ``device``; returns the station samples [T, S, 3]."""
    import torch
    from ..solver.assemble import assemble
    from ..solver.step import run_solver
    from ..source.model import SourceModel
    tables = assemble(mesh, p)
    sm = SourceModel.parse(p)
    src_ids, forces = sm.compute_forces(mesh, p)
    st_nodes, st_phi = station_tables(mesh)
    _, samples = run_solver(tables, src_ids, forces, p.total_steps,
                            p.delta_t, st_nodes=st_nodes, st_phi=st_phi,
                            dtype=dtype or torch.float64, device=device)
    return samples


def gof_scores(samples, ref=None):
    """{(station, component): GOF} of ``samples`` [T, S, 3] against the
    golden (or ``ref``), for every component whose RMS is at least 0.1
    of its station's (test_validation_loh1.py:66-87)."""
    from ..utils.gof import gof_score
    if ref is None:
        ref = np.load(GOLDEN)["samples"]
    if samples.shape != ref.shape:
        raise ValueError(f"samples {samples.shape}, golden {ref.shape}")
    scores = {}
    for s in range(ref.shape[1]):
        st_rms = np.sqrt(np.mean(ref[:, s] ** 2))
        for c in range(3):
            if np.sqrt(np.mean(ref[:, s, c] ** 2)) < 0.1 * st_rms:
                continue                 # near-nodal component
            scores[(s, c)] = float(gof_score(ref[:, s, c],
                                             np.asarray(samples)[:, s, c]))
    return scores


def main(argv=None):
    """Regenerate the golden: the fine 375 m mesh through ``run`` in
    float64 on the card (``--device=cpu`` on the CPU), written with
    ``np.savez_compressed`` to the path given, else to ``GOLDEN``; the
    keys of hercules_tpu/tools/loh1.py:150-167."""
    import sys
    import tempfile
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for a in [a for a in argv if a.startswith("--device=")]:
        device = a.split("=", 1)[1]
        argv.remove(a)
    out = (argv or [GOLDEN])[0]
    with tempfile.TemporaryDirectory(prefix="loh1_golden_") as tmp:
        cvm = build_cvm(tmp)
        p = make_params(tmp)
        mesh = fine_mesh(p, cvm)
        samples = run(mesh, p, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(
        out, samples=samples, dt=DT, stations=np.array(STATIONS),
        layers=np.array(LAYERS), src=np.array(SRC),
        note="LOH.1 (validationtests.pdf B2) converged f64 fine-mesh "
             "(375 m uniform) seismograms; regenerate with "
             "python -m hercules_tpu_torch.tools.loh1")
    print(f"golden written: {out} ({samples.shape})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
