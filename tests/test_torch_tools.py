"""The port's tools (``hercules_tpu_torch/tools/``) against the JAX
package's, on inputs made in the repo (fixture (a) through
``fixtures.write_box_case`` and ``tools/makecvm``; the JAX package's own
tool tests read the reference's simple example):

- cvmtools: every command's text output and the flat file equal;
- q4: a port run's 4-D file and mesh.e queried at a station equal the
  in-loop samples (rtol 1e-12), and the port's q4_point, q4_node and
  show_meta equal the JAX tools' on the same files;
- qmesh: mesh.e and the --matlab dump byte-equal to the JAX tool's;
- plotmesh: read_matlab_mesh and parse_parameters equal, a PNG written;
- loh1.main: the keys, shapes and metadata of the committed golden,
  GOF >= 9.9 against it, and the committed file untouched;
- resident_bench and perf_ab on the CPU: their lines parse, their final
  states equal run_pallas_solver's bit for bit, perf_ab restores the
  environment, and a process that runs both loads no module of jax or
  of the JAX package."""

import hashlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hercules_tpu.io.output4d import HDR_DTYPE as JAX_HDR_DTYPE
from hercules_tpu.tools import cvmtools as jcvmtools
from hercules_tpu.tools import plotmesh as jplotmesh
from hercules_tpu.tools import q4 as jq4
from hercules_tpu.tools import qmesh as jqmesh
from hercules_tpu_torch.fixtures import (SOFT_FREQ, TWO_LAYERS,
                                         add_output_keys,
                                         one_torch_thread, write_box_case)
from hercules_tpu_torch.io.meshout import write_mesh_etree
from hercules_tpu_torch.io.output4d import HDR_DTYPE
from hercules_tpu_torch.sim import SimOutputs, Simulation
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.fused_brick import run_pallas_solver
from hercules_tpu_torch.tools import (cvmtools, loh1, perf_ab, plotmesh, q4,
                                      qmesh, resident_bench)
from hercules_tpu_torch.utils.gof import gof_score

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_one_torch_thread = one_torch_thread()


@pytest.fixture(scope="module", params=["box", "two_layers"])
def case(request, tmp_path_factory):
    """fixture (a) at 62.5 m (and the two-layer box), 20 steps, two
    stations: (cvmdb, physics_in, numerical_in)."""
    root = tmp_path_factory.mktemp(request.param)
    kw = ({"layers": TWO_LAYERS, "freq": SOFT_FREQ}
          if request.param == "two_layers" else {})
    return write_box_case(str(root), 62.5, 20, 2, **kw)


def _capture(fn, *args):
    """(return value, stdout text) of fn(*args, out=buffer)."""
    buf = io.StringIO()
    return fn(*args, out=buf), buf.getvalue()


def test_cvmtools_output_matches_jax(case, tmp_path, capsys, monkeypatch):
    """querycvm (arguments, stdin, and a point outside), scancvm,
    dumpcvm, showdbctl, pickrecord (in and out of range), flatten and
    main's dispatch: the same text and return codes, and byte-equal
    flat files."""
    db = case[0]
    calls = [("querycvm", (db, ["500", "500", "100"])),
             ("querycvm", (db, ["263.5", "741", "440"])),
             ("querycvm", (db, ["5000", "5000", "100"])),
             ("scancvm", (db,)), ("dumpcvm", (db, 40)),
             ("showdbctl", (db,)), ("pickrecord", (db, "17")),
             ("pickrecord", (db, "2048"))]
    for name, args in calls:
        got = _capture(getattr(cvmtools, name), *args)
        want = _capture(getattr(jcvmtools, name), *args)
        assert got == want, name
        assert got[1], name
    flat, jflat = tmp_path / "port.flat", tmp_path / "jax.flat"
    got = _capture(cvmtools.flatten, db, str(flat), 1000.0, 1000.0, 500.0)
    want = _capture(jcvmtools.flatten, db, str(jflat), 1000.0, 1000.0,
                    500.0)
    assert got[0] == want[0] and got[1].replace("port", "jax") == want[1]
    assert flat.read_bytes() == jflat.read_bytes()
    texts = []
    for mod in (cvmtools, jcvmtools):
        monkeypatch.setattr(sys, "stdin",
                            io.StringIO("100 100 10\n900 900 490\n\n"))
        assert mod.main(["querycvm", db]) == 0
        assert mod.main(["dumpcvm", db, "3"]) == 0
        assert mod.main(["pickrecord", db, "5"]) == 0
        texts.append(capsys.readouterr().out)
        assert mod.main(["nosuchtool", db]) == 2
        assert "querycvm" in capsys.readouterr().out
    assert texts[0] == texts[1] and texts[0].count("\nVs = ") == 3


@pytest.fixture(scope="module")
def q4_run(tmp_path_factory):
    """A port run in float64 on the CPU (fixture (a), 20 steps, 4-D
    output every 5 steps) and its mesh.e: (sim, samples, run dir)."""
    root = tmp_path_factory.mktemp("q4")
    paths = write_box_case(str(root), 62.5, 20, 2)
    add_output_keys(paths[1], paths[2], output_rate=5)
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    _, samples = sim.run(device="cpu", dtype=torch.float64,
                         rundir=str(root),
                         outputs=lambda: SimOutputs(sim.mesh, sim.params,
                                                    rundir=str(root)))
    write_mesh_etree(str(root / "mesh.e"), sim.mesh)
    return sim, samples, root


def test_q4_point_matches_in_loop_samples(q4_run):
    """q4_point at each station's position through mesh.e and the 4-D
    file against the in-loop samples at the output steps (rtol 1e-12),
    as the JAX package's test_q4_roundtrip holds its own."""
    sim, samples, root = q4_run
    h4d, mesh_e = str(root / "disp.h4d"), str(root / "mesh.e")
    assert np.abs(samples).max() > 0
    for s, (x, y, z) in enumerate(sim.stations.coords):
        hdr, series = q4.q4_point(float(x), float(y), float(z), mesh_e, h4d)
        assert series.shape[0] == (sim.params.total_steps + 4) // 5
        for k in range(series.shape[0]):
            np.testing.assert_allclose(series[k], samples[k * 5, s],
                                       rtol=1e-12, atol=1e-18)


def test_q4_tools_match_jax(q4_run):
    """The port's q4_point, q4_node, show_meta and main against the JAX
    tools on the same files: equal headers, arrays and text."""
    sim, _, root = q4_run
    h4d, mesh_e = str(root / "disp.h4d"), str(root / "mesh.e")
    assert HDR_DTYPE == JAX_HDR_DTYPE
    x, y, z = (float(v) for v in sim.stations.coords[1])
    for got, want in ((q4.q4_point(x, y, z, mesh_e, h4d),
                       jq4.q4_point(x, y, z, mesh_e, h4d)),
                      (q4.q4_node(77, h4d), jq4.q4_node(77, h4d))):
        assert got[0].tobytes() == want[0].tobytes()
        assert np.array_equal(got[1], want[1])
    got, want = io.StringIO(), io.StringIO()
    q4.show_meta(h4d, got)
    jq4.show_meta(h4d, want)
    assert got.getvalue() == want.getvalue()
    assert "Hercules 4D output" in got.getvalue()
    for argv in (["single_query", mesh_e, h4d, str(x), str(y), str(z)],
                 ["q4node", mesh_e, h4d, "77"], ["showmeta", h4d]):
        outs = []
        for mod in (q4, jq4):
            r = subprocess.run(
                [sys.executable, "-c",
                 f"import sys; from {mod.__name__} import main; "
                 f"sys.exit(main({argv!r}))"],
                cwd=ROOT, capture_output=True, text=True, timeout=120,
                env=dict(os.environ, JAX_PLATFORMS="cpu"))
            assert r.returncode == 0, r.stderr[-2000:]
            outs.append(r.stdout)
        assert outs[0] == outs[1] and outs[0], argv[0]


def test_qmesh_and_plotmesh_match_jax(case, tmp_path, capsys):
    """qmesh with --matlab in both packages: mesh.e and the dump
    byte-equal, the same counts printed; plotmesh reads both dumps and
    the parameter file alike and writes a PNG (data and writing-PE
    coloring)."""
    cvmdb, physics, numerical = case
    out = {}
    for name, main in (("port", qmesh.main), ("jax", jqmesh.main)):
        d = tmp_path / name
        d.mkdir()
        assert main([cvmdb, physics, numerical, str(d / "mesh.e"),
                     "--matlab", str(d / "ml")]) == 0
        text = capsys.readouterr().out
        out[name] = re.sub(r"mesh_generate: [0-9.]+s", "", text).replace(
            str(d), "")
    assert out["port"] == out["jax"]
    for f in ("mesh.e", "ml/mesh_coordinates.0", "ml/mesh_data.0"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    ml = str(tmp_path / "port" / "ml")
    got, want = plotmesh.read_matlab_mesh(ml), jplotmesh.read_matlab_mesh(ml)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[0].shape == (2048, 8, 3)
    m = plotmesh.ticks_to_meters(got[0], (1000.0, 1000.0, 500.0))
    assert np.array_equal(m, jplotmesh.ticks_to_meters(got[0], (1000.0,
                                                                1000.0,
                                                                500.0)))
    assert m.max() == 1000.0
    pfile = tmp_path / "parameters_for_matlab.in"
    pfile.write_text(
        "x dimension in m : 1000\ny dimension in m : 1000\n"
        "z dimension in m : 500\nx start : 0\nx end : 1000\n"
        "y start : 0\ny end : 1000\nz start : 0\nz end : 200\n"
        "4th dim Vs(1) Vp(2) Rho(3) : 1\nnumber of processors : 1\n"
        f"coord dir : {ml}\ndata dir : {ml}\n"
        "plot processor(p) or data(d) : d\n")
    assert plotmesh.parse_parameters(str(pfile)) == \
        jplotmesh.parse_parameters(str(pfile))
    for mode in ("d", "p"):
        pf = tmp_path / f"p_{mode}.in"
        pf.write_text(pfile.read_text().replace(
            "data(d) : d", f"data(d) : {mode}"))
        png = tmp_path / f"mesh_{mode}.png"
        assert plotmesh.main([str(pf), str(png)]) == 0
        assert png.stat().st_size > 10000


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_loh1_main_regenerates_the_golden(tmp_path, capsys):
    """loh1.main on the CPU into a temporary path: the golden's keys,
    shapes and metadata (dt, stations, layers, source), GOF >= 9.9
    against the committed samples on every component above 0.05 of
    their RMS (tests/test_torch_loh1.py's bound for the fine run), a
    note naming the port's command; the committed golden unchanged."""
    before = _sha256(loh1.GOLDEN)
    out = tmp_path / "sub" / "loh1_fine.npz"
    assert loh1.main([str(out), "--device=cpu"]) == 0
    assert "golden written" in capsys.readouterr().out
    assert _sha256(loh1.GOLDEN) == before
    got, ref = np.load(out), np.load(loh1.GOLDEN)
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        assert got[k].shape == ref[k].shape, k
    for k in ("dt", "stations", "layers", "src"):
        assert np.array_equal(got[k], ref[k]), k
    assert "python -m hercules_tpu_torch.tools.loh1" in str(got["note"])
    samples, golden = got["samples"], ref["samples"]
    rms = np.sqrt(np.mean(golden ** 2))
    scored = 0
    for s in range(golden.shape[1]):
        for c in range(3):
            if np.sqrt(np.mean(golden[:, s, c] ** 2)) < 0.05 * rms:
                continue
            assert float(gof_score(golden[:, s, c], samples[:, s, c])) >= 9.9
            scored += 1
    assert scored >= 6


RB_LINES = (r"# 2048 elems, LEN \d+, chunk launch device bytes .+ MiB "
            r"\(S and K \[8, LEN\] float32\), .+ \(cpu, plain versions\)",
            r"# compile\+first [0-9.]+s \(cpu, plain versions\)",
            r"# 20 steps in [0-9.]+s -> [0-9.e+]+ eups \(\d+ us/step\) "
            r"\(cpu, plain versions\)")


def test_resident_bench_state_matches_the_chunk_route():
    """resident_bench on the CPU at 2048 elements (K5's plain version,
    CH = 20): the tool's lines, and its state after three launches
    equal bit for bit to run_pallas_solver's chunk route from the same
    seeded state."""
    box = resident_bench.build(2048, "rayleigh")
    assert resident_bench.box_edge(2048) == 62.5
    assert resident_bench.box_edge(1_000_000) == 7.8125
    buf = io.StringIO()
    rb = resident_bench.run(CH=20, device="cpu", problem=box, out=buf)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 4
    for ln, pat in zip(lines, RB_LINES + RB_LINES[2:]):
        assert re.fullmatch(pat, ln), ln
    p, mesh, tables = box[:3]
    (u, up), _ = run_pallas_solver(
        build_plan(mesh), tables, None, np.zeros((60, 0, 3)), 60, p.delta_t,
        dtype=torch.float32, device="cpu", chunk=20, route="chunk",
        state=(rb["S0"],))
    assert torch.equal(rb["S"][0:3], u) and torch.equal(rb["S"][3:6], up)
    assert rb["S"][0:3].abs().max() > 0


AB_LINE = (r"\[([01])\] (\(default\)|HT_BKT_UNIFORM=0): (\d+) us/step  "
           r"([0-9.e+]+) eups  route torch_plain tier (-|uniform) "
           r"\(cpu, plain versions\)")


@pytest.mark.parametrize("damping,tier", [("rayleigh", None),
                                          ("bkt", "uniform")])
def test_perf_ab_states_match_the_step_route(damping, tier, monkeypatch):
    """perf_ab on the CPU at 2048 elements, 5 steps, configs "" and
    HT_BKT_UNIFORM=0: two rounds of lines that parse, one route and
    tier for both configs, the environment as before, and each config's
    final state (S, and the memory variables with BKT) equal bit for
    bit to run_pallas_solver's step route over the same 10 steps."""
    monkeypatch.setenv("HT_BKT_UNIFORM", "7")
    env = dict(os.environ)
    box = resident_bench.build(2048, damping)
    buf = io.StringIO()
    res = perf_ab.run(damping, 5, ["", "HT_BKT_UNIFORM=0"], device="cpu",
                      problem=box, out=buf)
    assert dict(os.environ) == env
    lines = buf.getvalue().splitlines()
    assert lines[0] == "# problem built: 2048 elems " + lines[0].split(
        "elems ")[1]
    rows = [re.fullmatch(AB_LINE, ln) for ln in lines[1:5]]
    assert all(rows), lines
    assert [(m.group(1), m.group(2)) for m in rows] == [
        ("0", "(default)"), ("0", "HT_BKT_UNIFORM=0"),
        ("1", "(default)"), ("1", "HT_BKT_UNIFORM=0")]
    assert lines[5] == "# best-of-2:" and len(lines) == 8
    assert {(r["route"], r["tier"]) for r in res.values()} == \
        {("torch_plain", tier)}
    p, mesh, tables = box[:3]
    plan = build_plan(mesh)
    for cfg, r in res.items():
        snap, _ = run_pallas_solver(
            plan, tables, None, np.zeros((10, 0, 3)), 10, p.delta_t,
            dtype=torch.float32, device="cpu", chunk=5, route="step",
            state=(r["S0"],))
        assert torch.equal(r["S"][0][0:3], snap[0]), cfg
        assert torch.equal(r["S"][0][3:6], snap[1]), cfg
        for a, b in zip(r["S"][1:], snap[2:]):
            assert torch.equal(a, b), cfg
        assert len(r["S"]) == (2 if tier else 1)


_CHILD = r'''
import sys
from hercules_tpu_torch.tools import perf_ab, resident_bench
assert resident_bench.main(["10", "--elems=2048", "--device=cpu"]) == 0
assert perf_ab.main(["bkt", "3", "", "--elems=2048", "--device=cpu"]) == 0
foreign = sorted(m for m in sys.modules if m in ("jax", "hercules_tpu")
                 or m.startswith(("jax.", "hercules_tpu.")))
assert not foreign, foreign
print("ok")
'''


def test_timing_tools_load_no_jax(tmp_path):
    """Both timing tools' command lines in one fresh process (the CPU,
    2048 elements) load no module of jax or of the JAX package."""
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=ROOT,
                                OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.splitlines()
    assert out[-1] == "ok"
    assert sum(ln.startswith("# 10 steps in") for ln in out) == 2
    assert sum(ln.startswith("[") for ln in out) == 2
