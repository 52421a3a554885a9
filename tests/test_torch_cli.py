"""The port's CLI writes the optional outputs the JAX CLI writes
(hercules_tpu/cli.py:124-180): on the BKT box at 62.5 m, both CLIs on
the CPU with one key set at a time; the K matrices and the schedule
statistics on stdout, the schedule file, the monitor's damping
statistics and the MATLAB mesh files are equal (timings excluded).
It routes and names as the JAX CLI does what the kernels do not run: a
damping name they do not know (run undamped) and the conventional
stiffness key; and it writes the JAX CLI's IO_PES line."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from hercules_tpu_torch.fixtures import write_box_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the lines each case appends to numerical.in
KEYS = {
    "print_matrix_k": "print_matrix_k = yes",
    "schedule": "schedule_print_file = 1\nschedule_print_stdout = 1\n"
                "schedule_print_error_check = 1",
    "damping_statistics": "do_damping_statistics = 1",
    "matlab": "mesh_coordinates_for_matlab = yes",
}


def _run_both(tmp_path, keys, damping="bkt", steps=2, **env_extra):
    """Both CLIs (the port with --device=cpu, the JAX package on one CPU
    device) on the box with ``damping`` and ``keys``, ``env_extra`` in
    their environment; returns {name: (run directory, stdout)}."""
    # one OpenMP thread per CLI: the parallel test workers share the
    # cores, and small ops on several threads run far slower there
    env = dict(os.environ, PYTHONPATH=ROOT, HT_PLATFORM="cpu",
               OMP_NUM_THREADS="1", **env_extra)
    procs = {}
    for name, cmd in (
            ("port", [sys.executable, "-m", "hercules_tpu_torch.cli",
                      "--device=cpu"]),
            ("jax", [sys.executable, "-m", "hercules_tpu.cli", "--ndev=1"])):
        d = tmp_path / name
        paths = write_box_case(str(d), 62.5, steps, 2, damping=damping)
        with open(paths[2], "a") as f:
            f.write(f"\n{keys}\n")
        procs[name] = (d, subprocess.Popen(
            cmd + list(paths), cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    runs = {}
    for name, (d, p) in procs.items():
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out[-3000:]
        runs[name] = (d, out)
    return runs


def _section(text, start, end):
    """The text from the first ``start`` up to the next ``end``
    (a regular expression); fails if there is none."""
    m = re.search(re.escape(start) + ".*?(?=" + end + ")", text, re.S)
    assert m, f"no {start!r} section"
    return m.group(0)


@pytest.mark.parametrize("case", sorted(KEYS))
def test_cli_optional_outputs_match_jax(tmp_path, case):
    runs = _run_both(tmp_path, KEYS[case])
    (pdir, pout), (jdir, jout) = runs["port"], runs["jax"]
    if case == "print_matrix_k":
        # K1, K2, K3: a header and 24 rows each
        k = re.search(r"# K1 \[8\]\[8\]\[3\]\[3\]\n(?:[^\n]*\n){24}\n"
                      r"# K2 .*?\n(?:[^\n]*\n){24}\n# K3 .*?\n"
                      r"(?:[^\n]*\n){24}", jout)
        assert k and k.group(0) in pout
    elif case == "schedule":
        got = _section(pout, "# Exchange-plan statistics", "error check")
        assert got == _section(jout, "# Exchange-plan statistics",
                               "error check")
        assert "bricks:                     1" in got
        assert "error check: OK" in pout
        assert (pdir / "stat-sched.txt").read_bytes() == \
            (jdir / "stat-sched.txt").read_bytes()
    elif case == "damping_statistics":
        mons = [(d / "monitor.txt").read_text() for d in (pdir, jdir)]
        got, want = (_section(m, " Critical delta t related information",
                              "solver_run") for m in mons)
        assert got == want
        assert "# xi histogram (40 intervals)" in got
        assert "13. The maximum Vs" in got
    else:
        for f in ("mesh_coordinates.0", "mesh_data.0"):
            mine = (pdir / "matlab" / f).read_bytes()
            assert mine and mine == (jdir / "matlab" / f).read_bytes(), f
        assert "matlab mesh coordinates written" in \
            (pdir / "monitor.txt").read_text()
        assert "(2048 elements)" in pout and "(2048 elements)" in jout


def _stations(rundir):
    return [np.loadtxt(rundir / "stations" / f"station.{i}", skiprows=1)
            for i in range(2)]


def test_cli_unknown_damping_runs_as_jax(tmp_path):
    """type_of_damping = kelvin (no damping the kernels run): both CLIs
    run it undamped on the plain brick solver, name the route "bricks",
    and write station files equal to their printed precision (as
    tests/test_torch_sim.py holds the kernel route's)."""
    runs = _run_both(tmp_path, "", damping="kelvin", steps=40)
    (pdir, _), (jdir, _) = runs["port"], runs["jax"]
    for d in (pdir, jdir):
        assert "solver path: bricks" in (d / "monitor.txt").read_text()
    for a, b in zip(_stations(pdir), _stations(jdir)):
        assert a.shape == b.shape == (40, 4)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        scale = np.abs(b[:, 1:]).max()
        assert scale > 0
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=1e-6,
                                   atol=1e-12 * scale)


def test_cli_conventional_stiffness_names_bricks(tmp_path):
    runs = _run_both(tmp_path, "stiffness_calculation_method = "
                               "conventional", damping="rayleigh")
    for d, _ in runs.values():
        assert "solver path: bricks" in (d / "monitor.txt").read_text()


def test_cli_io_pes_line(tmp_path):
    """With IO_PES set, both monitors carry the same line."""
    runs = _run_both(tmp_path, "", IO_PES="2")
    lines = [[ln for ln in (d / "monitor.txt").read_text().splitlines()
              if ln.startswith("IO_PES")] for d, _ in runs.values()]
    assert lines[0] == lines[1] and len(lines[0]) == 1
