"""End to end on the CPU: the port's CLI and Simulation against the JAX
package's, on the in-repo box case."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.sim import Simulation as JaxSimulation
from hercules_tpu_torch import cli
from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, SOFT_FREQ,
                                         TWO_LAYERS, four_q_freq,
                                         write_box_case)
from hercules_tpu_torch.sim import Simulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 100


def _read_stations(rundir, n):
    return [np.loadtxt(os.path.join(rundir, "stations", f"station.{i}"),
                       skiprows=1) for i in range(n)]


def _run_both_clis(tmp_path, **case):
    """Both CLIs (the port on the CPU, the JAX package with one CPU
    device) on the same box case; returns their run directories."""
    env = dict(os.environ, PYTHONPATH=ROOT, HT_PLATFORM="cpu")
    procs = []
    for name, cmd in (
            ("port", [sys.executable, "-m", "hercules_tpu_torch.cli",
                      "--device=cpu"]),
            ("jax", [sys.executable, "-m", "hercules_tpu.cli",
                     "--ndev=1"])):
        d = tmp_path / name
        paths = write_box_case(str(d), steps=STEPS, n_stations=2, **case)
        procs.append((d, subprocess.Popen(
            cmd + list(paths), cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for d, p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out[-3000:]
    (port_dir, _), (jax_dir, _) = procs
    assert "solver path: torch_plain" in \
        (port_dir / "monitor.txt").read_text()
    return port_dir, jax_dir


def test_cli_station_files_match_jax(tmp_path):
    """Both CLIs on the same case write station files equal to their
    printed precision (7 significant digits)."""
    port_dir, jax_dir = _run_both_clis(tmp_path)
    mine, ref = _read_stations(port_dir, 2), _read_stations(jax_dir, 2)
    for a, b in zip(mine, ref):
        assert a.shape == b.shape == (STEPS, 4)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        scale = np.abs(b[:, 1:]).max()
        assert scale > 0
        # one unit in the 7th significant digit of "% 8e"; the atol
        # (far below that digit of the largest value) covers values at
        # the wave front, where the float64 paths' 1e-13-of-max
        # differences exceed 1e-6 of the value itself
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=1e-6,
                                   atol=1e-12 * scale)


def test_bkt_cli_station_files_match_jax(tmp_path):
    """The BKT box (uniform Q) through both CLIs: station files equal to
    their printed precision, as in the elastic case."""
    port_dir, jax_dir = _run_both_clis(tmp_path, damping="bkt")
    mine, ref = _read_stations(port_dir, 2), _read_stations(jax_dir, 2)
    for a, b in zip(mine, ref):
        assert a.shape == b.shape == (STEPS, 4)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        scale = np.abs(b[:, 1:]).max()
        assert scale > 0
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=1e-6,
                                   atol=1e-12 * scale)


def test_bkt_simulation_samples_match_jax(tmp_path):
    """In memory, float64: the BKT box through Simulation.run on the CPU
    against the JAX package's brick route (corner-basis BKT), within
    2e-12 of the largest sample; the run returns the node conv too."""
    cvmdb, physics, numerical = write_box_case(str(tmp_path), steps=STEPS,
                                               n_stations=2, damping="bkt")
    sim = Simulation.setup(physics, numerical, cvmdb=cvmdb)
    (u, up, conv), samp = sim.run(device="cpu")
    assert sim.solver_path_name == "torch_plain"
    assert conv.shape == (6, u.shape[1]) and conv.abs().max() > 0
    jsim = JaxSimulation.setup(physics, numerical, cvmdb=cvmdb)
    _, jsamp = jsim.run(dtype=jnp.float64, solver="bricks", ndev=1)
    assert jsim.solver_path_name == "bricks"
    scale = np.abs(jsamp).max()
    assert samp.shape == jsamp.shape == (STEPS, 2, 3) and scale > 0
    np.testing.assert_allclose(samp, jsamp, rtol=0, atol=2e-12 * scale)


def _bkt_samples_match_jax(tmp_path, conv_rows, **case):
    """In memory, float64: a BKT case through Simulation.run on the CPU
    against the JAX package's brick route (corner-basis BKT), within
    2e-12 of the largest sample; conv_rows tells the tier (12: node,
    96: corner)."""
    cvmdb, physics, numerical = write_box_case(str(tmp_path), steps=STEPS,
                                               n_stations=2, damping="bkt",
                                               **case)
    sim = Simulation.setup(physics, numerical, cvmdb=cvmdb)
    (u, up, conv, *_), samp = sim.run(device="cpu")
    assert sim.solver_path_name == "torch_plain"
    assert conv.shape == (conv_rows, u.shape[1]) and conv.abs().max() > 0
    jsim = JaxSimulation.setup(physics, numerical, cvmdb=cvmdb)
    _, jsamp = jsim.run(dtype=jnp.float64, solver="bricks", ndev=1)
    assert jsim.solver_path_name == "bricks"
    scale = np.abs(jsamp).max()
    assert samp.shape == jsamp.shape == (STEPS, 2, 3) and scale > 0
    np.testing.assert_allclose(samp, jsamp, rtol=0, atol=2e-12 * scale)


def test_two_q_sets_raise_k3(tmp_path):
    """The two-layer box (two Q sets) runs on the general-Q node tier
    (K3's plain version and the mixed-element epilogue) and matches the
    JAX brick route."""
    _bkt_samples_match_jax(tmp_path, 12, layers=TWO_LAYERS, freq=SOFT_FREQ)


def test_four_q_sets_corner_tier_match_jax(tmp_path):
    """The four-layer box at 62.5 m (four Q sets, the node tier declines)
    runs on the corner tier (K4's plain version) and matches the JAX
    brick route."""
    _bkt_samples_match_jax(tmp_path, 96, layers=FOUR_Q_LAYERS,
                           freq=four_q_freq(62.5))


def test_simulation_samples_match_jax(tmp_path):
    """In memory, float64: Simulation.run on the CPU against the JAX
    package's brick route, within 2e-13 of the largest sample."""
    paths = write_box_case(str(tmp_path), steps=STEPS, n_stations=2)
    cvmdb, physics, numerical = paths
    sim = Simulation.setup(physics, numerical, cvmdb=cvmdb)
    _, samp = sim.run(device="cpu")
    assert sim.solver_path_name == "torch_plain"
    jsim = JaxSimulation.setup(physics, numerical, cvmdb=cvmdb)
    _, jsamp = jsim.run(dtype=jnp.float64, solver="bricks", ndev=1)
    assert jsim.solver_path_name == "bricks"
    scale = np.abs(jsamp).max()
    assert samp.shape == jsamp.shape == (STEPS, 2, 3) and scale > 0
    np.testing.assert_allclose(samp, jsamp, rtol=0, atol=2e-13 * scale)


def test_cli_without_cuda_exits_nonzero(tmp_path, monkeypatch, capsys):
    """The default device is CUDA; without one the CLI stops with a
    message instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = write_box_case(str(tmp_path), steps=2)
    assert cli.main(list(paths)) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "stations").exists()


@pytest.mark.parametrize("feature", ["nonlinear", "drm"])
def test_item7_features_set_up(tmp_path, feature):
    """Simulation.setup builds the nonlinear tables (elements with Vs
    under the cut, here every element of fixture (a)), or the DRM
    classification and part 0's coordinate and information files,
    equal to the JAX package's."""
    from hercules_tpu import drm as jax_drm
    from hercules_tpu_torch import drm
    from hercules_tpu_torch.fixtures import add_drm_keys, add_nonlinear_keys
    cvmdb, physics, numerical = write_box_case(str(tmp_path), steps=2)
    ddir = str(tmp_path / "drm")
    if feature == "nonlinear":
        add_nonlinear_keys(numerical, 4000.0)
    else:
        add_drm_keys(numerical, ddir, "part0", 0.001)
    sim = Simulation.setup(physics, numerical, cvmdb=cvmdb)
    jsim = JaxSimulation.setup(physics, numerical, cvmdb=cvmdb)
    if feature == "nonlinear":
        assert sim.nl_tables.n == sim.mesh.lenum == 2048
        for k in ("eidx", "mu", "lam", "alpha", "k", "hard", "h"):
            np.testing.assert_array_equal(getattr(sim.nl_tables, k),
                                          getattr(jsim.nl_tables, k))
        return
    plan = sim.drm_plan
    assert plan.cfg.part == "part0" and len(plan.elem_idx) > 0
    for k in ("elem_idx", "mask_b", "node_ids", "node_coords"):
        np.testing.assert_array_equal(getattr(plan, k),
                                      getattr(jsim.drm_plan, k))
    np.testing.assert_array_equal(drm.read_coords(ddir),
                                  jax_drm.read_coords(ddir))
    with open(os.path.join(ddir, "drm_information")) as f:
        assert f"drm_numberofelements = {len(plan.elem_idx)}" in f.read()
