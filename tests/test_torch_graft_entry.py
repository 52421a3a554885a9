"""The port's entry points in ``hercules_tpu_torch/graft_entry.py``
on the CPU: ``entry``'s step in float64 against the JAX package's
``solver/step.py:make_step`` on the same mesh and tables (within 2e-13
of max|u|, the bound of tests/test_pallas.py:56); every leg of
``dryrun_multichip(4, device="cpu", dtype=torch.float64)`` runs, and the
stations of legs 1-3 are within 1e-12 of max|u| of the single-device
port runs of the same cases; both entry points default to the card."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.solver.step import init_state as jax_init_state
from hercules_tpu.solver.step import make_step as jax_make_step
from hercules_tpu_torch import graft_entry
from hercules_tpu_torch.config import load_params
from hercules_tpu_torch.cvm import CVM
from hercules_tpu_torch.fixtures import one_torch_thread
from hercules_tpu_torch.sim import Simulation
from hercules_tpu_torch.solver.assemble import assemble
from hercules_tpu_torch.solver.step import run_solver

_one_torch_thread = one_torch_thread()


def _close(got, want, bound, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert got.shape == want.shape and scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=bound * scale,
                               err_msg=what)


def test_entry_step_matches_jax(tmp_path):
    """Three applications of entry's fn (float64, the CPU) against the
    JAX package's make_step on fixture (a)'s tables with the same source
    node and unit force: u and u- within 2e-13 of max|u|."""
    fn, (u, up, srcf) = graft_entry.entry(device="cpu", dtype=torch.float64)
    assert u.dtype == torch.float64 and tuple(srcf.shape) == (1, 3)
    p, mesh, tables = graft_entry._simple_setup(str(tmp_path))
    assert (mesh.lenum, mesh.nnum) == (2048, 2601)
    nid = int(mesh.elem_lnid[mesh.lenum // 2, 0])
    step, _ = jax_make_step(tables, np.array([nid], np.int32),
                            dtype=jnp.float64)
    ju, jup, conv = jax_init_state(tables, jnp.float64)
    jsrc = jnp.ones((1, 3), jnp.float64)
    for _ in range(3):
        u, up = fn(u, up, srcf)
        (ju, jup, conv), _ = step((ju, jup, conv),
                                  (jsrc, jnp.zeros((), jnp.int32)))
    _close(u.numpy(), np.asarray(ju), 2e-13, "u")
    _close(up.numpy(), np.asarray(jup), 2e-13, "u-")
    assert np.count_nonzero(np.abs(u.numpy()).sum(1)) > 1


@pytest.fixture(scope="module")
def dryrun():
    return graft_entry.dryrun_multichip(4, device="cpu",
                                        dtype=torch.float64)


def test_dryrun_legs_run(dryrun):
    """Every leg ran on the path the JAX dry run names, on 4 CPU ranks
    (the graded legs at min(8, 4)), and launched no kernel."""
    paths = {k: v["path"] for k, v in dryrun.items()}
    assert paths == {"1 slab": "slab", "1 sharded": "sharded",
                     "1 restart": "slab", "2 gslab": "gslab",
                     "3 gmesh": "gmesh", "4 gmesh bkt": "gmesh",
                     "5 sharded nonlinear": "sharded",
                     "6 gmesh nonlinear": "gmesh",
                     "7 sharded drm": "sharded"}
    assert all(v["ranks"] == 4 and v["launches"] == {}
               for v in dryrun.values())
    assert dryrun["1 restart"]["steps"] == 20
    assert dryrun["2 gslab"]["elements"] == 59392
    assert dryrun["6 gmesh nonlinear"]["elements"] == 73728


def test_dryrun_slab_and_sharded_match_one_device(dryrun, tmp_path):
    """Leg 1's stations on the slab and sharded paths against
    Simulation.run on one CPU device, float64, on the same case."""
    paths = graft_entry._box(str(tmp_path))
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    _, samples = sim.run(device="cpu", dtype=torch.float64)
    assert samples.shape == (40, 3, 3)
    for leg in ("1 slab", "1 sharded"):
        _close(dryrun[leg]["samples"], samples, 1e-12, leg)


@pytest.mark.parametrize("leg,kind", [("2 gslab", "depth"),
                                      ("3 gmesh", "lateral")])
def test_dryrun_graded_legs_match_one_device(dryrun, tmp_path, leg, kind):
    """Legs 2 and 3's stations against the unstructured solver on one
    CPU device, float64, on the same graded mesh, source and stations."""
    paths = graft_entry._box(str(tmp_path))
    p = load_params(paths[1], paths[2])
    mesh = graft_entry.graded_mesh(kind, p, CVM(paths[0]))
    assert mesh.lenum == dryrun[leg]["elements"]
    sids, forces, st_nodes, st_phi = graft_entry.leg_sources(mesh)
    _, samples = run_solver(assemble(mesh, p), sids, forces,
                            graft_entry.GRADED_STEPS, p.delta_t,
                            st_nodes=st_nodes, st_phi=st_phi,
                            dtype=torch.float64, device="cpu")
    _close(dryrun[leg]["samples"], samples, 1e-12, leg)


@pytest.mark.parametrize("fn", ["entry", "dryrun_multichip"])
def test_entry_points_default_to_cuda(fn, monkeypatch):
    """Both entry points take the card unless asked for the CPU, and
    raise without one."""
    f = getattr(graft_entry, fn)
    default = inspect.signature(f).parameters["device"].default
    assert default in ("cuda", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        f() if fn == "entry" else f(2)
