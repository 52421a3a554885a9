"""The port's NaN and overflow checker (``hercules_tpu_torch/utils/
debug.py``) against the JAX package's (``hercules_tpu/utils/debug.py``):
on the same arrays both raise, or do not, with the same message; the
port names the same node in every layout a route carries; its chunk
hook checks a ``Simulation.run`` on the CPU and composes with the
output taps' hook."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hercules_tpu.utils import debug as jdebug
from hercules_tpu_torch.fixtures import add_output_keys, write_box_case
from hercules_tpu_torch.sim import SimOutputs, Simulation
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.utils import debug


def _field(kind, dtype=np.float64):
    """[N, 3] with N = 2601 (fixture (a)'s nodes): finite, one NaN, an
    Inf and a NaN, or large."""
    rng = np.random.default_rng(16)
    u = (1e-3 * rng.standard_normal((2601, 3))).astype(dtype)
    if kind == "nan":
        u[1234, 2] = np.nan
    elif kind == "inf_nan":
        u[7, 0] = np.inf
        u[2600, 1] = np.nan
    elif kind == "many":
        u[3:40:3, 1] = np.nan
    elif kind == "large":
        u[99, 1] = -5.0
    return u


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except FloatingPointError as e:
        return f"FloatingPointError: {e}"


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("max_disp", [None, 1.0, 10.0])
@pytest.mark.parametrize("kind", ["finite", "nan", "inf_nan", "many",
                                  "large"])
def test_check_state_matches_jax(kind, max_disp, dtype):
    """check_state on the same [N, 3] field: the same return or the same
    FloatingPointError message (the offending nodes, or the overflow's
    peak), torch tensor against jax array."""
    u = _field(kind, dtype)
    got = _outcome(debug.check_state, (torch.as_tensor(u),),
                   where="after step 40", max_disp=max_disp)
    want = _outcome(jdebug.check_state, (jnp.asarray(u),),
                    where="after step 40", max_disp=max_disp)
    assert got == want
    assert (got is True) == (kind == "finite"
                             or (kind == "large" and max_disp != 1.0))


def test_layouts_name_the_same_node():
    """A NaN at node k is named k in the global [N, 3] field, in the
    route's component-major [3, X] rows, in the packed [8, X] state and
    in a list of per-brick tensors (the second part's column)."""
    u = _field("finite")
    k = 1234
    u[k, 1] = np.nan
    msg = f"non-finite displacement  at nodes [{k}]"
    cm = torch.as_tensor(u.T.copy())
    packed = torch.zeros((8, 2601), dtype=torch.float64)
    packed[0:3] = cm
    for state0 in (torch.as_tensor(u), cm, packed,
                   [torch.zeros((3, 100)), cm]):
        with pytest.raises(FloatingPointError) as e:
            debug.check_state((state0,))
        assert str(e.value) == msg


@pytest.mark.parametrize("every", [1, 2])
def test_chunk_checker_matches_jax(every):
    """make_chunk_checker fires every ``every`` chunks and calls the
    inner hook after it, as the JAX hook does; a bad field raises the
    same message from the same chunk."""
    good, bad = _field("finite"), _field("nan")
    calls = {"port": [], "jax": []}
    hooks = {"port": debug.make_chunk_checker(
                 every=every, inner=lambda d, s: calls["port"].append(d)),
             "jax": jdebug.make_chunk_checker(
                 every=every, inner=lambda d, s: calls["jax"].append(d))}
    conv = {"port": torch.as_tensor, "jax": jnp.asarray}
    out = {}
    for name, hook in hooks.items():
        res = []
        for done, u in ((10, good), (20, good), (30, bad), (40, bad)):
            res.append(_outcome(hook, done, (conv[name](u),)))
        out[name] = res
    assert out["port"] == out["jax"]
    assert calls["port"] == calls["jax"]


def test_checker_on_a_run_composes_with_the_taps(tmp_path):
    """Simulation.run on the CPU (fixture (a), 40 steps, chunks of 10)
    with the checker as on_chunk, inside the output taps' hook: it sees
    every chunk and the run's files are written; a NaN seeded into the
    same field at node k raises naming k (the route's column)."""
    paths = write_box_case(str(tmp_path), 62.5, 40, 2)
    add_output_keys(paths[1], paths[2], output_rate=10)
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    seen = []
    hook = debug.make_chunk_checker(
        max_disp=100.0, inner=lambda done, st: seen.append(done))
    state, _ = sim.run(device="cpu", chunk=10, on_chunk=hook,
                       rundir=str(tmp_path),
                       outputs=lambda: SimOutputs(sim.mesh, sim.params,
                                                  rundir=str(tmp_path)))
    assert seen == [10, 20, 30, 40]
    assert (tmp_path / "disp.h4d").stat().st_size > 0
    assert debug.check_state(state, max_disp=100.0)
    plan = build_plan(sim.mesh)
    col = int(np.flatnonzero(plan.gnid_cat == 1000)[0])
    u = state[0].clone()
    u[2, col] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=rf"after step 40 at nodes \[{col}\]"):
        debug.make_chunk_checker()(40, (u,) + tuple(state[1:]))
