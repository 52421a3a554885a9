"""Output taps, checkpoints and restart on the port (``SimOutputs``,
``read_restart``, ``solver/restart.py``, ``fused_brick.restore_packed_state``,
``fused_mesh.restore_mesh_state``), on the CPU:

- the port's CLI writes the JAX CLI's 4-D volume, plane, checkpoint and
  station files on the elastic and the BKT box (float64);
- N steps, a checkpoint, a restart and M more steps land bit for bit
  where N + M straight steps land, on every route's plain versions
  (bfloat16 memory variables in the float32 cases), with the 4-D and
  plane files of the resumed run equal to the straight run's;
- the basis conversions and the fitters equal the JAX package's;
- a checkpoint of the JAX package's Pallas route resumes in the port,
  and one of its unstructured solver on the port's unstructured route;
- the unstructured route restarts bit for bit, and writes the JAX
  package's files;
- a checkpoint of other physics or of a foreign layout raises."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, GRADED_LAYERS,
                                         GRADED_Q_LAYERS, SOFT_FREQ,
                                         SOFT_LAYERS, TWO_LAYERS,
                                         add_output_keys, four_q_freq,
                                         one_torch_thread, write_box_case)
from hercules_tpu_torch.io.checkpoint import checkpoint_read
from hercules_tpu_torch.io.output4d import read_4d
from hercules_tpu_torch.sim import SimOutputs, Simulation
from hercules_tpu_torch.solver import restart
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.fused_brick import (PallasBrickTables,
                                                   pallas_u_global,
                                                   restore_packed_state)
from hercules_tpu_torch.solver.fused_mesh import (MeshPallasTables,
                                                  mesh_u_global,
                                                  restore_mesh_state)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (edge m, write_box_case keywords, the route's tiers) of every route's
# case: elastic; uniform BKT shear-only and with the bulk attenuation
# (bfloat16 in float32); the node tier (271 mixed elements); the corner
# tier; the mesh route with 1,024 loose elements (uniform bricks), and
# with a corner-tier brick
CASES = {
    "box": (62.5, {}, ("elastic",)),
    "bkt": (62.5, dict(damping="bkt"), ("uniform",)),
    "soft": (62.5, dict(damping="bkt", layers=SOFT_LAYERS, freq=SOFT_FREQ),
             ("uniform",)),
    "two": (62.5, dict(damping="bkt", layers=TWO_LAYERS, freq=SOFT_FREQ),
            ("node",)),
    "four_q": (62.5, dict(damping="bkt", layers=FOUR_Q_LAYERS,
                          freq=four_q_freq(62.5)), ("corner",)),
    "graded15": (15.625, dict(damping="bkt", layers=GRADED_LAYERS,
                              freq=four_q_freq(15.625)),
                 ("uniform", "uniform")),
    "graded_q62": (62.5, dict(damping="bkt", layers=GRADED_Q_LAYERS,
                              freq=four_q_freq(62.5)),
                   ("corner", "uniform", "uniform")),
}
N, M = 10, 10         # steps before and after the checkpoint


_one_torch_thread = one_torch_thread()


def _case(root, name, steps=N + M, **rates):
    edge, kw, _ = CASES[name]
    paths = write_box_case(str(root), edge, steps, 2, **kw)
    add_output_keys(paths[1], paths[2], **rates)
    return paths


def _run(paths, dtype, **kw):
    """Simulation.run on the CPU with the case's outputs on (``kw``:
    run's keywords, ``solver`` among them); returns (sim, state,
    samples)."""
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    rundir = os.path.dirname(os.path.dirname(paths[1]))
    out = SimOutputs(sim.mesh, sim.params, rundir=rundir)
    state, samples = sim.run(device="cpu", dtype=dtype, outputs=out,
                             rundir=rundir, **kw)
    return sim, state, samples


def _parts(state):
    """Every tensor of a route's state (nested tuples, Nones dropped),
    flat."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for part in state for x in _parts(part)]
    return [state]


def _resume(root, name, dtype, **kw):
    """Run A (N + M steps, checkpoints every N) and run B (A's step-N
    checkpoint as checkpoint.in, in a copy of the case), both with run's
    keywords ``kw``: (A, B, their directories)."""
    a_dir, b_dir = root / "a", root / "b"
    paths = _case(a_dir, name, output_rate=5, planes_rate=2,
                  checkpointing_rate=N)
    run_a = _run(paths, dtype, **kw)
    shutil.copytree(a_dir / "in", b_dir / "in")
    shutil.copy(paths[0], b_dir / "box.e")
    (b_dir / "checkpoints").mkdir()
    ck = a_dir / "checkpoints"
    step_of = {f: checkpoint_read(str(ck / f))[0]
               for f in ("checkpoint.out0", "checkpoint.out1")}
    first = min(step_of, key=step_of.get)
    assert sorted(step_of.values()) == [N, N + M]
    shutil.copy(ck / first, b_dir / "checkpoints" / "checkpoint.in")
    bp = [str(b_dir / os.path.relpath(p, a_dir)) for p in paths]
    run_b = _run(bp, dtype, **kw)
    return run_a, run_b, a_dir, b_dir


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_restart_is_bit_exact(tmp_path, name, dtype):
    (sim_a, st_a, smp_a), (sim_b, st_b, smp_b), a_dir, b_dir = _resume(
        tmp_path, name, getattr(torch, dtype))
    assert sim_a.start_step == 0 and sim_b.start_step == N
    assert sim_b.solver_path_name == sim_a.solver_path_name == "torch_plain"
    pa, pb = _parts(st_a), _parts(st_b)
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert np.array_equal(smp_b, smp_a[N:]) and np.abs(smp_a).max() > 0
    # the route's tiers, and bfloat16 memory variables in float32 where
    # the bulk attenuation is on
    plan = build_plan(sim_a.mesh)
    want = CASES[name][2]
    if len(want) == 1 and not len(plan.loose_eidx) and len(plan.bricks) == 1:
        pt = PallasBrickTables(plan, sim_a.tables, dtype=pa[0].dtype,
                               device="cpu")
        assert (pt.bkt_tier or "elastic") == want[0]
    else:
        mt = MeshPallasTables(plan, sim_a.tables, dtype=pa[0].dtype,
                              device="cpu")
        assert tuple(mt.tiers) == want
    if name == "graded15":
        assert len(plan.loose_eidx) == 1024 and len(st_a[2]) == 4
    if dtype == "float32" and name in ("soft", "two", "four_q",
                                       "graded_q62"):
        assert torch.bfloat16 in {x.dtype for x in pa}
    # the resumed run's 4-D frames and plane records after step N equal
    # the straight run's; its file holds no earlier frame (the JAX
    # package's semantics: a restart taps from its first chunk's end)
    for f in ("disp.h4d", "vel.h4d"):
        _, da = read_4d(str(a_dir / f))
        _, db = read_4d(str(b_dir / f))
        assert np.array_equal(da[N // 5 + 1:], db[N // 5 + 1:])
        assert not db[:N // 5 + 1].any() and da[1:].any()
    pa_ = np.fromfile(a_dir / "planes" / "planedisplacements.0")
    pb_ = np.fromfile(b_dir / "planes" / "planedisplacements.0")
    rec = 17 * 17 * 3
    assert len(pa_) == (N + M) // 2 * rec
    assert len(pb_) == (M // 2 - 1) * rec
    assert np.array_equal(pa_[(N // 2 + 1) * rec:], pb_)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,solver", [("box", "unstructured"),
                                         ("soft", "unstructured"),
                                         ("graded15", "unstructured"),
                                         ("bkt", "bricks"),
                                         ("graded15", "bricks")])
def test_plain_route_restart_is_bit_exact(tmp_path, name, solver, dtype):
    """The unstructured solver (global state: elastic, BKT with the bulk
    attenuation, the graded box's 3,936 dangling nodes) and the plain
    brick solver (BKT memory variables per brick and for the 1,024 loose
    elements): N steps, a checkpoint, a restart and M more steps land
    bit for bit where N + M straight steps land, and so do the 4-D
    frames and plane records after step N."""
    (sim_a, st_a, smp_a), (sim_b, st_b, smp_b), a_dir, b_dir = _resume(
        tmp_path, name, getattr(torch, dtype), solver=solver)
    assert sim_a.solver_path_name == sim_b.solver_path_name == solver
    assert sim_b.start_step == N
    pa, pb = _parts(st_a), _parts(st_b)
    # u, u-, and four memory-variable arrays: one set on the global
    # state, one per brick and one for the loose elements on the bricks
    n_conv = {("box", "unstructured"): 0, ("graded15", "bricks"): 3}.get(
        (name, solver), 1)
    assert len(pa) == len(pb) == 2 + 4 * n_conv
    for x, y in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert np.array_equal(smp_b, smp_a[N:]) and np.abs(smp_a).max() > 0
    ck = checkpoint_read(str(b_dir / "checkpoints" / "checkpoint.in"))
    if solver == "unstructured":
        assert ck[1].shape == (sim_a.mesh.nnum, 3)
        assert [c.shape for c in ck[3]] == (
            [] if name == "box" else [(sim_a.mesh.lenum, 8, 3)] * 4)
    for f in ("disp.h4d", "vel.h4d"):
        _, da = read_4d(str(a_dir / f))
        _, db = read_4d(str(b_dir / f))
        assert np.array_equal(da[N // 5 + 1:], db[N // 5 + 1:])
        assert da[1:].any()
    pa_ = np.fromfile(a_dir / "planes" / "planedisplacements.0")
    pb_ = np.fromfile(b_dir / "planes" / "planedisplacements.0")
    rec = 17 * 17 * 3
    assert np.array_equal(pa_[(N // 2 + 1) * rec:], pb_)


@pytest.mark.parametrize("name", ["box", "two", "graded15"])
def test_taps_hold_the_state(tmp_path, name):
    """The last displacement frame is the state a straight run of that
    many steps returns, the velocity frame (u - u-)/dt of it, and each
    plane record the phi-weighted corner sum of that frame."""
    paths = _case(tmp_path, name, output_rate=5, planes_rate=5,
                  checkpointing_rate=N)
    sim, _, _ = _run(paths, torch.float64)
    plan = build_plan(sim.mesh)
    T = N + M - 5                           # the last frame's step
    state, _ = Simulation.setup(paths[1], paths[2],
                                cvmdb=paths[0]).run(device="cpu",
                                                    total_steps=T)
    Nn = sim.mesh.nnum
    if isinstance(state[0], tuple):
        u = mesh_u_global(plan, [S[0:3] for S in state[0]], Nn)
        up = mesh_u_global(plan, [S[3:6] for S in state[0]], Nn)
    else:
        u = pallas_u_global(plan, state[0], Nn)
        up = pallas_u_global(plan, state[1], Nn)
    hd, disp = read_4d(str(tmp_path / "disp.h4d"))
    _, vel = read_4d(str(tmp_path / "vel.h4d"))
    assert int(hd["output_steps"]) == disp.shape[0] == (N + M) // 5
    assert np.array_equal(disp[-1], u) and np.abs(u).max() > 0
    assert np.array_equal(vel[-1], (u - up) / sim.params.delta_t)
    planes = sim_planes(sim, tmp_path)
    got = np.fromfile(tmp_path / "planes" / "planedisplacements.0")
    got = got.reshape(-1, 17 * 17, 3)
    for k in range(disp.shape[0]):
        want = np.einsum("mk,mkc->mc", planes.all_phi,
                         disp[k][planes.all_nodes])
        np.testing.assert_allclose(got[k], want, rtol=0,
                                   atol=1e-12 * max(np.abs(want).max(),
                                                    1e-300))


def sim_planes(sim, root):
    """The run's PlaneSet tables (a second writer, into a scratch
    directory)."""
    from hercules_tpu_torch.io.planes import PlaneSet
    ps = PlaneSet(sim.mesh, sim.params, str(root / "planes_tables"))
    ps.close()
    return ps


@pytest.mark.parametrize("name", ["box", "two", "graded15"])
def test_plane_gather_matches_global_field(tmp_path, name):
    """A plane record at a step where no 4-D frame or checkpoint is due
    (its corner nodes gathered alone) equals, bit for bit, the record
    of a run that makes the global field at every plane step."""
    recs = {}
    for rate in (2, 5):
        d = tmp_path / f"rate{rate}"
        paths = _case(d, name, output_rate=rate, planes_rate=2)
        _run(paths, torch.float64)
        recs[rate] = np.fromfile(d / "planes" / "planedisplacements.0")
    assert recs[2].size == (N + M) // 2 * 17 * 17 * 3
    assert np.array_equal(recs[2], recs[5]) and np.abs(recs[2]).max() > 0


def test_refused_checkpoint_touches_no_output(tmp_path):
    """The CLI checks checkpoint.in before it opens any output file: a
    checkpoint of other damping exits non-zero and leaves the earlier
    run's 4-D files as they were."""
    paths = _case(tmp_path, "box", output_rate=5, checkpointing_rate=N)
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "hercules_tpu_torch.cli", "--device=cpu",
           *paths]
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    _checkpoint_in(tmp_path, N)
    before = {f: (tmp_path / f).read_bytes() for f in ("disp.h4d",
                                                       "vel.h4d")}
    with open(paths[1]) as f:
        text = f.read()
    with open(paths[1], "w") as f:
        f.write(text.replace("type_of_damping             = rayleigh",
                             "type_of_damping             = mass"))
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode != 0
    assert "damping=rayleigh" in run.stdout + run.stderr
    for f, data in before.items():
        assert (tmp_path / f).read_bytes() == data and len(data) > 0


# ---- files against the JAX CLI ------------------------------------------

@pytest.mark.parametrize("damping", ["rayleigh", "bkt"])
def test_cli_files_match_jax(tmp_path, damping):
    """Both CLIs on the CPU, float64, 4-D displacement and velocity,
    one plane, checkpoints: headers equal but for generation_date, data
    within 2e-13 of its max, checkpoint fields (as global [N, 3])
    within 2e-13, station files equal."""
    import jax.numpy as jnp
    from hercules_tpu.solver.pallas_brick import _fit_field_cm

    env = dict(os.environ, PYTHONPATH=ROOT, HT_PLATFORM="cpu")
    procs = {}
    for name, cmd in (
            ("port", [sys.executable, "-m", "hercules_tpu_torch.cli",
                      "--device=cpu"]),
            ("jax", [sys.executable, "-m", "hercules_tpu.cli", "--ndev=1"])):
        d = tmp_path / name
        paths = write_box_case(str(d), 62.5, N + M, 2, damping=damping)
        add_output_keys(paths[1], paths[2], output_rate=4, planes_rate=2,
                        checkpointing_rate=N)
        procs[name] = (d, paths, subprocess.Popen(
            cmd + list(paths), cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, (d, _, p) in procs.items():
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out[-3000:]
    P, J = procs["port"][0], procs["jax"][0]

    def close(a, b):
        scale = np.abs(b).max()
        assert a.shape == b.shape and scale > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-13 * scale)

    for f in ("disp.h4d", "vel.h4d"):
        hp, dp = read_4d(str(P / f))
        hj, dj = read_4d(str(J / f))
        for k in hp.dtype.names:
            if k != "generation_date":
                assert np.array_equal(hp[k], hj[k]), k
        close(dp, dj)
    for f in ("planedisplacements.0", "planecoords.0"):
        assert (P / "planes" / f).exists()
    close(np.fromfile(P / "planes" / "planedisplacements.0"),
          np.fromfile(J / "planes" / "planedisplacements.0"))
    assert (P / "planes" / "planecoords.0").read_bytes() == \
        (J / "planes" / "planecoords.0").read_bytes()
    sim = Simulation.setup(*procs["port"][1][1:], cvmdb=procs["port"][1][0])
    plan = build_plan(sim.mesh)
    for k in (0, 1):
        ckp = checkpoint_read(str(P / "checkpoints" / f"checkpoint.out{k}"))
        ckj = checkpoint_read(str(J / "checkpoints" / f"checkpoint.out{k}"))
        assert ckp[0] == ckj[0] and ckp[4].keys() == ckj[4].keys()
        for a, b in zip(ckp[1:3], ckj[1:3]):
            ga, gb = (pallas_u_global(plan, np.array(_fit_field_cm(
                plan, x, plan.bricks[0].nb, jnp.float64)), sim.mesh.nnum)
                for x in (a, b))
            close(ga, gb)
    for i in (0, 1):
        f = f"stations/station.{i}"
        assert (P / f).read_bytes() == (J / f).read_bytes()


# ---- conversions and fitters against the JAX package's -----------------

class _Twin:
    """A case set up by both packages: the port's Simulation and plan,
    the JAX package's, and a seeded generator."""

    def __init__(self, root, name):
        from hercules_tpu.sim import Simulation as JaxSimulation
        from hercules_tpu.solver.bricks import build_plan as jax_build_plan
        self.paths = _case(root, name)
        cv, ph, nu = self.paths
        self.sim = Simulation.setup(ph, nu, cvmdb=cv)
        self.plan = build_plan(self.sim.mesh)
        self.jsim = JaxSimulation.setup(ph, nu, cvmdb=cv)
        self.jplan = jax_build_plan(self.jsim.mesh)
        self.rng = np.random.default_rng(20261017)

    def pt(self):
        return PallasBrickTables(self.plan, self.sim.tables,
                                 dtype=torch.float64, device="cpu")

    def jpt(self):
        import jax.numpy as jnp
        from hercules_tpu.solver.pallas_brick import PallasBrickTables as J
        return J(self.jplan, self.jsim.tables, dtype=jnp.float64)

    def cols(self, rows, LEN, ncols):
        """[rows, LEN] with random values in the first ncols columns."""
        x = np.zeros((rows, LEN))
        x[:, :ncols] = self.rng.standard_normal((rows, ncols))
        return x


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            made[name] = _Twin(tmp_path_factory.mktemp(name), name)
        return made[name]

    return get


CONVERSIONS = ("conv_corner_to_node", "conv_node_to_corner",
               "conv_corner_to_nodeq", "conv_mix_of_corner",
               "conv_nodeq_to_corner")


@pytest.mark.parametrize("fn", CONVERSIONS)
def test_conversion_matches_jax(twins, fn):
    """Each basis conversion on random arrays, with the corner-tier
    brick's node assignment (96 rows: the bulk attenuation on), equals
    the JAX package's."""
    from hercules_tpu.solver import pallas_brick as jpb
    tw = twins("four_q")
    step = tw.pt().step
    LEN, nb = step.K.shape[1], tw.plan.bricks[0].nb
    assert step.tier == "corner" and len(step.mixed_cols)
    corner = tw.cols(96, LEN, nb) * step.evalid
    node = tw.cols(12, LEN, nb)
    mix = tw.rng.standard_normal((12, 8, len(step.mixed_cols)))
    args = {"conv_corner_to_node": (step.offs, step.evalid, corner),
            "conv_node_to_corner": (step.offs, step.evalid, node, 96),
            "conv_corner_to_nodeq": (step.offs, step.node_src, corner),
            "conv_mix_of_corner": (step.offs, step.mixed_cols, corner),
            "conv_nodeq_to_corner": (step.offs, step.evalid,
                                     step.mixed_cols, node, mix, 96)}[fn]
    got = getattr(restart, fn)(*args)
    want = getattr(jpb, fn)(*args)
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def _jax_node_rows(a, R2, LEN_j):
    """A port node-basis array [R2, LEN] in the JAX layout [8 | 16,
    LEN_j] (padding rows zero)."""
    out = np.zeros((R2 + R2 // 3, LEN_j))
    w = min(a.shape[1], LEN_j)
    out[:R2, :w] = a[:, :w]
    return out


@pytest.mark.parametrize("name,basis", [("bkt", "node"), ("bkt", "corner"),
                                        ("soft", "node"),
                                        ("soft", "corner")])
def test_fit_conv_node_matches_jax(twins, name, basis):
    """The uniform tier's fitter (the port's [6 | 12, LEN]) against the
    JAX package's _fit_conv_node ([8 | 16, LEN_jax]) on a random
    checkpoint array of either basis."""
    from hercules_tpu.solver.pallas_brick import _fit_conv_node
    tw = twins(name)
    pt, jpt = tw.pt(), tw.jpt()
    nb, R2 = tw.plan.bricks[0].nb, pt.step.conv_rows
    assert pt.step.tier == "uniform" and jpt.bkt_uniform
    if basis == "node":
        cv = _jax_node_rows(tw.cols(R2, nb, nb), R2, jpt.LEN)
    else:
        cv = tw.cols(8 * R2, jpt.LEN, nb) * jpt.evalid
    (got,) = restart.fit_conv(pt.step, pt.LEN, (cv,))
    want = np.asarray(_fit_conv_node(jpt, cv), np.float64)
    assert got.shape == (R2, pt.LEN) and np.abs(want).max() > 0
    np.testing.assert_allclose(got[:, :nb], want[:R2, :nb], rtol=0,
                               atol=1e-15)
    assert not got[:, nb:].any()


@pytest.mark.parametrize("basis", ["node", "corner"])
def test_fit_conv_corner_matches_jax(twins, basis):
    """The corner tier's fitter against _fit_conv_corner: a node-basis
    checkpoint with its mixed elements' state, or a corner one."""
    from hercules_tpu.solver.pallas_brick import _fit_conv_corner
    tw = twins("four_q")
    pt, jpt = tw.pt(), tw.jpt()
    nb, R = tw.plan.bricks[0].nb, pt.step.conv_rows
    assert pt.step.tier == "corner" and not jpt.bkt_nodeq
    np.testing.assert_array_equal(pt.step.mixed_cols, jpt.bkn_mixed_cols)
    mix = None
    if basis == "node":
        cv = _jax_node_rows(tw.cols(R // 8, nb, nb), R // 8, jpt.LEN)
        mix = tw.rng.standard_normal((R // 8, 8, len(jpt.bkn_mixed_cols)))
    else:
        cv = tw.cols(R, jpt.LEN, nb) * jpt.evalid
    (got,) = restart.fit_conv(pt.step, pt.LEN,
                              (cv,) + (() if mix is None else (mix,)))
    want = np.asarray(_fit_conv_corner(jpt, cv, mix=mix), np.float64)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got[:, :nb], want[:, :nb], rtol=0,
                               atol=1e-15)
    assert not got[:, nb:].any()


@pytest.mark.parametrize("form", ["pair", "corner", "bare"])
def test_fit_conv_nodeq_matches_jax(twins, form):
    """The node tier's fitter against _fit_conv_nodeq: its own (node,
    mix) pair, a corner-basis array, a bare node-basis array."""
    from hercules_tpu.solver.pallas_brick import _fit_conv_nodeq
    tw = twins("two")
    pt, jpt = tw.pt(), tw.jpt()
    step = pt.step
    nb, R2, Mm = tw.plan.bricks[0].nb, step.conv_rows, step.mix_M
    assert step.tier == "node" and jpt.bkt_nodeq and Mm == jpt.mix_M > 0
    np.testing.assert_array_equal(step.mixed_cols, jpt.bkn_mixed_cols)
    if form == "corner":
        parts = (tw.cols(8 * R2, jpt.LEN, nb) * jpt.evalid,)
    else:
        parts = (_jax_node_rows(tw.cols(R2, nb, nb), R2, jpt.LEN),)
        if form == "pair":
            parts += (tw.rng.standard_normal((R2, 8, Mm)),)
    got = restart.fit_conv(step, pt.LEN, parts)
    want = [np.asarray(x, np.float64) for x in _fit_conv_nodeq(jpt, parts)]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got[0][:, :nb], want[0][:R2, :nb], rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-15)
    assert np.abs(want[1]).max() > 0 and not got[0][:, nb:].any()


@pytest.mark.parametrize("name,basis", [("graded15", "node"),
                                        ("graded15", "corner"),
                                        ("graded_q62", "node"),
                                        ("graded_q62", "corner")])
def test_restore_mesh_state_matches_jax(twins, name, basis):
    """restore_mesh_state against the JAX package's on the graded plan
    with 1,024 loose elements (uniform bricks) and on the one with a
    corner-tier brick: random global fields, each brick's memory
    variables in either basis (the corner one made from a node field),
    the loose elements' four arrays.  The JAX mesh route keeps both
    plans in the corner basis, so each brick is compared there."""
    import jax.numpy as jnp
    from hercules_tpu.solver import pallas_mesh as jpm
    tw = twins(name)
    jmt = jpm.MeshPallasTables(tw.jplan, tw.jsim.tables, dtype=jnp.float64)
    mt = MeshPallasTables(tw.plan, tw.sim.tables, dtype=torch.float64,
                          device="cpu")
    assert not jmt.packed and mt.El == jmt.El
    assert tuple(mt.tiers) == CASES[name][2]
    Nn = tw.sim.mesh.nnum
    R = jmt.conv_rows
    u, up = (tw.rng.standard_normal((Nn, 3)) for _ in range(2))
    flat = []
    for b, geo in zip(tw.plan.bricks, jmt.geo):
        node = _jax_node_rows(tw.cols(R // 8, b.nb, b.nb), R // 8, geo[4])
        if basis == "corner":
            ev = np.zeros(geo[4], bool)
            ev[:b.nb] = tw.plan.evalid_cat[b.off:b.off + b.nb]
            node = restart.conv_node_to_corner(geo[0], ev, node, R)
        flat.append(node)
    flat += [tw.rng.standard_normal((mt.El, 8, 3)) for _ in range(4 if mt.El
                                                                 else 0)]
    Ss, convs, lconv = restore_mesh_state(
        mt, restart.Checkpoint(u, up, tuple(flat)))
    jus, jups, jconv = jpm.restore_mesh_state(jmt, tw.jplan, u, up, flat)
    for b, brick in enumerate(tw.plan.bricks):
        nb, step = brick.nb, mt.steps[b]
        for rows, ju in ((slice(0, 3), jus[b]), (slice(3, 6), jups[b])):
            np.testing.assert_array_equal(Ss[b][rows, :nb].numpy(),
                                          np.asarray(ju)[:, :nb])
        got = convs[b][0].numpy()
        if step.tier != "corner":
            got = restart.conv_node_to_corner(step.offs, step.evalid, got, R)
        want = np.asarray(jconv[b])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got[:, :nb], want[:, :nb], rtol=0,
                                   atol=1e-15)
    np.testing.assert_array_equal(Ss[-1][0:3].numpy(), np.asarray(jus[-1]))
    assert len(lconv) == (4 if mt.El else 0)
    for a, c in zip(lconv, jconv[len(tw.plan.bricks)] if mt.El else ()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


# ---- JAX checkpoints, and refusals -------------------------------------

def _jax_run(paths, rundir, solver):
    """The JAX package's Simulation.run on the CPU, float64, with the
    case's outputs; returns (jax sim, state, samples)."""
    import jax.numpy as jnp
    from hercules_tpu.sim import SimOutputs as JaxSimOutputs
    from hercules_tpu.sim import Simulation as JaxSimulation
    jsim = JaxSimulation.setup(paths[1], paths[2], cvmdb=paths[0])
    out = JaxSimOutputs(jsim.mesh, jsim.params, rundir=str(rundir))
    state, samples = jsim.run(dtype=jnp.float64, solver=solver,
                              outputs=out, rundir=str(rundir), ndev=1)
    return jsim, state, samples


def _checkpoint_in(rundir, step):
    """Make the checkpoint of ``step`` the run's checkpoint.in."""
    ck = rundir / "checkpoints"
    for f in ("checkpoint.out0", "checkpoint.out1"):
        if checkpoint_read(str(ck / f))[0] == step:
            shutil.copy(ck / f, ck / "checkpoint.in")
            return
    raise AssertionError(f"no checkpoint of step {step}")


@pytest.mark.parametrize("name", ["box", "bkt", "two"])
def test_jax_pallas_checkpoint_resumes(tmp_path, name):
    """A checkpoint of the JAX package's Pallas route (interpret mode,
    [3, LEN_jax] fields and its node-basis conv [8 | 16, LEN_jax], on
    the node tier with its mixed elements' state) resumes in the port
    within 2e-13 of max|u| of the JAX straight run."""
    from hercules_tpu.solver.pallas_brick import \
        pallas_u_global as jax_u_global
    paths = _case(tmp_path, name, checkpointing_rate=N)
    jsim, jstate, jsamp = _jax_run(paths, tmp_path, "pallas")
    assert jsim.solver_path_name == "pallas_packed"
    _checkpoint_in(tmp_path, N)
    ck = checkpoint_read(str(tmp_path / "checkpoints" / "checkpoint.in"))
    assert ck[1].shape[0] == 3
    assert len(ck[3]) == {"box": 0, "bkt": 1, "two": 2}[name]
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    state, samp = sim.run(device="cpu", rundir=str(tmp_path))
    assert sim.start_step == N
    plan = build_plan(sim.mesh)
    u = pallas_u_global(plan, state[0], sim.mesh.nnum)
    uj = jax_u_global(plan, np.asarray(jstate[0]), sim.mesh.nnum)
    scale = np.abs(uj).max()
    assert scale > 0
    np.testing.assert_allclose(u, uj, rtol=0, atol=2e-13 * scale)
    np.testing.assert_allclose(samp, jsamp[N:], rtol=0,
                               atol=2e-13 * np.abs(jsamp).max())


@pytest.mark.parametrize("name", ["box", "soft"])
def test_jax_unstructured_checkpoint_resumes(tmp_path, name):
    """A checkpoint of the JAX package's unstructured solver (global
    [N, 3] fields, BKT's four [E, 8, 3] arrays) resumes the port's
    unstructured route within 2e-13 of max|u| of the JAX straight run;
    the port's other routes refuse its memory variables."""
    paths = _case(tmp_path, name, checkpointing_rate=N)
    jsim, jstate, jsamp = _jax_run(paths, tmp_path, "unstructured")
    assert jsim.solver_path_name == "unstructured"
    _checkpoint_in(tmp_path, N)
    ck = checkpoint_read(str(tmp_path / "checkpoints" / "checkpoint.in"))
    assert ck[1].shape == (jsim.mesh.nnum, 3)
    assert len(ck[3]) == {"box": 0, "soft": 4}[name]
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    (u, _, _), samp = sim.run(device="cpu", rundir=str(tmp_path),
                              solver="unstructured")
    assert sim.start_step == N and sim.solver_path_name == "unstructured"
    uj = np.asarray(jstate[0])
    scale = np.abs(uj).max()
    assert scale > 0
    np.testing.assert_allclose(u.numpy(), uj, rtol=0, atol=2e-13 * scale)
    np.testing.assert_allclose(samp, jsamp[N:], rtol=0,
                               atol=2e-13 * np.abs(jsamp).max())
    if name == "soft":
        with pytest.raises(RuntimeError, match="does not match plan"):
            sim.run(device="cpu", rundir=str(tmp_path), solver="bricks")


def test_unstructured_checkpoint_of_other_layout_raises(tmp_path):
    """A checkpoint the unstructured solver cannot read (the fields of
    another mesh, BKT arrays of the kernel route's layout) raises in the
    JAX package's words instead of starting from zero."""
    paths = _case(tmp_path, "bkt", checkpointing_rate=N)
    _run(paths, torch.float64)
    _checkpoint_in(tmp_path, N)
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    with pytest.raises(RuntimeError, match="does not match the "
                                           "unstructured solver"):
        sim.run(device="cpu", rundir=str(tmp_path), solver="unstructured")


@pytest.mark.parametrize("damping", ["rayleigh", "bkt"])
def test_unstructured_files_match_jax(tmp_path, damping):
    """Both packages' unstructured routes through Simulation.run with 4-D
    displacement and velocity, one plane and checkpoints, float64, on
    fixture (a): the 4-D headers equal byte for byte but for
    generation_date, the plane coordinates byte for byte, the 4-D and
    plane data and the checkpoint fields within 2e-13 of their max (the
    two float64 paths differ in the last bits)."""
    runs = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        paths = write_box_case(str(d), 62.5, N + M, 2, damping=damping)
        add_output_keys(paths[1], paths[2], output_rate=4, planes_rate=2,
                        checkpointing_rate=N)
        if name == "jax":
            _jax_run(paths, d, "unstructured")
        else:
            sim, _, _ = _run(paths, torch.float64, solver="unstructured")
            assert sim.solver_path_name == "unstructured"
        runs[name] = d
    P, J = runs["port"], runs["jax"]

    def close(a, b):
        scale = np.abs(b).max()
        assert a.shape == b.shape and scale > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-13 * scale)

    for f in ("disp.h4d", "vel.h4d"):
        hp, dp = read_4d(str(P / f))
        hj, dj = read_4d(str(J / f))
        for k in hp.dtype.names:
            if k != "generation_date":
                assert hp[k].tobytes() == hj[k].tobytes(), k
        close(dp, dj)
    assert (P / "planes" / "planecoords.0").read_bytes() == \
        (J / "planes" / "planecoords.0").read_bytes()
    close(np.fromfile(P / "planes" / "planedisplacements.0"),
          np.fromfile(J / "planes" / "planedisplacements.0"))
    for k in (0, 1):
        ckp = checkpoint_read(str(P / "checkpoints" / f"checkpoint.out{k}"))
        ckj = checkpoint_read(str(J / "checkpoints" / f"checkpoint.out{k}"))
        assert ckp[0] == ckj[0] and ckp[4].keys() == ckj[4].keys()
        assert len(ckp[3]) == len(ckj[3]) == (4 if damping == "bkt" else 0)
        for a, b in zip(ckp[1:3], ckj[1:3]):
            close(a, b)


def test_checkpoint_of_other_damping_raises(tmp_path):
    """A Rayleigh run's checkpoint does not restart a BKT run."""
    paths = _case(tmp_path, "box", checkpointing_rate=N)
    _run(paths, torch.float64)
    _checkpoint_in(tmp_path, N)
    with open(paths[1]) as f:
        text = f.read()
    with open(paths[1], "w") as f:
        f.write(text.replace("type_of_damping             = rayleigh",
                             "type_of_damping             = bkt"))
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    with pytest.raises(RuntimeError, match="damping=rayleigh"):
        sim.run(device="cpu", rundir=str(tmp_path))


def test_foreign_conv_layout_raises(tmp_path):
    """The element-basis memory variables of the JAX package's brick
    route (4 arrays [24, E]) fit no tier: the JAX Pallas route refuses
    them, and so does the port, in the same words."""
    paths = _case(tmp_path, "bkt", checkpointing_rate=N)
    _jax_run(paths, tmp_path, "bricks")
    _checkpoint_in(tmp_path, N)
    ck = checkpoint_read(str(tmp_path / "checkpoints" / "checkpoint.in"))
    assert len(ck[3]) == 4 and ck[3][0].shape[0] == 24
    with pytest.raises(RuntimeError, match="unsupported layout"):
        _jax_run(paths, tmp_path, "pallas")
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    with pytest.raises(RuntimeError, match=restart.LAYOUT_ERROR[:40]):
        sim.run(device="cpu", rundir=str(tmp_path))


def test_mesh_checkpoint_of_other_plan_raises(twins):
    """A mesh checkpoint whose memory variables do not match the plan's
    bricks raises; a field of another mesh too."""
    tw = twins("graded15")
    mt = MeshPallasTables(tw.plan, tw.sim.tables, dtype=torch.float64,
                          device="cpu")
    Nn = tw.sim.mesh.nnum
    u = np.zeros((Nn, 3))
    with pytest.raises(RuntimeError, match="multi-brick layout"):
        restore_mesh_state(mt, restart.Checkpoint(u, u, (np.zeros((6, 8)),)))
    with pytest.raises(RuntimeError, match="does not match"):
        restore_mesh_state(mt, restart.Checkpoint(u.T, u.T, ()))
