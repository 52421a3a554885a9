"""The multi-chip communication model (``parallel/comm_model.py``)
against what the ranks sent: on P CPU ranks, the bytes each rank sent
per step and the exchange phases ``ranks.RankGroup`` counted in a run of
the slab paths (both steps), the graded paths (gslab on the depth-graded
NL_LAYERS box, gmesh on the basin and on the depth-graded box) and the
sharded path equal the model's per-step bytes and phases (the largest
rank's), in float32 and float64, as the JAX package's
tests/test_comm_model.py holds its model against a trace of its
collectives; and the predictions are labelled as such."""

import numpy as np
import pytest
import torch

from hercules_tpu_torch.fixtures import (GRADED_LAYERS, NL_FREQ, NL_LAYERS,
                                         four_q_freq, one_torch_thread,
                                         write_basin_case, write_box_case)
from hercules_tpu_torch.parallel import comm_model, driver
from hercules_tpu_torch.parallel.gmesh import build_gmesh_tables
from hercules_tpu_torch.parallel.gslab import build_gslab_tables
from hercules_tpu_torch.parallel.partition import shard_tables
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.parallel.ranks import RankGroup
from hercules_tpu_torch.parallel.slab import build_slab_tables
from hercules_tpu_torch.sim import Simulation

STEPS = 3

_one_torch_thread = one_torch_thread()


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    made = {}
    for name, kw in (("box", {}), ("graded", dict(layers=GRADED_LAYERS,
                                                  freq=four_q_freq(62.5))),
                     ("deep", dict(layers=NL_LAYERS, freq=NL_FREQ)),
                     ("basin", None)):
        root = tmp_path_factory.mktemp(name)
        paths = (write_basin_case(str(root), 62.5, STEPS, 1) if kw is None
                 else write_box_case(str(root), 62.5, STEPS, 1, **kw))
        made[name] = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    return made


def _counted(path, sim):
    """(max bytes sent per rank per step, max phases per step) of a
    run of STEPS steps."""
    path.group.reset_counts()
    driver.run_multichip(path, sim.src_forces, STEPS, sim.params.delta_t)
    return (max(path.group.sent) / STEPS, max(path.group.phases) / STEPS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [2, 3, 8])
@pytest.mark.parametrize("cls", [driver.SlabXLAPath, driver.SlabPallasPath])
def test_slab_comm_matches_ranks(sims, cls, P, dtype):
    sim = sims["box"]
    st = build_slab_tables(sim.mesh, sim.tables, P, src_ids=sim.src_ids)
    path = cls(st, RankGroup(["cpu"] * P), dtype, sim.mesh.nnum)
    nbytes = torch.empty((), dtype=dtype).element_size()
    c = comm_model.slab_comm(st, dtype_bytes=nbytes)
    assert _counted(path, sim) == (c.bytes_out, c.phases)
    assert c.bytes_out == 2 * 3 * 17 * 17 * nbytes
    assert comm_model.slab_comm_dims(st.nxp, st.nyp, P, nbytes) == c


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("name", ["box", "graded"])
def test_sharded_comm_matches_ranks(sims, name, P, dtype):
    sim = sims[name]
    st = shard_tables(sim.tables, sim.mesh, P, src_ids=sim.src_ids)
    path = driver.ShardedPath(st, RankGroup(["cpu"] * P), dtype,
                              sim.mesh.nnum)
    nbytes = torch.empty((), dtype=dtype).element_size()
    c = comm_model.sharded_comm(st, dtype_bytes=nbytes)
    assert _counted(path, sim) == (c.bytes_out, c.phases)
    assert c.bytes_out == (P - 1) * st.B_pad * 3 * nbytes > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gslab_comm_matches_ranks(sims, dtype):
    """gslab on 2 ranks: per brick two plane shifts, and the hanging
    interface's triplet (rank 0 to rank 1) and reconciled plane (back)."""
    sim = sims["deep"]
    st = build_gslab_tables(sim.mesh, sim.tables, 2, src_ids=sim.src_ids)
    path = driver.GslabPath(st, RankGroup(["cpu"] * 2), dtype,
                            sim.mesh.nnum)
    nbytes = torch.empty((), dtype=dtype).element_size()
    c = comm_model.gslab_comm(st, dtype_bytes=nbytes)
    assert _counted(path, sim) == (c.bytes_out, c.phases)
    h = st.hang[0]
    assert c.bytes_out == (2 * 3 * (17 * 17 + 9 * 9)
                           + 9 * h.nyc * h.nxc) * nbytes
    assert c.phases == 2 * 2 + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,P", [("basin", 2), ("basin", 4),
                                    ("deep", 2)])
def test_gmesh_comm_matches_ranks(sims, name, P, dtype):
    """gmesh: per brick two plane shifts and one allsum of the [K, 9]
    interface buffer (rank 0 sends P - 1 of them)."""
    sim = sims[name]
    st = build_gmesh_tables(sim.mesh, sim.tables, P, src_ids=sim.src_ids)
    path = driver.GMeshPath(st, RankGroup(["cpu"] * P), dtype,
                            sim.mesh.nnum)
    nbytes = torch.empty((), dtype=dtype).element_size()
    c = comm_model.gmesh_comm(st, dtype_bytes=nbytes)
    assert _counted(path, sim) == (c.bytes_out, c.phases)
    planes = sum(fb.plane for fb in st.bricks)
    assert c.bytes_out == (2 * 3 * planes + (P - 1) * st.K * 9) * nbytes
    assert c.phases == 2 * len(st.bricks) + 2 and st.K > 0


def test_plan_scaling_report(sims):
    """The plan's report: one line per card count, the split cap at the
    smallest brick's outer layers, every line a prediction."""
    plan = build_plan(sims["deep"].mesh)
    text = comm_model.plan_scaling_report(plan, 1152, 1e10,
                                          device_counts=(1, 2, 4))
    lines = text.splitlines()
    assert len(lines) == 2 + 3 and all(ln.startswith("#") for ln in lines)
    assert lines[0].startswith("# prediction")
    assert "exceeds the smallest brick's 2 outer element layers" in lines[-1]


def test_predictions_are_labelled():
    c = comm_model.slab_comm_dims(129, 129, 4)
    r = comm_model.predict(c, 2 ** 20, 1e10)
    assert r["kind"] == "prediction" and r["hw"] == comm_model.H100_SXM.name
    assert r["t_step_s"] == pytest.approx(
        r["t_compute_s"] + 2 * 5e-6 + c.bytes_out / 450e9)
    assert 0 < r["efficiency"] < 1
    text = comm_model.scaling_report(129, 129, 65, 2 ** 20, 1e10,
                                     device_counts=(1, 2, 4, 8, 128))
    lines = text.splitlines()
    assert all(ln.startswith("#") for ln in lines)
    assert lines[0].startswith("# prediction")
    assert "exceeds 64 z element layers" in lines[-1]
    assert len(lines) == 2 + 5 and np.isfinite(r["eups"])
