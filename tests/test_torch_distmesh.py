"""The port's sharded mesher (hercules_tpu_torch/mesh/distributed.py)
against the JAX package's (hercules_tpu/mesh/distributed.py): on fixture
(a) at 62.5 m (the full pipeline, generate_mesh_shard) and on the graded
oracle tree of tests/test_distmesh.py, at 2 and 4 ranks, every shard is
np.array_equal to the JAX package's, both under their LocalComm threads.
TorchComm in a real 2-process gloo group gives the same shards, and its
allgather_rows returns every rank's rows with their own dtype and bytes.
The gathered mesh is generate_mesh's with its dangling tables in node-id
order (multihost.dangling_in_id_order): the one-process reference of
the multi-process gather chain."""

import inspect
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from hercules_tpu import config as jconfig
from hercules_tpu import cvm as jcvm
from hercules_tpu.etree import morton as jmorton
from hercules_tpu.mesh import Octree as JOctree
from hercules_tpu.mesh import distributed as jdist
from hercules_tpu_torch import config, cvm, meshgen
from hercules_tpu_torch.etree import morton
from hercules_tpu_torch.fixtures import (one_torch_thread, write_basin_case,
                                         write_box_case)
from hercules_tpu_torch.mesh import Octree, extract_mesh
from hercules_tpu_torch.mesh import distributed as dist
from hercules_tpu_torch.parallel.multihost import (dangling_in_id_order,
                                                   free_port)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120

_one_torch_thread = one_torch_thread()


def run_ranks(comm_cls, nproc, fn):
    """fn(comm) on nproc lockstep threads of comm_cls (a LocalComm);
    the first failure propagates (the barrier aborted so that the peers
    do not wait)."""
    comms = comm_cls.group(nproc)
    results, errs = [None] * nproc, []

    def worker(r):
        try:
            results[r] = fn(comms[r])
        except BaseException as e:   # noqa: BLE001 - test harness
            errs.append(e)
            comms[r]._sh["barrier"].abort()

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(nproc)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return results


SHARD_FIELDS = ("ticksize", "farendp", "elem_x", "elem_y", "elem_z",
                "elem_level", "elem_lnid", "e0", "e_global", "node_x",
                "node_y", "node_z", "gnid0", "n_global", "dn_ids",
                "dn_anchors", "dn_deps", "edge_m")


def shard_arrays(shard):
    """{name: array} of a MeshShard's fields and property columns."""
    out = {k: np.asarray(getattr(shard, k)) for k in SHARD_FIELDS}
    out.update({f"props_{k}": np.asarray(v)
                for k, v in (shard.props or {}).items()})
    return out


def assert_shards_equal(a, b):
    a, b = shard_arrays(a) if not isinstance(a, dict) else a, \
        shard_arrays(b) if not isinstance(b, dict) else b
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _graded_te(morton_mod):
    """tests/test_distmesh.py's graded criterion: level 5 in a z-slab
    and an x-corner, 4 elsewhere."""
    def te(tr, hi, lo, lv, rec):
        x, y, z = morton_mod.deinterleave3(hi, lo)
        fine = (z < (1 << 28)) | ((x > (1 << 29)) & (y < (1 << 28)))
        return lv < np.where(fine, 5, 4)
    return te


def graded_shard(octree_cls, dist_mod, morton_mod, comm):
    """The graded oracle tree's shard of this rank (the steps of
    tests/test_distmesh.py, in the module dist_mod)."""
    tree = octree_cls.newtree(1000.0, 1000.0, 500.0)
    while tree.n < 4 * comm.nproc:
        lmin = int(tree.level.min())
        tree.refine(lambda tr, hi, lo, lv: {},
                    lambda tr, hi, lo, lv, rec, _l=lmin: lv <= _l)
    starts = dist_mod.choose_intervals(tree, np.ones(tree.n), comm.nproc)
    tree, _ = dist_mod.shard_tree(tree, starts, comm.rank)
    tree.refine(lambda tr, hi, lo, lv: {}, _graded_te(morton_mod))
    dist_mod.balance_distributed(tree, starts, comm)
    return dist_mod.extract_mesh_shard(tree, starts, comm)


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    return write_box_case(str(tmp_path_factory.mktemp("box")), 62.5, 20, 2)


@pytest.mark.parametrize("nproc", [2, 4])
def test_box_shards_equal_jax(box, nproc):
    """generate_mesh_shard on fixture (a): the port's shards are the JAX
    package's, array for array (properties included)."""
    cv, ph, nu = box
    p, jp = config.load_params(ph, nu), jconfig.load_params(ph, nu)
    ours = run_ranks(dist.LocalComm, nproc, lambda c: dist.generate_mesh_shard(
        p, cvm.CVM(cv), c))
    theirs = run_ranks(jdist.LocalComm, nproc,
                       lambda c: jdist.generate_mesh_shard(
                           jp, jcvm.CVM(cv), c))
    assert sum(s.lenum for s in ours) == ours[0].e_global
    for a, b in zip(ours, theirs):
        assert a.lenum < a.e_global
        assert_shards_equal(a, b)


@pytest.mark.parametrize("nproc", [2, 4])
def test_graded_tree_shards_equal_jax(nproc):
    """The graded oracle tree (dangling nodes across shard boundaries):
    the port's shards are the JAX package's, and the port's gathered
    mesh is its extract_mesh oracle."""
    ours = run_ranks(dist.LocalComm, nproc, lambda c: graded_shard(
        Octree, dist, morton, c))
    theirs = run_ranks(jdist.LocalComm, nproc, lambda c: graded_shard(
        JOctree, jdist, jmorton, c))
    for a, b in zip(ours, theirs):
        assert_shards_equal(a, b)
    meshes = run_ranks(dist.LocalComm, nproc, lambda c: dist.gather_mesh(
        graded_shard(Octree, dist, morton, c), c))
    tree = Octree.newtree(1000.0, 1000.0, 500.0)
    tree.refine(lambda tr, hi, lo, lv: {}, _graded_te(morton))
    tree.balance()
    ref = dangling_in_id_order(extract_mesh(tree))
    for m in meshes:
        for k in ("elem_x", "elem_level", "elem_lnid", "node_x", "node_z",
                  "dangling", "dn_ids", "dn_anchors", "dn_weights"):
            assert np.array_equal(getattr(m, k), getattr(ref, k)), k


def test_gathered_mesh_is_generate_mesh(tmp_path):
    """The basin case at 31.25 m (5,632 elements, dangling nodes): the
    mesh gather_mesh assembles from 2 shards is generate_mesh's with its
    dangling tables in node-id order."""
    cv, ph, nu = write_basin_case(str(tmp_path), 31.25, 20, 2)
    p = config.load_params(ph, nu)
    ref = dangling_in_id_order(meshgen.generate_mesh(p, cvm.CVM(cv)))
    assert len(ref.dn_ids)
    m = run_ranks(dist.LocalComm, 2, lambda c: dist.gather_mesh(
        dist.generate_mesh_shard(p, cvm.CVM(cv), c), c))[0]
    for k in ("elem_x", "elem_y", "elem_z", "elem_level", "elem_lnid",
              "node_x", "node_y", "node_z", "dangling", "dn_ids",
              "dn_anchors", "dn_weights", "edge_m"):
        assert np.array_equal(getattr(m, k), getattr(ref, k)), k
    for k in ref.props:
        assert np.array_equal(m.props[k], ref.props[k]), k


def test_sharded_mesher_refines_coarse_regions(tmp_path):
    """A behaviour of the JAX package's sharded mesher that the port's
    copy keeps: its geometric coarse pass (max(nproc x 64, 8) leaves)
    is never coarsened, so GRADED_LAYERS at 62.5 m, 592 elements of
    62.5, 125 and 250 m by generate_mesh, meshes into 704 (no 250 m
    element) on 2 processes, in both packages alike."""
    from hercules_tpu import meshgen as jmeshgen
    from hercules_tpu_torch.fixtures import GRADED_LAYERS, four_q_freq
    cv, ph, nu = write_box_case(str(tmp_path), 62.5, 20, 2,
                                layers=GRADED_LAYERS, freq=four_q_freq(62.5))
    p, jp = config.load_params(ph, nu), jconfig.load_params(ph, nu)
    one = meshgen.generate_mesh(p, cvm.CVM(cv))
    assert one.lenum == jmeshgen.generate_mesh(jp, jcvm.CVM(cv)).lenum == 592
    assert sorted(set(one.edge_m)) == [62.5, 125.0, 250.0]
    ours = run_ranks(dist.LocalComm, 2, lambda c: dist.gather_mesh(
        dist.generate_mesh_shard(p, cvm.CVM(cv), c), c))[0]
    theirs = run_ranks(jdist.LocalComm, 2, lambda c: jdist.gather_mesh(
        jdist.generate_mesh_shard(jp, jcvm.CVM(cv), c), c))[0]
    assert ours.lenum == theirs.lenum == 704
    assert sorted(set(ours.edge_m)) == [62.5, 125.0]
    assert np.array_equal(ours.elem_lnid, theirs.elem_lnid)


_CHILD = r'''
import sys
import numpy as np
import torch.distributed as dist
pid, port, out, cv, ph, nu = sys.argv[1:7]
pid = int(pid)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=pid)
sys.path.insert(0, sys.argv[7])
from hercules_tpu_torch import config, cvm
from hercules_tpu_torch.etree import morton
from hercules_tpu_torch.mesh import Octree
from hercules_tpu_torch.mesh import distributed as md
HELPERS
comm = md.TorchComm()
# every dtype the mesher exchanges, empty rows included
rows = [np.array([[2 ** 63 + 5 + pid, 7]], np.uint64),
        np.arange(6.0 * pid).reshape(-1, 2) / 3.0,
        np.array([[pid, -1]], np.int64), np.zeros((0, 3), np.int8)]
got = [comm.allgather_rows(a) for a in rows]
arrs = {f"x{i}_{r}": g for i, gs in enumerate(got) for r, g in enumerate(gs)}
p = config.load_params(ph, nu)
box = md.generate_mesh_shard(p, cvm.CVM(cv), comm)
arrs.update({f"box_{k}": v for k, v in shard_arrays(box).items()})
graded = graded_shard(Octree, md, morton, comm)
arrs.update({f"graded_{k}": v for k, v in shard_arrays(graded).items()})
arrs["sum"] = np.array([comm.allreduce_sum(3 + pid),
                        comm.allreduce_max(10 * pid)])
# the launcher's host helpers in the same group: process 0's object on
# both, and the property pass split over the processes
from hercules_tpu_torch.parallel import multihost as mh
arrs["bcast"] = np.array([mh.broadcast_from_host0({"pid": pid})["pid"]])
mesh = md.gather_mesh(box, comm)
mesh.props = {}
mh.correct_properties_multihost(mesh, cvm.CVM(cv), p)
arrs.update({f"cp_{k}": v for k, v in mesh.props.items()})
np.savez(f"{out}.{pid}.npz", **arrs)
dist.destroy_process_group()
print("ok", flush=True)
'''


def _child_code():
    """_CHILD with this module's helpers pasted in (the child imports no
    test module, so no jax)."""
    src = "\n".join(inspect.getsource(f) for f in (_graded_te, graded_shard,
                                                   shard_arrays))
    return _CHILD.replace("HELPERS", f"SHARD_FIELDS = {SHARD_FIELDS!r}\n"
                          + src)


def test_torchcomm_two_processes(box, tmp_path):
    """TorchComm in a real 2-process gloo group: allgather_rows returns
    each rank's rows with its dtype and bytes (uint64 keys above 2^63
    included), the two reductions agree, and generate_mesh_shard (fixture
    (a)) and the graded oracle tree give the LocalComm shards; in the
    same group multihost.broadcast_from_host0 gives process 0's object
    and correct_properties_multihost generate_mesh's properties."""
    port, out = free_port(), str(tmp_path / "shards")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _child_code(), str(k), str(port), out, *box, ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for k in range(2)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    assert all(pr.returncode == 0 for pr in procs), outs
    p = config.load_params(box[1], box[2])
    ref_box = run_ranks(dist.LocalComm, 2, lambda c: dist.generate_mesh_shard(
        p, cvm.CVM(box[0]), c))
    ref_graded = run_ranks(dist.LocalComm, 2, lambda c: graded_shard(
        Octree, dist, morton, c))
    ref_mesh = meshgen.generate_mesh(p, cvm.CVM(box[0]))
    for pid in range(2):
        got = np.load(f"{out}.{pid}.npz")
        assert got["x0_0"].dtype == np.uint64
        assert got["x0_1"][0, 0] == np.uint64(2 ** 63 + 6)
        assert np.array_equal(got["x1_1"], np.arange(6.0).reshape(-1, 2) / 3)
        assert got["x1_0"].shape == (0, 2) and got["x3_1"].dtype == np.int8
        assert np.array_equal(got["x2_1"], [[1, -1]])
        assert list(got["sum"]) == [7, 10]
        assert got["bcast"][0] == 0
        cps = [k for k in got.files if k.startswith("cp_")]
        assert cps and all(np.array_equal(got[k], ref_mesh.props[k[3:]])
                           for k in cps)
        for name, ref in (("box", ref_box[pid]), ("graded", ref_graded[pid])):
            mine = {k[len(name) + 1:]: got[k] for k in got.files
                    if k.startswith(name + "_")}
            assert_shards_equal(mine, shard_arrays(ref))
