"""Shard-local slab tables (hercules_tpu_torch/parallel/shardbuild.py):
build_slab_tables_shard over processes of LocalComm threads on fixture
(a) at 62.5 m, Rayleigh and BKT, 2 processes feeding 2 and 4 ranks,
byte-equal to the port's build_slab_tables(dev_slice=...) on the global
mesh and to the JAX package's build_slab_tables_shard.  The kernel slab
step's constants packed from the stacked arrays
(slab.slab_step_module) are byte-equal to the ones brick_step_module
builds on each rank's fragment plan, on the K1, K2 and K4 tiers.  A
graded mesh is refused with the JAX package's message."""

import threading

import numpy as np
import pytest
import torch

from hercules_tpu import config as jconfig
from hercules_tpu import cvm as jcvm
from hercules_tpu.mesh import distributed as jdist
from hercules_tpu.parallel import shardbuild as jshardbuild
from hercules_tpu_torch import config, cvm
from hercules_tpu_torch.etree import morton
from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, four_q_freq,
                                         one_torch_thread, write_box_case)
from hercules_tpu_torch.mesh import Octree
from hercules_tpu_torch.mesh import distributed as dist
from hercules_tpu_torch.parallel import slab
from hercules_tpu_torch.parallel.shardbuild import build_slab_tables_shard
from hercules_tpu_torch.sim import Simulation
from hercules_tpu_torch.solver.bricks import build_plan
from hercules_tpu_torch.solver.fused_mesh import brick_step_module

_one_torch_thread = one_torch_thread()

CASES = {"rayleigh": {}, "bkt": dict(damping="bkt"),
         "four_q": dict(damping="bkt", layers=FOUR_Q_LAYERS,
                        freq=four_q_freq(62.5))}


def run_ranks(comm_cls, nproc, fn):
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


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            paths = write_box_case(str(tmp_path_factory.mktemp(name)), 62.5,
                                   20, 2, **CASES[name])
            made[name] = (Simulation.setup(paths[1], paths[2],
                                           cvmdb=paths[0]), paths)
        return made[name]

    return get


def same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("damping,n_dev", [("rayleigh", 2), ("rayleigh", 4),
                                           ("bkt", 2), ("bkt", 4)])
def test_shard_tables_equal_global_and_jax(sims, damping, n_dev):
    sim, (cv, ph, nu) = sims(damping)
    mesh = sim.mesh
    src = np.array([mesh.elem_lnid[mesh.lenum // 2, 0],
                    mesh.elem_lnid[3, 6]], np.int32)
    splits = [(r * n_dev // 2, (r + 1) * n_dev // 2) for r in range(2)]
    p, jp = config.load_params(ph, nu), jconfig.load_params(ph, nu)

    ours = run_ranks(dist.LocalComm, 2, lambda c: build_slab_tables_shard(
        dist.generate_mesh_shard(p, cvm.CVM(cv), c), p, c, n_dev,
        src_gnids=src, dev_slice=splits[c.rank]))
    theirs = run_ranks(jdist.LocalComm, 2,
                       lambda c: jshardbuild.build_slab_tables_shard(
                           jdist.generate_mesh_shard(jp, jcvm.CVM(cv), c),
                           jp, c, n_dev, src_gnids=src,
                           dev_slice=splits[c.rank]))
    for (d0, d1), st, jst in zip(splits, ours, theirs):
        ref = slab.build_slab_tables(mesh, sim.tables, n_dev, src_ids=src,
                                     dev_slice=(d0, d1))
        assert st.dev0 == ref.dev0 == jst.dev0 == d0
        for other, who in ((ref, "port"), (jst, "jax")):
            assert (st.nzp, st.nyp, st.nxp, st.tot_local) == \
                (other.nzp, other.nyp, other.nxp, other.tot_local), who
            assert tuple(st.meta.offs) == tuple(other.meta.offs), who
            assert st.meta.S == other.meta.S, who
            for k in ("ez_of", "m48", "inv_mass", "mass_minusaM",
                      "src_lidx", "src_mask"):
                same(getattr(st, k), getattr(other, k), f"{who} {k}")
            for k in st.c:
                same(st.c[k], other.c[k], f"{who} c.{k}")
            for d in range(d0, d1):
                same(st.gnid_local[d], other.gnid_local[d], f"{who} gnid {d}")
            if damping == "bkt":
                assert st.bkt.keys() == other.bkt.keys()
                for k in st.bkt:
                    same(st.bkt[k], other.bkt[k], f"{who} bkt.{k}")
                for k in ("bkt_valid", "kmu", "kkappa"):
                    same(getattr(st, k), getattr(other, k), f"{who} {k}")
                assert st.bk_scal is not None
                assert st.bk_scal.keys() == other.bk_scal.keys()
                assert all(float(st.bk_scal[k]) == float(other.bk_scal[k])
                           for k in st.bk_scal), who
        if damping == "bkt":
            assert st.shear_only == ref.shear_only


@pytest.mark.parametrize("case,tier", [("rayleigh", "elastic"),
                                       ("bkt", "uniform"),
                                       ("four_q", "corner")])
@pytest.mark.parametrize("P", [2, 3])
def test_stacked_packing_equals_plan_built(sims, case, tier, P):
    """slab_step_module's K (and K4's coefficient table) is the one
    brick_step_module builds on the rank's fragment plan, byte for
    byte, in float64 and float32."""
    sim, _ = sims(case)
    plan = build_plan(sim.mesh, legacy_axes=True)
    st = slab.build_slab_tables(sim.mesh, sim.tables, P, src_ids=sim.src_ids,
                                plan=plan)
    assert slab.slab_kernel_tier(st) == tier
    fb, = slab.split_bricks(plan, P)
    for dtype in (torch.float64, torch.float32):
        for r in range(P):
            mod = slab.slab_step_module(st, r, dtype, "cpu")
            frag = slab.brick_fragment(plan, 0, fb.frag_cols(r),
                                       int(fb.ez_of[r]), fb.plane,
                                       fb.tot_local)
            ref, LEN = brick_step_module(
                frag, 0, sim.tables, dtype, "cpu",
                tier=None if tier == "elastic" else tier)
            assert LEN == fb.LEN and type(mod) is type(ref)
            assert mod.K.dtype == ref.K.dtype
            assert torch.equal(mod.K, ref.K), (r, dtype)
            assert mod.offs == ref.offs
            if tier != "elastic":
                assert np.array_equal(mod.evalid, ref.evalid)
            if tier == "corner":
                assert torch.equal(mod.tab, ref.tab)
            if tier == "uniform":
                assert (mod.scales, mod.rec) == (ref.scales, ref.rec)


def test_shard_tables_refuse_graded(sims):
    """A graded shard raises with the JAX package's message (the
    callers fall back to the gather_mesh chain)."""
    _, (cv, ph, nu) = sims("rayleigh")
    p = config.load_params(ph, nu)

    def te(tr, hi, lo, lv, rec):
        x, y, z = morton.deinterleave3(hi, lo)
        return lv < np.where(z < (1 << 28), 5, 4)

    def build(comm):
        tree = Octree.newtree(1000.0, 1000.0, 500.0)
        while tree.n < 8 * comm.nproc:
            lmin = int(tree.level.min())
            tree.refine(lambda tr, hi, lo, lv: {},
                        lambda tr, hi, lo, lv, rec, _l=lmin: lv <= _l)
        starts = dist.choose_intervals(tree, np.ones(tree.n), comm.nproc)
        tree, _ = dist.shard_tree(tree, starts, comm.rank)
        tree.refine(lambda tr, hi, lo, lv: {}, te)
        dist.balance_distributed(tree, starts, comm)
        shard = dist.extract_mesh_shard(tree, starts, comm)
        shard.props = {"Vp": np.full(shard.lenum, 6000.0),
                       "Vs": np.full(shard.lenum, 3464.0),
                       "rho": np.full(shard.lenum, 2700.0)}
        with pytest.raises(RuntimeError,
                           match="slab decomposition requires a single "
                                 "uniform brick covering the whole mesh"):
            build_slab_tables_shard(shard, p, comm, 2)
        return True

    assert all(run_ranks(dist.LocalComm, 2, build))
