"""Multi-process runs: the counterpart of the JAX package's pod-scale
shape (``hercules_tpu/parallel/multihost.py``; SURVEY section 2.7,
BASELINE config 5), as a ``torch.distributed`` process group in place
of ``jax.distributed``.

The reference scales by adding MPI ranks; every rank meshes its
partition and exchanges halos point to point.  Here: one process per
host (or per card), started with ``--coordinator --nprocs --pid``, each
running the contiguous global ranks of a ``ranks.DistRankGroup`` on its
own devices, and the same step objects as one-process runs
(``slab.SlabStep`` / ``SlabKernelStep``, ``gslab.GSlabStep``,
``gmesh.GMeshStep``), whose shifts, sends and allsums cross process
boundaries.  Meshing stays on the host and SHARDED: every process
refines, balances and extracts only its Z-order block
(``mesh/distributed.py``), and on a mesh that is one uniform brick the
O(shard) pipeline follows -- shard-local slab tables
(``shardbuild.build_slab_tables_shard``), sources located per shard
(``compute_forces_multihost``), the slab solve over every process's
ranks -- so that no process holds the global mesh.  Other meshes are
gathered (``gather_mesh``) and take the chain slab -> gslab -> gmesh on
global tables; the unstructured ``sharded`` path is refused for more
than one process (its tables are not built shard-locally).

Every entry point is process-count agnostic: with one process the same
code runs on a ``ranks.RankGroup`` of the process's devices.  The
entry points run on CUDA unless ``device="cpu"`` (``--device cpu``)
asks for the CPU.  On CUDA the slab solve runs the kernel step (K1, K2
or K4 per fragment), as ``driver.choose_path`` does; on the CPU the
plain ``SlabStep`` (the JAX package's ``pallas=False`` default) unless
``pallas=True`` asks for the kernels' plain versions.

Transports (``init_multihost``): NCCL where every process has a card
of its own (one rank per process), else gloo, which moves CUDA tensors
through host copies.  The host passes (meshing, tables, sources,
gathers) always run over gloo (``mesh.distributed.TorchComm``).

The JAX module's ``make_global`` and ``make_global_shards`` have no
counterpart: torch has no global array, and each process places its
own ranks' rows on its own devices (the stacked tables of
``build_slab_tables(dev_slice=...)`` and of the shard build hold only
those rows).  Nor has ``global_device_mesh``: the rank group takes its
place.  Restart, output taps, stations and nonlinear soil are not
offered here, as the JAX module offers none of them.

    python -m hercules_tpu_torch.parallel.multihost --coordinator \\
        host0:1234 --nprocs N --pid K [--device cuda|cpu] \\
        <cvmdb> <physics.in> <numerical.in>

prints the JAX module's ``[multihost]`` lines.  The port's additions:
``--local-ranks`` (ranks per process, default 1), ``--backend``,
``--dtype`` (float32, float64 or both, comma-separated: one solve per
type on the same tables), ``--slab-step auto|plain|kernels``, ``--save
DIR`` (each process's final state, gather maps, kernel launches,
exchange counts and set-up and loop seconds) and more than one input
triple (the cases run in turn in one process group).  ``spawn`` starts
N such processes on this host over a free local port.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_HOST = {}          # the host comm of this process group, made once


def choose_backend(device, nprocs, local_ranks=1):
    """NCCL where every process can hold one card of its own on this
    host (device "cuda", one rank per process, at least nprocs cards),
    else gloo."""
    if (torch.device(device).type == "cuda" and local_ranks == 1
            and torch.cuda.is_available()
            and torch.cuda.device_count() >= nprocs):
        return "nccl"
    return "gloo"


def local_devices(device, nprocs, pid, local_ranks=1):
    """The devices of process pid's ranks: the CPU for each, or cards
    pid * local_ranks + i modulo the cards this host has (two processes
    share one card where there are fewer)."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * local_ranks
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    n = torch.cuda.device_count()
    return [torch.device("cuda", (pid * local_ranks + i) % n)
            for i in range(local_ranks)]


def init_multihost(coordinator=None, num_processes=None, process_id=None,
                   device="cuda", backend=None, local_ranks=1,
                   timeout_s=600):
    """torch.distributed bring-up over ``tcp://<coordinator>``; a no-op
    for one process.  Returns (process_count, process_index)."""
    import torch.distributed as dist
    if num_processes is not None and num_processes > 1 \
            and not dist.is_initialized():
        backend = backend or choose_backend(device, num_processes,
                                            local_ranks)
        if backend == "nccl":
            if local_ranks != 1:
                raise RuntimeError("NCCL runs one rank per process; use "
                                   "gloo for several local ranks")
            torch.cuda.set_device(local_devices(device, num_processes,
                                                process_id)[0])
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
        if backend == "nccl":
            # one collective of every process makes the communicator, so
            # that a later exchange between two processes need not
            dist.all_reduce(torch.zeros(1, device="cuda"))
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_comm():
    """The process group's host comm (mesh.distributed.TorchComm over
    gloo), made on first use by every process in the same order."""
    if "comm" not in _HOST:
        from ..mesh.distributed import TorchComm
        _HOST["comm"] = TorchComm()
    return _HOST["comm"]


def rank_group(devices):
    """This process's ranks on ``devices``: a RankGroup for one process,
    else the DistRankGroup spanning every process."""
    import torch.distributed as dist
    from .ranks import DistRankGroup, RankGroup
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return RankGroup(devices)
    return DistRankGroup(devices, host_group=host_comm().group)


def broadcast_from_host0(obj):
    """Process 0's host object on every process (the PE0 read and
    broadcast pattern for config objects)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return obj
    box = [obj if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=host_comm().group)
    return box[0]


def gather_global(xs, group):
    """[P, ...] host array on every process from per-rank tensors of
    one shape (xs indexed by global rank, None at other processes'
    ranks; bfloat16 widened to float32, exactly)."""
    from .driver import _host
    mine = {r: _host(xs[r]) for r in group.local_ranks}
    if getattr(group, "nproc", 1) > 1:
        import torch.distributed as dist
        every = [None] * group.nproc
        dist.all_gather_object(every, mine, group=host_comm().group)
        for part in every:
            mine.update(part)
    return np.stack([mine[r] for r in range(group.size)])


def correct_properties_multihost(mesh, cvm, params, origin=None,
                                 buildings=None):
    """mesh_correct_properties sharded over processes: each process runs
    the 27-point CVM averaging (psolve.c:7104-7331) for its contiguous
    element block only, then the per-element property columns are
    all-gathered (exact: the columns cross as bytes)."""
    import copy

    from ..material import MeshOrigin, correct_properties

    if origin is None:
        origin = MeshOrigin.from_params(params, cvm.ctl)
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        correct_properties(mesh, cvm, params, origin, buildings=buildings)
        return mesh
    comm = host_comm()
    nproc, pid = comm.nproc, comm.rank
    E = mesh.lenum
    lo = pid * E // nproc
    hi = (pid + 1) * E // nproc
    sub = copy.copy(mesh)
    sub.elem_x = mesh.elem_x[lo:hi]
    sub.elem_y = mesh.elem_y[lo:hi]
    sub.elem_z = mesh.elem_z[lo:hi]
    sub.elem_level = mesh.elem_level[lo:hi]
    sub.elem_lnid = mesh.elem_lnid[lo:hi]
    sub.edge_m = mesh.edge_m[lo:hi]
    sub.props = {}
    correct_properties(sub, cvm, params, origin, buildings=buildings)
    mesh.props = {k: np.concatenate([g[:, 0] for g in
                                     comm.allgather_rows(v[:, None])])
                  for k, v in sub.props.items()}
    return mesh


def local_device_slice(group):
    """(d0, d1): this process's contiguous range of global ranks (the
    slab tables' dev_slice)."""
    return group.local_ranks[0], group.local_ranks[-1] + 1


def compute_forces_multihost(sm, shard, params, comm,
                             chunk_bytes=64 << 20):
    """Global (node_ids, forces [T, L, 3]) from per-shard source
    location: each rank locates and evaluates only the sources inside
    its shard (locate_points' ancestor check assigns each point to
    exactly one shard), then the per-node force series merge by
    summation in bounded allgather rounds.  Duplicate-node sums
    accumulate in rank order (vs. global point order), so cross-rank
    shared nodes can differ from the serial build by float rounding
    only."""
    ids, F = sm.compute_forces(shard, params, props=shard.props,
                               partial=True)
    T = params.total_steps
    nloc = int(getattr(sm, "located_points", len(ids)))
    ntot = comm.allreduce_sum(nloc)
    if sm.type_of_source == "point" and ntot != 1:
        raise RuntimeError(f"point source located by {ntot} shards")
    if sm.type_of_source == "srfh" and ntot != len(sm.src_lon):
        raise RuntimeError(
            f"srfh: {ntot}/{len(sm.src_lon)} points located")
    if ntot == 0:
        raise RuntimeError("source entirely outside mesh")

    # global id set
    idrows = [g for g in comm.allgather_rows(
        np.asarray(ids, np.float64)[:, None]) if len(g)]
    gids = (np.unique(np.concatenate(idrows)[:, 0]).astype(np.int64)
            if idrows else np.zeros(0, np.int64))
    L = len(gids)
    out = np.zeros((T, L, 3))
    # time-chunked row exchange: [local L, k*3] blocks (k collective —
    # allgather widths must match across ranks)
    lmax = comm.allreduce_max(len(ids))
    k = max(1, int(chunk_bytes // max(lmax, 1) // 24))
    for s in range(0, T, k):
        kk = min(k, T - s)
        blk = np.concatenate(
            [np.asarray(ids, np.float64)[:, None],
             F[s:s + kk].transpose(1, 0, 2).reshape(len(ids),
                                                    kk * 3)], axis=1)
        for got in comm.allgather_rows(blk):
            if not len(got):
                continue
            p = np.searchsorted(gids, got[:, 0].astype(np.int64))
            np.add.at(out[s:s + kk],
                      (slice(None), p),
                      got[:, 1:].reshape(len(got), kk, 3)
                      .transpose(1, 0, 2))
    return gids.astype(np.int32), out


def shard_slab_tables(params, shard, comm, group):
    """(st, src_forces): the slab tables of this process's ranks built
    from its MeshShard, with the sources located per shard and attached.
    Raises RuntimeError (the same on every process) where the mesh is
    not slab-decomposable or the source does not locate, before any
    solve: callers fall back to the gather_mesh chain."""
    from ..source.model import SourceModel
    from .shardbuild import attach_sources_shard, build_slab_tables_shard

    # the table build decides slab-decomposability BEFORE the source
    # pass (fail fast into the fallback chain)
    st = build_slab_tables_shard(shard, params, comm, group.size,
                                 dev_slice=local_device_slice(group))
    sm = SourceModel.parse(params)
    src_ids, src_forces = compute_forces_multihost(sm, shard, params, comm)
    attach_sources_shard(st, shard, src_ids, comm)
    return st, src_forces


def _solve(path, src_forces, total_steps, dt, chunk, on_chunk=None):
    from .driver import run_multichip
    state, _ = run_multichip(path, src_forces, total_steps, dt, chunk=chunk,
                             on_chunk=on_chunk)
    return state


def run_slab_multihost(st, src_forces, total_steps, dt, group,
                       dtype=torch.float32, chunk=None, pallas=None,
                       on_chunk=None):
    """The slab solve on this process's ranks of ``group`` (st: global
    tables or this process's rows of them, build_slab_tables'
    dev_slice or the shard build).  pallas: the kernel step (K1, K2 or
    K4 per fragment) or the plain SlabStep; None takes the kernels on
    CUDA and the plain step on the CPU.  Returns the ranks' states
    (None at other processes' ranks)."""
    from .driver import SlabPallasPath, SlabXLAPath
    if pallas is None:
        pallas = group.devices[group.local_ranks[0]].type == "cuda"
    cls = SlabPallasPath if pallas else SlabXLAPath
    return _solve(cls(st, group, dtype, None), src_forces, total_steps, dt,
                  chunk, on_chunk)


def run_gslab_multihost(st, src_forces, total_steps, dt, group,
                        dtype=torch.float32, chunk=None, on_chunk=None):
    """The graded stacked-slab solve (gslab.GSlabStep: K1, K2 or K4 per
    brick fragment) on this process's ranks: the multi-process path for
    depth-graded meshes."""
    from .driver import GslabPath
    return _solve(GslabPath(st, group, dtype, None), src_forces,
                  total_steps, dt, chunk, on_chunk)


def run_gmesh_multihost(st, src_forces, total_steps, dt, group,
                        dtype=torch.float32, chunk=None, on_chunk=None):
    """The general graded-mesh solve (gmesh.GMeshStep: any brick plan,
    one [K, 9] interface allsum per step) on this process's ranks: the
    multi-process path for laterally graded meshes."""
    from .driver import GMeshPath
    return _solve(GMeshPath(st, group, dtype, None), src_forces,
                  total_steps, dt, chunk, on_chunk)


def run_shard_slab_pipeline(params, shard, comm, group,
                            dtype=torch.float32, pallas=None):
    """The O(shard) pipeline tail: shard-local slab tables -> slab
    solve, with NO process ever holding the global mesh or global-length
    solver tables (octor.c:4904-6651 + psolve.c:4705-4863 per-rank
    scalability).  Raises RuntimeError when the mesh is not
    slab-decomposable (callers fall back to the gather_mesh chain).
    Returns (st, state)."""
    st, src_forces = shard_slab_tables(params, shard, comm, group)
    return st, run_slab_multihost(st, src_forces, params.total_steps,
                                  params.delta_t, group, dtype,
                                  pallas=pallas)


def structured_tables(mesh, tables, group, src_ids, nprocs):
    """(name, tables) of the gather chain's path, in choose_path's
    order: "slab" (this process's rows: build_slab_tables' dev_slice),
    "gslab", "gmesh", else "sharded" -- refused for more than one
    process.  Only the table builds fall back: an error mid-solve
    propagates."""
    from .gmesh import build_gmesh_tables
    from .gslab import build_gslab_tables
    from .slab import build_slab_tables

    P = group.size
    try:
        return "slab", build_slab_tables(mesh, tables, P, src_ids=src_ids,
                                         dev_slice=local_device_slice(group))
    except RuntimeError:
        pass
    try:
        return "gslab", build_gslab_tables(mesh, tables, P, src_ids=src_ids)
    except RuntimeError:
        pass
    try:
        return "gmesh", build_gmesh_tables(mesh, tables, P, src_ids=src_ids)
    except RuntimeError as e:
        print(f"[multihost] structured decompositions unavailable ({e}); "
              f"using the unstructured sharded path", flush=True)
    if nprocs > 1:
        raise RuntimeError(
            "unstructured sharded fallback is single-process only "
            "(its tables are not built shard-locally); re-mesh to "
            "a slab/gslab/gmesh-decomposable shape for pod runs")
    from .partition import shard_tables
    return "sharded", shard_tables(tables, mesh, P, src_ids=src_ids)


# the kernels a multi-process step can launch
def _counters():
    from ..kernels.bkt_corner_step import bkt_corner_step
    from ..kernels.bkt_step import bkt_step
    from ..kernels.brick_step import brick_step
    return (brick_step, bkt_step, bkt_corner_step)


def _run(group, name, st, src_forces, params, dtype, pallas, N):
    """(state, report) of one solve on this process's ranks: the loop's
    seconds and those of its four chunks (the card synchronised at each
    boundary; the first chunk carries the run's first-call costs), the
    kernel launches, the exchange counts and, across processes, the
    seconds spent in the exchanges."""
    from .driver import ShardedPath
    counters = _counters()
    for c in counters:
        c.launches = 0
    group.reset_counts()
    loc = group.local_ranks
    T = params.total_steps
    chunk = max(1, -(-T // 4))
    marks = []

    def sync():
        for r in loc:
            if group.devices[r].type == "cuda":
                torch.cuda.synchronize(group.devices[r])

    def on_chunk(done, state):
        sync()
        marks.append((done, time.perf_counter()))

    args = (st, src_forces, T, params.delta_t, group, dtype)
    t0 = time.perf_counter()
    if name == "slab":
        state = run_slab_multihost(*args, chunk=chunk, pallas=pallas,
                                   on_chunk=on_chunk)
    elif name == "gslab":
        state = run_gslab_multihost(*args, chunk=chunk, on_chunk=on_chunk)
    elif name == "gmesh":
        state = run_gmesh_multihost(*args, chunk=chunk, on_chunk=on_chunk)
    else:
        state = _solve(ShardedPath(st, group, dtype, N), src_forces, T,
                       params.delta_t, chunk, on_chunk)
    sync()
    t1 = time.perf_counter()
    rep = {"loop_s": t1 - t0, "steps": T,
           "chunks": [[d, t - t0] for d, t in marks],
           "launches": {c.__name__: c.launches for c in counters
                        if c.launches},
           "sent": {r: group.sent[r] for r in loc},
           "phases": {r: group.phases[r] for r in loc}}
    if len(marks) > 1:
        # steps after the first chunk, per step
        rep["ms_per_step_after_first_chunk"] = \
            (marks[-1][1] - marks[0][1]) / (marks[-1][0] - marks[0][0]) * 1e3
    if hasattr(group, "exchange_s"):
        rep["exchange_s"] = group.exchange_s
        rep["exchange_wait_s"] = group.exchange_wait_s
    return state, rep


def _local_umax(state, loc):
    from .driver import _flat
    return max(float(_flat(state[r])[0][0:3].abs().max()) for r in loc)


def _save(save, k, dname, pid, state, loc, gnids, rep):
    """The process's final state (every array of each local rank's
    state, widened to float32 where bfloat16), the slab gather maps and
    the report, under save/case{k}_{dtype}_p{pid}.npz and .json."""
    from .driver import _flat, _host
    os.makedirs(save, exist_ok=True)
    arrs = {}
    for r in loc:
        for i, x in enumerate(_flat(state[r])):
            arrs[f"r{r}_{i}"] = _host(x)
        if gnids is not None:
            arrs[f"g{r}"] = np.asarray(gnids[r])
    base = os.path.join(save, f"case{k}_{dname}_p{pid}")
    np.savez(base + ".npz", **arrs)
    with open(base + ".json", "w") as f:
        json.dump(rep, f)


def run_case(k, cvmdb, physics_in, numerical_in, group, dtypes,
             pallas=None, save=None):
    """One input triple on this process's ranks, as the JAX module's
    main runs it: the O(shard) slab pipeline for several processes
    where the mesh takes it, else the gather chain; one solve per type
    in ``dtypes`` on the same tables."""
    from ..config import load_params
    from ..cvm import CVM
    from ..meshgen import generate_mesh

    nproc = getattr(group, "nproc", 1)
    pid = getattr(group, "pid", 0)
    loc = group.local_ranks
    params = load_params(physics_in, numerical_in)
    setup = {"nproc": nproc, "pid": pid, "ranks": list(loc),
             "P": group.size}
    t0 = time.perf_counter()
    if nproc == 1:
        mesh = generate_mesh(params, CVM(cvmdb))
        setup["mesh_s"] = time.perf_counter() - t0
    else:
        # O(shard) pipeline first: sharded meshing -> shard-local slab
        # tables -> solve, no global mesh on any process
        # (octor.c:4904-6651 scalability).  Non-slab meshes fall
        # through to the gather_mesh chain below.
        from ..mesh.distributed import gather_mesh, generate_mesh_shard
        comm = host_comm()
        shard = generate_mesh_shard(params, CVM(cvmdb), comm)
        setup["mesh_s"] = time.perf_counter() - t0
        setup.update(shard_elements=int(shard.lenum),
                     e_global=int(shard.e_global),
                     shard_nodes=int(len(shard.node_x)),
                     n_global=int(shard.n_global))
        t1 = time.perf_counter()
        try:
            st, src_forces = shard_slab_tables(params, shard, comm, group)
        except RuntimeError as e:
            print(f"[multihost] shard slab pipeline unavailable ({e}); "
                  f"gathering the global mesh", flush=True)
            mesh = gather_mesh(shard, comm)
            setup["gather_s"] = time.perf_counter() - t1
        else:
            setup.update(path="slab", tables_s=time.perf_counter() - t1,
                         table_columns=int(st.inv_mass.shape[-1]),
                         grid=[st.nzp, st.nyp, st.nxp])
            for dtype in dtypes:
                dname = str(dtype).split(".")[-1]
                state, rep = _run(group, "slab", st, src_forces, params,
                                  dtype, pallas, None)
                loc_u = _local_umax(state, loc)
                print(f"[multihost] done (shard slab, O(shard) memory): "
                      f"process {pid} local |u|max = {loc_u:.6e}",
                      flush=True)
                if save:
                    _save(save, k, dname, pid, state, loc,
                          st.gnid_local, {**setup, **rep, "dtype": dname,
                                          "local_umax": loc_u})
            return 0

    return solve_mesh(k, mesh, params, group, dtypes, pallas=pallas,
                      save=save, setup=setup)


def solve_mesh(k, mesh, params, group, dtypes, pallas=None, save=None,
               setup=None):
    """The gather chain on a global mesh (every process holds it):
    assemble, sources, structured_tables' path, one solve per type."""
    from ..solver.assemble import assemble
    from ..source.model import SourceModel

    nproc = getattr(group, "nproc", 1)
    pid = getattr(group, "pid", 0)
    setup = dict(setup or {})
    t1 = time.perf_counter()
    tables = assemble(mesh, params)
    sm = SourceModel.parse(params)
    src_ids, src_forces = sm.compute_forces(mesh, params)
    name, st = structured_tables(mesh, tables, group, src_ids, nproc)
    setup.update(path=name, tables_s=time.perf_counter() - t1,
                 n_global=int(mesh.nnum),
                 bricks=len(getattr(st, "bricks", [None])))
    for dtype in dtypes:
        dname = str(dtype).split(".")[-1]
        state, rep = _run(group, name, st, src_forces, params, dtype,
                          pallas, mesh.nnum)
        umax = _global_umax(name, st, state, group, mesh.nnum)
        if pid == 0:
            tag = {"slab": "", "gslab": " (graded)", "gmesh": " (gmesh)",
                   "sharded": " (unstructured)"}[name]
            print(f"[multihost] done{tag}: |u|max = {umax:.6e}", flush=True)
        if save:
            _save(save, k, dname, pid, state, group.local_ranks,
                  st.gnid_local if name == "slab" else None,
                  {**setup, **rep, "dtype": dname, "umax": umax})
    return 0


def dangling_in_id_order(mesh):
    """A copy of ``mesh`` with its dangling-node tables in node-id
    order, the order ``gather_mesh`` gives them (generate_mesh keeps
    the order it found them in).  Sums over the dangling nodes run in
    table order, so a one-process run matches the gather chain's bit
    for bit only on this copy."""
    import copy
    out = copy.copy(mesh)
    o = np.argsort(mesh.dn_ids, kind="stable")
    out.dn_ids, out.dn_anchors = mesh.dn_ids[o], mesh.dn_anchors[o]
    out.dn_weights = mesh.dn_weights[o]
    return out


def _global_umax(name, st, state, group, N):
    """max |u| of the global field, from every rank's state gathered to
    every process."""
    from .driver import _flat
    from .gmesh import gmesh_u_global
    from .gslab import gslab_u_global
    from .sharded import gather_global as sharded_gather
    from .slab import slab_u_global
    P = group.size
    if name == "slab":
        u = slab_u_global(st, gather_global(
            [None if s is None else _flat(s)[0] for s in state], group), N)
    elif name == "gslab":
        nb = len(st.bricks)
        per = [gather_global([None if s is None else s[0][b] for s in state],
                             group) for b in range(nb)]
        u = gslab_u_global(st, [[per[b][r] for b in range(nb)]
                                for r in range(P)], N)
    elif name == "gmesh":
        nb = len(st.bricks)
        per = [gather_global([None if s is None else s[0][b] for s in state],
                             group) for b in range(nb)]
        loose = gather_global([None if s is None else s[1] for s in state],
                              group)
        u = gmesh_u_global(st, [[per[b][r] for b in range(nb)]
                                for r in range(P)], loose[0], N)
    else:
        u = sharded_gather(st, [s[0] for s in state], N)
    return float(np.abs(u).max())


def main(argv=None):
    """The launcher: `python -m hercules_tpu_torch.parallel.multihost
    --coordinator host0:1234 --nprocs N --pid K [--device cuda|cpu]
    <cvmdb> <physics.in> <numerical.in>` -- every process meshes its
    block and solves its ranks."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--nprocs", type=int, default=1)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--local-ranks", type=int, default=1)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--slab-step", default="auto",
                    choices=("auto", "plain", "kernels"))
    ap.add_argument("--save", default=None)
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)
    if len(args.inputs) % 3:
        ap.error("inputs come in triples: <cvmdb> <physics.in> "
                 "<numerical.in>")
    dtypes = [getattr(torch, d) for d in args.dtype.split(",")]
    pallas = {"auto": None, "plain": False, "kernels": True}[args.slab_step]

    nproc, pid = init_multihost(args.coordinator, args.nprocs, args.pid,
                                device=args.device, backend=args.backend,
                                local_ranks=args.local_ranks)
    devices = local_devices(args.device, nproc, pid, args.local_ranks)
    if devices[0].type == "cuda":
        # load the kernel library outside the timed loops
        from ..kernels import build
        build.lib()
    group = rank_group(devices)
    print(f"[multihost] process {pid}/{nproc}, {len(devices)} local / "
          f"{group.size} global devices", flush=True)
    ins = args.inputs
    for k in range(len(ins) // 3):
        run_case(k, *ins[3 * k:3 * k + 3], group, dtypes, pallas=pallas,
                 save=args.save)
    if nproc > 1:
        import torch.distributed as dist
        dist.barrier(group=host_comm().group)
        dist.destroy_process_group()
        _HOST.clear()
    return 0


def free_port():
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(nprocs, args, timeout=120, env=None, cwd=None):
    """Run ``main`` as nprocs processes on this host (pids 0..n-1, a free
    localhost port as coordinator), each given ``args`` after the
    launcher's own flags, all within ``timeout`` seconds.  Any child's
    failure or the timeout kills the rest.  Returns [(returncode,
    output)] (returncode None for a child killed at the timeout)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    port = free_port()
    logs = [tempfile.TemporaryFile() for _ in range(nprocs)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hercules_tpu_torch.parallel.multihost",
         "--coordinator", f"127.0.0.1:{port}", "--nprocs", str(nprocs),
         "--pid", str(k), *args],
        stdout=logs[k], stderr=subprocess.STDOUT, env=env, cwd=cwd)
        for k in range(nprocs)]
    deadline = time.monotonic() + timeout
    killed = set()
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for k, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
                killed.add(k)
    out = []
    for k, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read().decode(errors="replace")
        f.close()
        out.append((None if k in killed else p.returncode, text))
    return out

if __name__ == "__main__":
    raise SystemExit(main())
