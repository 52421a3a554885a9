"""Entry points of the port: a single-device step check and the
multi-chip dry run.

Counterpart of the root ``__graft_entry__.py``.  Its setup reads the
reference's simple example; this one writes fixture (a), which has the
simple case's material (Vp 6000, Vs 3464, rho 2700), domain (1000 x
1000 x 500 m) and mesh (2048 level-4 elements, 62.5 m), with
``fixtures.write_box_case`` (``tools/makecvm``).

- ``entry(device="cuda", dtype=torch.float32)`` returns ``(fn, args)``:
  ``fn(u, up, srcf) -> (u2, u1)`` is one step of the unstructured step
  (``solver/step.py:make_step``) with one source at the middle
  element's first node, ``args`` its zero state and a unit force.
- ``dryrun_multichip(n, device=None, dtype=torch.float32)`` runs the
  legs of ``_dryrun_impl`` on ``n`` ranks of a ``parallel.ranks``
  group: spread over the visible cards (rank r on card r mod count, so
  every rank on the one card of a one-card machine), or on the CPU with
  ``device="cpu"``.  The JAX function re-executes itself to get n
  virtual CPU devices; the port's ranks need no subprocess.  The legs:

  1. the slab path ("slab_pallas" on CUDA: K1 per fragment; "slab" on
     the CPU, the automatic choice there) and "sharded" through
     ``Simulation.run``, 40 steps with stations, 4-D and plane taps and
     checkpoint writes, then a restart on the slab path;
  2. gslab on the 2-brick depth-graded octree (12 and 10 element
     layers: uneven per-brick z-splits), at min(8, n) ranks, K1 per
     brick fragment;
  3. gmesh on the laterally graded octree (K1 per fragment);
  4. gmesh with BKT damping (K2 per fragment);
  5. sharded nonlinear soil (von Mises) with geostatic loading;
  6. nonlinear soil on gmesh (K1 per fragment, the plastic subset pass
     on every rank);
  7. sharded DRM part 2 replaying a part 1 recorded on one device.

  Where the JAX legs 2-4 drive zero forces for one step, the port's
  drive a point source for ``GRADED_STEPS`` steps with stations at
  three elements, so that their fields can be compared with a
  single-device run.  Each leg prints its ``[dryrun] ...`` line.
  Returns {leg: {"path", "ranks", "elements", "steps", "launches":
  {kernel: launches}, "samples" (legs 1-3)}}.
"""

from __future__ import annotations

import copy
import os
import shutil
import tempfile

import numpy as np
import torch

# steps of the graded legs (2-4), and the force of their point source
GRADED_STEPS = 6
FORCE = 1e8


def _box(root):
    """Fixture (a) at 62.5 m under ``root``, 40 steps, 3 stations, with
    the dry run's outputs (4-D every 10 steps, a plane every 20,
    checkpoints every 20): (cvmdb, physics_in, numerical_in)."""
    from .fixtures import add_output_keys, write_box_case
    paths = write_box_case(root, 62.5, 40, 3)
    add_output_keys(paths[1], paths[2], output_rate=10, planes_rate=20,
                    checkpointing_rate=20)
    return paths


def _simple_setup(root, damping="rayleigh"):
    """(params, mesh, tables) of fixture (a) at 62.5 m with ``damping``,
    written under ``root``."""
    from .config import load_params
    from .cvm import CVM
    from .fixtures import write_box_case
    from .meshgen import generate_mesh
    from .solver.assemble import assemble
    cvmdb, physics, numerical = write_box_case(root, 62.5, 1, 0,
                                               damping=damping)
    p = load_params(physics, numerical)
    mesh = generate_mesh(p, CVM(cvmdb))
    return p, mesh, assemble(mesh, p)


def entry(device="cuda", dtype=torch.float32):
    """One explicit central-difference step of the unstructured solver
    (element stiffness and damping products, the scatter to the nodes,
    the node update) on fixture (a): returns (fn, (u, up, srcf)) with
    fn(u, up, srcf) -> (u2, u1)."""
    from .solver.fused_brick import solver_device
    from .solver.step import init_state, make_step

    device = solver_device(device)
    with tempfile.TemporaryDirectory(prefix="ht_entry_") as root:
        p, mesh, tables = _simple_setup(root)
    nid = int(mesh.elem_lnid[mesh.lenum // 2, 0])
    step, _ = make_step(tables, np.array([nid], np.int32), dtype=dtype,
                        device=device)
    u, up, conv = init_state(tables, dtype, device=device)
    srcf = torch.ones((1, 3), dtype=dtype, device=device)

    def fn(u, up, srcf):
        (u2, u1, _), _ = step((u, up, conv), (srcf, 0))
        return u2, u1

    return fn, (u, up, srcf)


def _counters():
    from .kernels.bkt_chunk import bkt_chunk
    from .kernels.bkt_corner_step import bkt_corner_step
    from .kernels.bkt_node_step import bkt_node_step
    from .kernels.bkt_step import bkt_step
    from .kernels.brick_chunk import brick_chunk
    from .kernels.brick_step import brick_step
    return (brick_step, brick_chunk, bkt_step, bkt_chunk, bkt_node_step,
            bkt_corner_step)


def _launches(before):
    """{kernel: launches since ``before``} (the counts are read, never
    reset)."""
    return {c.__name__: c.launches - before[c.__name__]
            for c in _counters() if c.launches > before[c.__name__]}


def _snapshot():
    return {c.__name__: c.launches for c in _counters()}


def rank_devices(n, device=None):
    """The ranks' devices: rank r on CUDA card r mod the visible count
    (``device`` None or CUDA), or n times the CPU."""
    from .solver.fused_brick import solver_device
    dev = solver_device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n)]


def _setrec(tr, hi, lo, lv):
    return {"lv": lv}


def graded_mesh(kind, p, cvm=None):
    """The dry run's graded octrees (__graft_entry__.py:200-256,
    :328-356), their material from ``cvm`` (with ``p``'s damping):

    - "depth": level 6 (15.625 m) above 187.5 m, level 5 below: 2
      bricks of 12 and 10 element layers;
    - "lateral": level 5 west of 250 m, level 4 east: vertical 2:1
      interfaces;
    - "nonlinear": level 6 above 250 m, level 5 below, with a soft
      corner (Vs 1500 m/s where z < 250 m and x < 250 m) set directly
      (no CVM)."""
    from .etree import morton
    from .material import MeshOrigin, correct_properties
    from .mesh import Octree, extract_mesh

    if kind == "depth":
        def toexpand(tr, hi, lo, lv, rec):
            _, _, z = morton.deinterleave3(hi, lo)
            return lv < np.where(z < 3 * (1 << 26), 6, 5)
    elif kind == "lateral":
        def toexpand(tr, hi, lo, lv, rec):
            x, _, _ = morton.deinterleave3(hi, lo)
            return lv < np.where(x < (1 << 28), 5, 4)
    elif kind == "nonlinear":
        def toexpand(tr, hi, lo, lv, rec):
            _, _, z = morton.deinterleave3(hi, lo)
            return lv < np.where(z < (1 << 28), 6, 5)
    else:
        raise ValueError(f"graded mesh kind {kind!r}")
    tree = Octree.newtree(1000.0, 1000.0, 500.0)
    tree.refine(_setrec, toexpand)
    tree.balance()
    mesh = extract_mesh(tree)
    if kind == "nonlinear":
        ts = mesh.ticksize
        soft = ((mesh.elem_z.astype(np.float64) * ts < 250.0)
                & (mesh.elem_x.astype(np.float64) * ts < 250.0))
        mesh.props = {"Vp": np.where(soft, 3000.0, 6000.0),
                      "Vs": np.where(soft, 1500.0, 3464.0),
                      "rho": np.where(soft, 2300.0, 2700.0)}
    else:
        correct_properties(mesh, cvm, p, MeshOrigin.from_params(p, cvm.ctl))
    return mesh


def leg_sources(mesh, steps=GRADED_STEPS):
    """(src_ids [1], forces [steps, 1, 3], st_nodes [3, 8], st_phi
    [3, 8]) of a graded leg: a point force of FORCE newtons on each
    axis for the first half of the steps at the middle element's first
    node; stations at the centres (phi 1/8) of the middle element and
    of the elements a sixth of the element list before and after it."""
    E = mesh.lenum
    src_ids = np.array([mesh.elem_lnid[E // 2, 0]], np.int32)
    forces = np.zeros((steps, 1, 3))
    forces[:max(1, steps // 2), 0, :] = FORCE
    eidx = np.array([E // 2 - E // 6, E // 2, E // 2 + E // 6])
    return (src_ids, forces, mesh.elem_lnid[eidx].astype(np.int64),
            np.full((3, 8), 0.125))


def nonlinear_config(geostatic, dt=None):
    """The von Mises configurations of legs 5 (k 2e4, every element
    nonlinear, geostatic loading over 5 steps of ``dt`` and a 1-step
    cushion: the JAX leg's 0.005 s and 0.001 s at its 0.001 s step) and
    6 (k 1e3, Vs cut 2000 m/s) (__graft_entry__.py:298-312,
    :347-358)."""
    from .nonlinear import NonlinearConfig
    c = NonlinearConfig()
    c.material_model = "vonmises" if geostatic else "vonMises"
    c.properties_type = "alphakay"
    c.plasticity_type = "rate_independant"
    c.vs_cut = 1e9 if geostatic else 2000.0
    c.vs_min = 0.0
    c.vs_limits = np.array([0.0, 1e10])
    c.alpha_cohes = np.array([0.0, 0.0])
    c.kay_phis = np.full(2, 2e4 if geostatic else 1e3)
    c.strain_rates = np.array([1e-3, 1e-3])
    c.sensitivities = np.array([1.0, 1.0])
    c.hardening = np.array([0.0, 0.0])
    if geostatic:
        c.geostatic_loading_t = 5.5 * dt
        c.geostatic_cushion_t = 1.5 * dt
    return c


DRM_CONFIG = ("drm_directory  = {d}\nwhich_drm_part = {part}\n"
              "drm_edgesize   = 62.5\ndrm_offset_x   = 0\n"
              "drm_offset_y   = 0\ndrm_print_rate = 1\n"
              "part1_delta_t  = {dt!r}\ndrm_boundary =\n"
              "250.0 250.0 750.0 750.0 250.0\n")


def _finite(path, state, what):
    u = np.asarray(path.u_global(state))
    if not np.isfinite(u).all():
        raise RuntimeError(f"dry run: {what} field is not finite")
    return u


def dryrun_multichip(n, device=None, dtype=torch.float32):
    """Run the seven legs on ``n`` ranks (module docstring) and return
    each leg's path, ranks, size and kernel launches."""
    from .config import ConfigFile
    from .cvm import CVM
    from .drm import DRMConfig, DRMRecorder, attach_drm, classify
    from .nonlinear import build_nonlinear_tables
    from .parallel.driver import (GMeshPath, GslabPath, ShardedPath,
                                  run_multichip)
    from .parallel.gmesh import build_gmesh_tables
    from .parallel.gslab import build_gslab_tables
    from .parallel.partition import shard_drm, shard_nonlinear, shard_tables
    from .parallel.ranks import RankGroup
    from .sim import SimOutputs, Simulation
    from .solver.assemble import assemble
    from .solver.step import run_solver

    devs = rank_devices(n, device)
    on_cuda = devs[0].type == "cuda"
    where = (f"{n} ranks on {len(set(devs))} card(s)" if on_cuda
             else f"{n} CPU ranks")
    res = {}

    def note(msg):
        print(f"[dryrun] {msg}", flush=True)

    root = tempfile.mkdtemp(prefix="ht_dryrun_")
    try:
        # ---- (1) the slab and sharded paths through Simulation.run:
        # stations, 4-D and plane taps, checkpoint writes, a restart
        cvmdb, physics, numerical = _box(os.path.join(root, "box"))
        rundir = os.path.dirname(os.path.dirname(physics))
        slab = "slab_pallas" if on_cuda else "slab"

        def mc_run(mc_path):
            sim = Simulation.setup(physics, numerical, cvmdb=cvmdb)
            state, samples = sim.run(
                devices=devs, dtype=dtype, mc_path=mc_path, rundir=rundir,
                outputs=lambda: SimOutputs(sim.mesh, sim.params,
                                           rundir=rundir))
            if sim.solver_path_name != f"mc:{mc_path}":
                raise RuntimeError(f"dry run: {mc_path} ran "
                                   f"{sim.solver_path_name}")
            _finite(sim.mc_path, state, mc_path)
            return sim, samples

        for name in (slab, "sharded"):
            before = _snapshot()
            sim, samples = mc_run(name)
            T = sim.params.total_steps
            if samples.shape[0] != T:
                raise RuntimeError(f"dry run: {name} gave {samples.shape[0]}"
                                   f" sample rows for {T} steps")
            res[f"1 {name}"] = {"path": name, "ranks": n,
                                "elements": sim.mesh.lenum, "steps": T,
                                "launches": _launches(before),
                                "samples": samples}
            note(f"{name} path ok on {where}: {T} steps, stations + 4-D + "
                 f"plane taps, checkpoint writes; launches "
                 f"{res[f'1 {name}']['launches']}")
        for f in ("disp.h4d", os.path.join("planes", "planedisplacements.0"),
                  os.path.join("checkpoints", "checkpoint.out0")):
            if not os.path.exists(os.path.join(rundir, f)):
                raise RuntimeError(f"dry run: {f} was not written")
        ckdir = os.path.join(rundir, "checkpoints")
        shutil.copy(os.path.join(ckdir, "checkpoint.out0"),
                    os.path.join(ckdir, "checkpoint.in"))
        before = _snapshot()
        sim, samples = mc_run(slab)
        if sim.start_step <= 0:
            raise RuntimeError("dry run: the restart did not resume")
        res["1 restart"] = {"path": slab, "ranks": n,
                            "elements": sim.mesh.lenum,
                            "steps": sim.params.total_steps - sim.start_step,
                            "launches": _launches(before)}
        note(f"checkpoint restart ok (resumed at step {sim.start_step} on "
             f"the {slab} path)")

        p = sim.params
        cvm = CVM(cvmdb)
        nd = min(8, n)
        group = RankGroup(devs[:nd])

        # ---- (2)-(4) the graded paths on min(8, n) ranks
        def graded(label, kind, params, build, cls, **kw):
            mesh = graded_mesh(kind, params, cvm)
            tables = assemble(mesh, params)
            sids, forces, st_nodes, st_phi = leg_sources(mesh)
            st = build(mesh, tables, nd, src_ids=sids, **kw)
            path = cls(st, group, dtype, mesh.nnum)
            path.attach_stations(st_nodes, st_phi)
            before = _snapshot()
            state, samples = run_multichip(path, forces, GRADED_STEPS,
                                           params.delta_t)
            _finite(path, state, label)
            res[label] = {"path": path.name, "ranks": nd,
                          "elements": mesh.lenum, "steps": GRADED_STEPS,
                          "launches": _launches(before),
                          "samples": samples}
            return mesh, path

        mesh, path = graded("2 gslab", "depth", p, build_gslab_tables,
                            GslabPath, min_brick_elems=512)
        layers = [int(b.shape[2]) for b in path.st.plan.bricks]
        note(f"gslab path ok on {nd} ranks: graded mesh ({mesh.lenum} "
             f"elems, {len(layers)} bricks of {layers} element layers, "
             f"uneven per-brick z-splits), K1 per brick fragment + plane "
             f"interface sends; launches {res['2 gslab']['launches']}")

        mesh, path = graded("3 gmesh", "lateral", p, build_gmesh_tables,
                            GMeshPath, min_brick_elems=32)
        note(f"gmesh path ok on {nd} ranks: laterally graded mesh "
             f"({mesh.lenum} elems, {len(path.st.bricks)} bricks, "
             f"{path.st.K} interface entries), K1 per brick fragment + "
             f"one-allsum index interface reconciliation; launches "
             f"{res['3 gmesh']['launches']}")

        pb = copy.copy(p)
        pb.type_of_damping = "bkt"
        mesh, path = graded("4 gmesh bkt", "lateral", pb, build_gmesh_tables,
                            GMeshPath, min_brick_elems=32)
        if path.step.tier != "uniform":
            raise RuntimeError(f"dry run: gmesh BKT took the "
                               f"{path.step.tier} tier")
        note(f"gmesh + BKT ok on {nd} ranks: laterally graded mesh with "
             f"attenuation ({mesh.lenum} elems, {len(path.st.bricks)} "
             f"bricks), K2 per brick fragment, memory variables carried "
             f"with no extra exchange; launches "
             f"{res['4 gmesh bkt']['launches']}")

        # ---- (5) sharded nonlinear soil with geostatic loading, on the
        # 62.5 m box
        mesh, tables = sim.mesh, sim.tables
        group_n = RankGroup(devs)
        T = 20
        sids = np.array([mesh.elem_lnid[mesh.lenum // 2, 0]], np.int32)
        forces = np.zeros((T, 1, 3))
        forces[:5, 0, :] = FORCE
        nlt = build_nonlinear_tables(mesh, p,
                                     nonlinear_config(True, p.delta_t))
        ust = shard_tables(tables, mesh, n, src_ids=sids)
        path = ShardedPath(ust, group_n, dtype, mesh.nnum,
                           nl=shard_nonlinear(ust, tables, mesh, p, nlt, n))
        before = _snapshot()
        state, _ = run_multichip(path, forces, T, p.delta_t, chunk=T)
        _finite(path, state, "sharded nonlinear")
        res["5 sharded nonlinear"] = {"path": path.name, "ranks": n,
                                      "elements": mesh.lenum, "steps": T,
                                      "launches": _launches(before)}
        note(f"sharded nonlinear path ok on {where}: von Mises plasticity "
             f"+ geostatic loading, {T} steps, element-partition-sharded "
             f"plastic state")

        # ---- (6) nonlinear soil on gmesh: the plastic subset pass on
        # every rank
        nlmesh = graded_mesh("nonlinear", p)
        nltables = assemble(nlmesh, p)
        nlt2 = build_nonlinear_tables(nlmesh, p, nonlinear_config(False))
        sid2 = np.array([nlmesh.elem_lnid[nlt2.eidx[0], 0]], np.int32)
        gmt = build_gmesh_tables(nlmesh, nltables, nd, src_ids=sid2,
                                 nl_tables=nlt2, params=p)
        if gmt.nl is None:
            raise RuntimeError("dry run: gmesh dropped the nonlinear soil")
        path = GMeshPath(gmt, group, dtype, nlmesh.nnum)
        fz = np.zeros((2, 1, 3))
        fz[0, 0, :] = 1e9
        before = _snapshot()
        state, _ = run_multichip(path, fz, 2, p.delta_t, chunk=2)
        _finite(path, state, "gmesh nonlinear")
        res["6 gmesh nonlinear"] = {"path": path.name, "ranks": nd,
                                    "elements": nlmesh.lenum, "steps": 2,
                                    "launches": _launches(before)}
        note(f"nonlinear soil ok on {nd} ranks via the {path.name} path "
             f"(not sharded): {nlt2.n} von Mises elements, rank-local "
             f"plastic subset passes + index reconciliation; launches "
             f"{res['6 gmesh nonlinear']['launches']}")

        # ---- (7) sharded DRM part 2 from a part 1 recorded on one device
        drmdir = os.path.join(root, "drm")
        os.makedirs(drmdir)

        def drm_cfg(part):
            f = os.path.join(drmdir, f"drm_{part}.in")
            with open(f, "w") as fh:
                fh.write(DRM_CONFIG.format(d=drmdir, part=part,
                                           dt=p.delta_t))
            return DRMConfig.parse(ConfigFile(f))

        plan = classify(mesh, drm_cfg("part1"))
        L = len(plan.node_ids)
        st_nodes = np.zeros((L, 8), np.int64)
        st_nodes[:, 0] = plan.node_ids
        st_phi = np.zeros((L, 8))
        st_phi[:, 0] = 1.0
        _, rec = run_solver(tables, sids, forces, T, p.delta_t,
                            st_nodes=st_nodes, st_phi=st_phi, dtype=dtype,
                            device=devs[0])
        recorder = DRMRecorder(drmdir, plan)
        for s in range(T):
            full = np.zeros((mesh.nnum, 3))
            full[plan.node_ids] = rec[s]
            recorder.record(s, full)
        recorder.close()
        drm = attach_drm(classify(mesh, drm_cfg("part2")), tables, p, drmdir)
        path = ShardedPath(ust, group_n, dtype, mesh.nnum,
                           drm=shard_drm(ust, drm, n))
        before = _snapshot()
        state, _ = run_multichip(path, np.zeros((T, 1, 3)), T, p.delta_t,
                                 chunk=T)
        u = _finite(path, state, "sharded DRM")
        if not np.abs(u).max() > 0:
            raise RuntimeError("dry run: the DRM replay left the field zero")
        res["7 sharded drm"] = {"path": path.name, "ranks": n,
                                "elements": mesh.lenum, "steps": T,
                                "launches": _launches(before)}
        note(f"sharded DRM part 2 path ok on {where}: {L} boundary nodes "
             f"recorded (part 1, one device) and replayed as effective "
             f"forces through the sharded path")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res
