"""End-to-end simulation pipeline on the port: config, CVM, meshing,
tables, source, stations, the time loop on the CUDA kernels, station
files.

Counterpart of ``hercules_tpu/sim.py`` (which imports jax).  The host
stages are the port's copies of the JAX package's numpy modules
(``config``, ``cvm``, ``meshgen``, ``mesh``, ``physics``, ``source``);
``StationSet``, ``setup_stations`` and ``write_station_files`` are
copied from it, ``SimOutputs`` (4-D volume, plane and checkpoint taps)
ported from it; ``read_restart`` is its restart from ``checkpoint.in``.
``Simulation.run`` takes the JAX package's ``solver=`` choice: the
CUDA kernel routes cover every plan ``build_plan`` makes, with
Rayleigh, mass or no damping or BKT (on its three tiers: uniform Q,
general Q with node-basis memory variables, or corner-basis memory
variables): the single-brick routes and the multi-brick mesh route
(the graded meshes, any number of bricks); the plain brick solver
(``solver/brickstep.py``, "bricks") runs a plan the kernels do not take
(another damping name, ``stiffness_calculation_method = conventional``)
and the unstructured solver (``solver/step.py``, "unstructured") a mesh
that does not decompose into bricks.

Nonlinear soil (``nonlinear.py``), the domain reduction method
(``drm.py``: part 0 writes the interface's coordinates at set-up, part 1
records its displacements, part 2 replays the effective forces) and
buildings (``buildings.py``: carved from the mesh, optionally with
prescribed base displacements) run as in the JAX package.  Nonlinear
soil and DRM part 2 take the mesh route (K1 per brick and the subset
pass, ``fused_mesh.attach_nonlinear_mesh`` / ``attach_drm_mesh``) where
its rules take the case, the unstructured solver otherwise; fixed-base
buildings always take the unstructured solver.  ``Simulation.run``
records why a run left the kernel routes (``solver_path_reason``; the
CLI writes it to monitor.txt).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .config import ConfigFile, Params, load_params
from .cvm import CVM, open_material_db
from .mesh.locate import local_coords, locate_points
from .meshgen import generate_mesh
from .physics.consts import critical_dt, critical_dt_factors
from .physics.kmats import XI
from .source.model import SourceModel, compute_domain_coords_linearinterp

from .solver.assemble import assemble
from .utils.timers import GLOBAL_TIMERS, measure

@dataclass
class StationSet:
    ids: np.ndarray          # [S] original station indices
    nodes: np.ndarray        # [S, 8] node ids to interpolate
    phi: np.ndarray          # [S, 8] trilinear weights
    coords: np.ndarray       # [S, 3] domain coords
    eidx: np.ndarray = None  # [S] containing element indices


def setup_stations(mesh, params: Params) -> Optional[StationSet]:
    """read_stations_info + setup_stations_data (psolve.c:6447-6673):
    lat/lon -> domain coords via the surface-corner bilinear map, element
    search, local coords, phi weights."""
    if not params.number_output_stations or params.stations is None:
        return None
    lat = params.stations[:, 0]
    lon = params.stations[:, 1]
    depth = params.stations[:, 2].copy()
    if mesh.buildings is not None:
        depth = depth + mesh.buildings.surface_shift
    x, y = compute_domain_coords_linearinterp(
        lon, lat, params.domain_surface_corners[:, 0],
        params.domain_surface_corners[:, 1],
        params.region_length_east_m, params.region_length_north_m)
    found, eidx = locate_points(mesh, x, y, depth)
    keep = np.flatnonzero(found)
    if len(keep) == 0:
        return None
    eidx = eidx[keep]
    cx, cy, cz = local_coords(mesh, eidx, x[keep], y[keep], depth[keep])
    phi = ((1 + XI[0][None, :] * cx[:, None])
           * (1 + XI[1][None, :] * cy[:, None])
           * (1 + XI[2][None, :] * cz[:, None]) / 8.0)
    return StationSet(ids=keep.astype(np.int32),
                      nodes=mesh.elem_lnid[eidx],
                      phi=phi,
                      coords=np.stack([x[keep], y[keep], depth[keep]], 1),
                      eidx=eidx)


def write_station_files(outdir, stations: StationSet, samples, dt,
                        print_rate=1, velocities=False,
                        accelerations=False, start_step=0,
                        nl_extras=None):
    """Reference station text format (psolve.c:6636-6795): header line
    then time + displacement per step, with optional velocity and
    acceleration columns.

    The reference computes v = (tm1 - tm2)/dt and a = (tm1 - 2 tm2 +
    tm3)/dt^2 in-loop; since row s holds u(s), the same finite
    differences apply to the recorded series.

    start_step > 0 (checkpoint restart): samples[0] is the field at
    `start_step`; rows are appended to the existing files on the
    absolute print_rate grid.

    nl_extras: {station id: [T, 17]} nonlinear strain/stress columns
    (print_nonlinear_stations, nonlinear.c:2078-2228)."""
    os.makedirs(outdir, exist_ok=True)
    T = samples.shape[0]
    if accelerations:
        velocities = True
    a0 = ((start_step + print_rate - 1) // print_rate) * print_rate
    for k, sid in enumerate(stations.ids):
        path = os.path.join(outdir, f"station.{int(sid)}")
        extra = None if nl_extras is None else nl_extras.get(int(sid))
        with open(path, "a" if start_step else "w") as f:
            if not start_step:
                f.write("#  Time(s)         X|(m)         Y-(m)"
                        "         Z.(m)")
                if velocities:
                    f.write("       X|(m/s)       Y-(m/s)       Z.(m/s)")
                if accelerations:
                    f.write("      X|(m/s2)      Y-(m/s2)      Z.(m/s2)")
                if extra is not None:
                    from .nonlinear import NL_STATION_HEADER
                    f.write(NL_STATION_HEADER)
            u = samples[:, k, :]

            def at(s):
                return u[s] if s >= 0 else np.zeros(3)

            for ab in range(a0, start_step + T, print_rate):
                s = ab - start_step
                t = dt * ab
                f.write("\n%10.6f % 8e % 8e % 8e"
                        % (t, u[s, 0], u[s, 1], u[s, 2]))
                if velocities:
                    v = (u[s] - at(s - 1)) / dt
                    f.write(" % 8e % 8e % 8e" % (v[0], v[1], v[2]))
                if accelerations:
                    a = (u[s] - 2 * at(s - 1) + at(s - 2)) / (dt * dt)
                    f.write(" % 8e % 8e % 8e" % (a[0], a[1], a[2]))
                if extra is not None:
                    f.write("".join(" % 8e" % v for v in extra[s]))
            f.write("\n")


def _flat(tree):
    """The tensors of a nest of tuples, in order, Nones dropped."""
    if tree is None:
        return ()
    if isinstance(tree, (tuple, list)):
        return tuple(x for t in tree for x in _flat(t))
    return (tree,)


def _host(t):
    """A host copy of a state tensor, bfloat16 widened to float32
    (exactly: numpy has no bfloat16).  A copy, because the routes
    reuse their buffers while the writers' threads still hold it."""
    dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dt, copy=True).numpy()


class SimOutputs:
    """Per-run output taps: 4-D volume files, plane files, checkpoints
    (hercules_tpu/sim.py:SimOutputs).

    Every tap fires at a chunk boundary, with the state at that step:
    the solver runs in chunks of the greatest common divisor of the
    active rates (the reference taps at loop top with the displacement
    of the previous update -- equivalent at rate boundaries).  The
    JAX package's snapshots from inside its scan (``snap_every``), a
    device for large TPU dispatches, have no counterpart here: a chunk
    kernel's launch covers one tap interval."""

    def __init__(self, mesh, params, rundir="."):
        self.mesh = mesh
        self.params = params
        self._rundir = rundir
        self.out4d = []
        self.planes = None
        self.ckpt_dir = None
        rates = []
        p = params

        def absdir(d):
            return d if os.path.isabs(d) else os.path.join(rundir, d)

        if p.output_displacement or p.output_velocity:
            from .io.output4d import Output4D
            if p.output_displacement:
                path = absdir(p.output_displacement_file)
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self.out4d.append(("displacement",
                                   Output4D(path, mesh, p,
                                            "displacement")))
            if p.output_velocity:
                path = absdir(p.output_velocity_file)
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self.out4d.append(("velocity",
                                   Output4D(path, mesh, p, "velocity")))
            rates.append(p.output_rate)
        if p.number_output_planes:
            from .io.planes import PlaneSet
            self.planes = PlaneSet(mesh, p, absdir(p.planes_dir or
                                                   "planes"))
            rates.append(p.planes_print_rate)
        if p.use_checkpoint and p.checkpointing_rate:
            self.ckpt_dir = absdir(p.checkpoint_path or "checkpoints")
            rates.append(p.checkpointing_rate)
        self.active = bool(rates)
        self._gcd = math.gcd(*rates) if rates else 0

    def chunk_for(self, desired=1000):
        """Chunk size: the gcd of the active rates, so that every tap
        falls on a chunk boundary; ``desired`` when no tap is on."""
        return self._gcd or desired

    def make_hook(self, plan, inner=None, start_step=0, concat=False):
        """on_chunk(done, state) of the run: the taps at their rates,
        then ``inner``.  ``state`` is the route's view: (u, up[, conv[,
        conv_mix]]) of one brick (fused_brick.packed_snap_of), the mesh
        state (Ss, convs, lconv), with ``concat`` the plain brick
        solver's (u, up, conv) over the plan's concatenated columns
        [3, TOT], or with ``plan`` None the unstructured solver's
        global (u [N, 3], up, conv) (the JAX package's slot_global)."""
        from .solver.fused_brick import pallas_u_global
        from .solver.fused_mesh import mesh_conv_flat, mesh_u_global
        N = self.mesh.nnum

        def views(state):
            """(u rows, u- rows, flat memory variables) of a state."""
            if isinstance(state[0], tuple):
                Ss = state[0]
                return ([S[0:3] for S in Ss], [S[3:6] for S in Ss],
                        mesh_conv_flat(state))
            return state[0], state[1], _flat(state[2:])

        gnid = {}           # plan.gnid_cat on a device, copied once

        def index_on(dev):
            if dev not in gnid:
                gnid[dev] = torch.as_tensor(plan.gnid_cat, device=dev)
            return gnid[dev]

        def global_of(rows):
            if plan is None:
                return _host(rows)
            if isinstance(rows, list):
                return mesh_u_global(plan, rows, N, index_on(rows[0].device))
            return pallas_u_global(plan, rows, N, index_on(rows.device))

        gather = []         # the planes' NodeGather, made once
        gathers = plan is not None and not concat

        def plane_values(u_rows):
            if not gather:
                gather.append(NodeGather(plan, self.planes.all_nodes, N))
            return gather[0](u_rows)

        self._zero_records(start_step)

        def taps(done, state):
            u_rows, up_rows, tail = views(state)
            memo = {}

            def ug(which=0):
                """The global [N, 3] u (0) or u- (1), made once."""
                if which not in memo:
                    memo[which] = global_of((u_rows, up_rows)[which])
                return memo[which]

            # a plane record alone gathers its corners where the state
            # lies (the kernel routes); else it reads the global field
            corners = ((lambda nodes: plane_values(u_rows)) if gathers
                       else (lambda nodes: ug()[nodes]))
            self._taps(done, ug, corners,
                       lambda: tuple(_host(x) for x in tail), {})

        return self._hook(taps, inner)

    def make_mc_hook(self, path, inner=None, start_step=0):
        """on_chunk(done, state) of a multi-chip run
        (hercules_tpu/sim.py:SimOutputs.make_mc_hook): the taps read the
        global fields the path assembles from its ranks (``path.u_global``
        / ``up_global``), and a checkpoint keeps the path's carry tail
        (``path.tail``: rank-stacked arrays) with the path's name and
        rank count, so that a resume can check them; then ``inner``."""

        def taps(done, state):
            memo = {}

            def ug(which=0):
                if which not in memo:
                    memo[which] = (path.u_global, path.up_global)[which](
                        state)
                return memo[which]

            self._taps(done, ug, lambda nodes: ug()[nodes],
                       lambda: path.tail(state),
                       {"mc_path": np.asarray(path.name),
                        "mc_ndev": np.asarray(path.n_dev)})

        self._zero_records(start_step)
        return self._hook(taps, inner)

    @staticmethod
    def _hook(taps, inner):
        """on_chunk(done, state): taps(done, state), then inner."""
        def hook(done, state):
            # the taps' host time (device-to-host copies, global fields,
            # plane sampling, queueing), beside the writers' own
            # io_seconds
            with GLOBAL_TIMERS.span("Solver output taps"):
                taps(done, state)
            if inner is not None:
                inner(done, state)

        return hook

    def _zero_records(self, start_step):
        """The step-0 records (the reference's loop-top output of the
        zero initial field); skipped on checkpoint restart."""
        if start_step == 0:
            zero = np.zeros((self.mesh.nnum, 3))
            for kind, w in self.out4d:
                w.maybe_write(0, zero)
            if self.planes is not None:
                self.planes.maybe_write(
                    0, lambda nodes, phi: np.zeros((len(nodes), 3)))

    def _taps(self, done, ug, corners, tail, extra):
        """The taps due at step ``done``: ug(0) / ug(1) the global [N, 3]
        u and u- (each made once), corners(nodes) a plane record's
        corner values where no global field is made at this step, tail()
        the checkpoint's memory variables, ``extra`` entries the
        checkpoint adds to the damping and the nonlinear presence."""
        p = self.params
        due4d = [(kind, w) for kind, w in self.out4d
                 if done % w.rate == 0 and done // w.rate < w.out_steps]
        due_ck = (self.ckpt_dir is not None
                  and done % p.checkpointing_rate == 0)
        for kind, w in due4d:
            if kind == "displacement":
                w.maybe_write(done, ug())
            else:
                w.maybe_write(done, (ug() - ug(1)) / p.delta_t)
        if (self.planes is not None and done < p.total_steps
                and done % p.planes_print_rate == 0):
            # the corners from the global field where one is made at
            # this step, else gathered alone (the same values)
            def sampler(nodes, phi):
                un = ug()[nodes] if due4d or due_ck else corners(nodes)
                return np.einsum("mk,mkc->mc", phi, un)

            self.planes.maybe_write(done, sampler)
        if due_ck:
            from .io.checkpoint import checkpoint_write_async
            # canonical global [N, 3] fields on every route; the memory
            # variables in the route's own layout
            checkpoint_write_async(
                self.ckpt_dir, done, (ug(), ug(1), tail()),
                extra={"damping": np.asarray(p.type_of_damping),
                       "has_nl": np.asarray(bool(p.include_nonlinear)),
                       **extra})

    def close(self):
        if self.ckpt_dir is not None:
            from .io.checkpoint import checkpoint_flush
            checkpoint_flush()
        for _, w in self.out4d:
            w.close()
        if self.out4d and self.params.output_stats_file:
            path = self.params.output_stats_file
            if not os.path.isabs(path):
                path = os.path.join(self._rundir, path)
            self.out4d[0][1].write_stats(path)
        if self.planes is not None:
            self.planes.close()


class NodeGather:
    """u at the global nodes ``nodes`` (ids < N, any shape), read from a
    state where it lies: only those nodes reach the host.

    Each node's array of fused_mesh.mesh_spans (a single brick's state
    is array 0) and column there are found once; a node held by several
    arrays is read from the last, as mesh_u_global writes it, and a
    node of no array reads zero.  So the values are the global field's
    at those nodes, bit for bit."""

    def __init__(self, plan, nodes, N):
        from .solver.fused_mesh import mesh_spans
        g, inv = np.unique(np.asarray(nodes), return_inverse=True)
        arr_of = np.full(N, -1)
        col_of = np.zeros(N, np.int64)
        for a, (off, n, _) in enumerate(mesh_spans(plan)):
            arr_of[plan.gnid_cat[off:off + n]] = a
            col_of[plan.gnid_cat[off:off + n]] = np.arange(n)
        self.n, self.inv = len(g), inv.reshape(np.shape(nodes))
        self.parts = []     # (array, indices among g, columns)
        for a in np.unique(arr_of[g]):
            at = np.flatnonzero(arr_of[g] == a)
            if a >= 0:
                self.parts.append((int(a), at, col_of[g[at]]))
        self._on = {}       # the parts' indices on a device

    def __call__(self, rows):
        """u [nodes' shape + (3,)] (numpy) from the u rows of one
        brick's state [3, LEN] or of every array of a mesh state."""
        rows = rows if isinstance(rows, list) else [rows]
        dev = rows[0].device
        if dev not in self._on:
            self._on[dev] = [(a, torch.as_tensor(at, device=dev),
                              torch.as_tensor(cols, device=dev))
                             for a, at, cols in self.parts]
        vals = rows[0].new_zeros((self.n, 3))
        for a, at, cols in self._on[dev]:
            vals[at] = rows[a][:3, cols].T
        return vals.cpu().numpy()[self.inv]


def read_restart(params, rundir="."):
    """(start_step, restart.Checkpoint or None): the state in
    ``checkpoint.in`` of the run's checkpoint directory when
    use_checkpoint = 1 and the file is there (psolve.c:4248), after
    checking the damping and the nonlinear presence it was written
    with against this run's."""
    from .io.checkpoint import checkpoint_read
    from .solver.restart import Checkpoint
    p = params
    if p.use_checkpoint != 1:
        return 0, None
    ckdir = p.checkpoint_path or "checkpoints"
    if not os.path.isabs(ckdir):
        ckdir = os.path.join(rundir, ckdir)
    ckin = os.path.join(ckdir, "checkpoint.in")
    if not os.path.exists(ckin):
        return 0, None
    start_step, u_now, u_prev, conv, extras = checkpoint_read(ckin)
    if "damping" in extras:
        ck_damp = str(extras["damping"])
        if ck_damp != p.type_of_damping:
            raise RuntimeError(f"checkpoint was written with damping="
                               f"{ck_damp}; this run uses "
                               f"{p.type_of_damping}")
    if "has_nl" in extras:
        ck_nl = bool(extras["has_nl"])
        if ck_nl != bool(p.include_nonlinear):
            raise RuntimeError(f"checkpoint nonlinear presence ({ck_nl}) "
                               f"does not match this run "
                               f"({bool(p.include_nonlinear)})")
    return start_step, Checkpoint(u_now, u_prev, tuple(conv), extras)


def check_mc_tail(ck, name="", ndev=0):
    """Raise unless a checkpoint's carry tail (memory variables, plastic
    state) is shaped for this run: the multi-chip path ``name`` on
    ``ndev`` ranks, or ("", 0) a single-device route.  A checkpoint
    with no tail (displacements only) fits any path and rank count
    (hercules_tpu/sim.py:1052-1063)."""
    if ck is None or not ck.conv:
        return
    mcp = str(ck.extras.get("mc_path", ""))
    mcn = int(ck.extras.get("mc_ndev", 0))
    if (mcp, mcn) != (name, ndev):
        raise RuntimeError(
            f"checkpoint carry tail is shaped for path="
            f"{mcp or 'single-device'}/ndev={mcn or 1}; this run uses "
            f"{name or 'single-device'}/ndev={ndev or 1} (only "
            f"displacement-only checkpoints are layout-elastic)")


@dataclass
class Simulation:
    params: Params
    cvm: CVM
    mesh: object
    tables: object
    source: SourceModel
    src_ids: np.ndarray
    src_forces: np.ndarray
    stations: Optional[StationSet]
    # which route ran the last .run(): "cuda_chunk" (brick_chunk),
    # "cuda_step" (brick_step per step), "cuda_bkt_chunk" (bkt_chunk),
    # "cuda_bkt_step" (bkt_step per step), "cuda_bkt_node_step"
    # (bkt_node_step per step, the mixed elements included),
    # "cuda_bkt_corner_step" (bkt_corner_step per step), "cuda_mesh"
    # (a multi-brick plan: each brick's step kernel per step, the
    # interfaces reconciled between), "torch_plain" (the single-brick
    # or the mesh route on the plain versions, on the CPU), "bricks"
    # (the plain brick solver, brickstep.run_brick_solver) or
    # "unstructured" (step.run_solver); the last two as the JAX
    # package names them, on either device
    solver_path_name: str = ""
    # the step the last .run() started from (a checkpoint's, else 0)
    start_step: int = 0
    # nonlinear soil (nonlinear.NLTables), the DRM classification
    # (drm.DRMPlan) and its directory, when the run has them
    nl_tables: object = None
    drm_plan: object = None
    drm_dir: str = ""
    # why the last .run() took the unstructured solver where the kernel
    # routes were asked for or would be the default ("" otherwise)
    solver_path_reason: str = ""
    # {station id: [T, 17]}: the nonlinear columns of the stations in
    # nonlinear elements, from the last .run()
    nl_station_extras: dict = dataclasses.field(default_factory=dict)
    # the multi-chip path (parallel/driver.py) of the last .run() with
    # ndev > 1; solver_path_name is then "mc:<its name>"
    mc_path: object = None
    # the mesh's brick plans by storage order (brick_plan)
    _plans: dict = dataclasses.field(default_factory=dict, repr=False)

    def brick_plan(self, legacy_axes=False):
        """The mesh's brick plan (solver/bricks.build_plan at its default
        brick floor): the default storage axes, which the single-device
        routes and gmesh read, or with legacy_axes the (z, y, x) order
        the slab paths and gslab pin; built once per order and kept,
        since the mesh does not change."""
        if legacy_axes not in self._plans:
            from .solver.bricks import build_plan
            self._plans[legacy_axes] = build_plan(self.mesh,
                                                  legacy_axes=legacy_axes)
        return self._plans[legacy_axes]

    @classmethod
    def setup(cls, physics_in, numerical_in=None, cvmdb=None,
              verbose=False):
        """hercules_tpu.sim.Simulation.setup: the buildings parsed
        before meshing, the nonlinear tables, the DRM classification and
        its part-0 files."""
        with GLOBAL_TIMERS.span("Read parameters"):
            params = load_params(physics_in, numerical_in)
        rundir = os.path.dirname(os.path.dirname(
            os.path.abspath(physics_in))) or "."
        if cvmdb is None:
            cvmdb = params.cvmdb_input_file
            if cvmdb and not os.path.isabs(cvmdb):
                cvmdb = os.path.join(rundir, cvmdb)
        with GLOBAL_TIMERS.span("Material db open"):
            cvm = open_material_db(cvmdb, params)
        buildings = None
        if params.include_buildings:
            from .buildings import Buildings
            buildings = Buildings.parse(ConfigFile(params.numerical_path))
        mesh = generate_mesh(params, cvm, buildings=buildings,
                             verbose=verbose)
        tcrit = critical_dt(mesh.props, mesh.edge_m)
        _, dt_x, dt_z = critical_dt_factors(mesh.props, mesh.edge_m,
                                            params)
        tstab = min(dt_x, dt_z)
        if verbose:
            print(f"mesh: {mesh.lenum} elements, {mesh.nnum} nodes, "
                  f"{len(mesh.dn_ids)} dangling; "
                  f"critical dt {tcrit:.6f} (damped stability bound "
                  f"{tstab:.6f})")
        if getattr(params, "auto_delta_t", 0):
            params.delta_t = tcrit
            params.total_steps = int(
                (params.end_time - params.start_time) / params.delta_t)
            if verbose:
                print(f"AUTO_DELTA_T: delta_t = {tcrit:.6g}, "
                      f"{params.total_steps} steps")
        elif params.delta_t > tstab:
            print(f"WARNING: delta_t {params.delta_t:g} exceeds the "
                  f"damped stability bound {tstab:g} "
                  f"(min dt_X {dt_x:g}, min dt_Z {dt_z:g}); the "
                  f"explicit integration will be unstable",
                  file=sys.stderr)
        with GLOBAL_TIMERS.span("Solver assemble"):
            tables = assemble(mesh, params)
        shift = buildings.surface_shift if buildings is not None else 0.0
        with GLOBAL_TIMERS.span("Source forces"):
            source = SourceModel.parse(params, surface_shift=shift)
            src_ids, src_forces = source.compute_forces(mesh, params)
        with GLOBAL_TIMERS.span("Stations locate"):
            stations = setup_stations(mesh, params)
        sim = cls(params=params, cvm=cvm, mesh=mesh, tables=tables,
                  source=source, src_ids=src_ids, src_forces=src_forces,
                  stations=stations)
        if params.include_nonlinear:
            from .nonlinear import NonlinearConfig, build_nonlinear_tables
            cfg = NonlinearConfig.parse(ConfigFile(params.numerical_path))
            sim.nl_tables = build_nonlinear_tables(mesh, params, cfg)
        if params.implement_drm:
            from .drm import DRMConfig, classify, write_coords, write_info
            dcfg = DRMConfig.parse(ConfigFile(params.numerical_path))
            sim.drm_plan = classify(mesh, dcfg, surface_shift=shift)
            ddir = dcfg.directory
            if not os.path.isabs(ddir):
                ddir = os.path.join(rundir, ddir)
            sim.drm_dir = ddir
            if dcfg.part == "part0":
                write_coords(ddir, sim.drm_plan)
                write_info(ddir, sim.drm_plan)
                if verbose:
                    print(f"DRM part0: {len(sim.drm_plan.node_ids)} "
                          f"interface nodes written to {ddir}")
        return sim

    def run(self, device="cuda", dtype=None, chunk=None, total_steps=None,
            on_chunk=None, outputs=None, rundir=".", restart=None,
            solver="auto", ndev=None, mc_path=None, devices=None):
        """The time loop on ``device`` in ``dtype`` (float32 on CUDA and
        float64 on the CPU by default), on the route ``solver`` names
        (the JAX package's choice, hercules_tpu/sim.py:498-506):

        - "pallas": the CUDA kernel routes (the JAX package's fused
          route; their plain versions on the CPU).  A plan of one brick
          with no loose elements takes the single-brick routes
          (fused_brick.run_pallas_solver; BKT on the first tier that
          holds the brick), which return ((u, up[, conv[, conv_mix]])
          tensors, samples [T, ns, 3] numpy); every other plan (several
          bricks, or one brick with loose elements), and every plan
          with nonlinear soil or DRM part 2, the mesh route
          (fused_mesh.run_mesh_solver: (Ss, convs, lconv[, nl_state]),
          samples).  Raises where the kernel routes do not take the
          case (route_reason);
        - "bricks": the plain brick solver (brickstep.run_brick_solver:
          (u, up, conv) over the plan's concatenated columns); raises
          if the mesh does not decompose into bricks;
        - "unstructured": step.run_solver ((u, up, conv[, nl_state]),
          global);
        - "auto": the kernel routes where they take the case, else the
          route that route_reason names with its reason (a damping name
          the kernels do not run, which the JAX package runs undamped,
          or stiffness_calculation_method = conventional, the merged-K
          evaluation the JAX package pins to its XLA paths: the plain
          brick solver; a mesh that does not decompose into bricks,
          fixed-base buildings, or nonlinear soil or DRM part 2 on a
          plan the mesh route's rules refuse: the unstructured solver).
          ``self.solver_path_reason`` keeps the reason.

        Nonlinear soil adds one-hot rows for the corners of the stations
        in nonlinear elements, whose plastic recursion is replayed on
        the host after the run (``self.nl_station_extras``); DRM part 1
        samples the interface nodes in the loop and streams them to
        the part-1 files; part 2 adds the replayed effective forces;
        fixed-base buildings prescribe their base nodes' displacements.

        ``ndev`` > 1 runs the multi-chip pipeline (``_run_multichip``:
        a path of ``parallel/`` on ``ndev`` ranks,
        rank r on ``devices[r]``), never a single-device route; ndev
        None reads HT_NDEV (unset: one device), or is len(devices) when
        ``devices`` is given.  ``devices`` defaults to the first ndev
        CUDA devices (RuntimeError if fewer are visible), or ndev times
        the CPU when ``device`` is the CPU; one card can hold every rank
        ([cuda:0] * ndev).  ``mc_path`` forces a path ("slab",
        "slab_pallas", "gslab", "gmesh", "sharded"; one that does not
        take the mesh raises its table function's reason).  ``solver`` must
        then be "auto".

        ``outputs``: a SimOutputs whose taps (4-D volume, planes,
        checkpoints) fire at chunks of the gcd of their rates, or a
        callable that makes one, called once the route is chosen and the
        checkpoint is read and checked (so that a refused run opens no
        output file); it is closed when the loop ends.  With
        use_checkpoint = 1 and a ``checkpoint.in`` in the checkpoint
        directory (relative to
        ``rundir``), the run resumes from it (read_restart) and
        ``self.start_step`` is its step: the samples then cover steps
        [start_step, total_steps).  ``restart``: read_restart's result
        when the caller read it already (the CLI does, before it opens
        the output files, so that a refused checkpoint touches none)."""
        from .solver.brickstep import run_brick_solver
        from .solver.fused_brick import plan_applies, run_pallas_solver
        from .solver.fused_mesh import (attach_drm_mesh,
                                        attach_nonlinear_mesh,
                                        run_mesh_solver)
        from .solver.step import attach_nonlinear, run_solver

        if solver not in SOLVERS:
            raise ValueError(f"solver={solver!r}; expected one of "
                             f"{', '.join(SOLVERS)}")
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if ndev is None:
                ndev = len(devices)
            elif ndev != len(devices):
                raise ValueError(f"ndev={ndev} with {len(devices)} devices")
            device = devices[0]
        if ndev is None:
            env = os.environ.get("HT_NDEV")
            ndev = int(env) if env else 0
        if ndev > 1 and solver != "auto":
            raise ValueError(f"solver={solver!r} names a single-device "
                             f"route; ndev={ndev} runs the multi-chip "
                             f"paths (mc_path=)")
        if ndev <= 1 and (mc_path is not None or devices is not None):
            raise ValueError("mc_path and devices need ndev > 1")
        device = torch.device(device)
        if dtype is None:
            dtype = torch.float32 if device.type == "cuda" else \
                torch.float64
        p = self.params
        steps = total_steps if total_steps is not None else p.total_steps
        st = self.stations
        st_nodes = None if st is None else st.nodes
        st_phi = None if st is None else st.phi

        # stations inside nonlinear elements get one-hot corner rows,
        # so that the plastic state can be replayed on the host after
        # the run (nonlinear_stations_init, nonlinear.c:1947-2045)
        n_st = 0 if st is None else len(st.ids)
        nl_st_rows = []
        if self.nl_tables is not None and st is not None:
            nlset = set(self.nl_tables.eidx.tolist())
            nl_st_rows = [j for j in range(n_st)
                          if int(st.eidx[j]) in nlset]
            if nl_st_rows:
                st_nodes = np.concatenate(
                    [st.nodes, np.repeat(st.nodes[nl_st_rows], 8, axis=0)])
                st_phi = np.concatenate(
                    [st.phi, np.tile(np.eye(8), (len(nl_st_rows), 1))])

        drm = drm_rec = on_samples = None
        if self.drm_plan is not None:
            dcfg = self.drm_plan.cfg
            if dcfg.part == "part2":
                from .drm import attach_drm
                drm = attach_drm(self.drm_plan, self.tables, p,
                                 self.drm_dir)
            elif dcfg.part == "part1":
                from .drm import DRMRecorder
                drm_rec = DRMRecorder(self.drm_dir, self.drm_plan)
                # step-0 record of the zero initial field (the
                # reference records at loop top, steps 0..T-1)
                drm_rec.record(0, np.zeros((self.mesh.nnum, 3)))
                # the interface nodes sampled in the loop, one-hot (all
                # 8 slots the same node), streamed to the part-1 files
                # chunk by chunk through on_samples
                ids = np.asarray(self.drm_plan.node_ids)
                dn_ = np.repeat(ids[:, None], 8, axis=1).astype(np.int32)
                dphi_ = np.zeros((len(ids), 8))
                dphi_[:, 0] = 1.0
                r0 = 0 if st_nodes is None else len(st_nodes)
                st_nodes = (dn_ if st_nodes is None
                            else np.concatenate([st_nodes, dn_]))
                st_phi = (dphi_ if st_phi is None
                          else np.concatenate([st_phi, dphi_]))
                rate = max(int(dcfg.print_rate), 1)

                def on_samples(s0, ys):
                    for i in range(ys.shape[0]):
                        ab = s0 + i
                        if ab and ab % rate == 0:
                            drm_rec.record_rows(ab, ys[i, r0:])
                    return ys[:, :r0]

        # fixed-base buildings: the prescribed base displacement series
        # (bldgs_load_fixedbase_disps, buildings.c:975-1146)
        fb_ids = fb_series = None
        bld = getattr(self.mesh, "buildings", None)
        if bld is not None and bld.fixed_base:
            fb_ids, which = bld.base_nodes(self.mesh)
            fb_series = bld.base_disp_series(
                p.end_time - p.start_time, p.delta_t, steps,
                rundir=rundir)[:, which, :]

        def on_route(name):
            self.solver_path_name = name

        made = outputs
        make_outputs = made if callable(made) else lambda: made
        outputs = None
        try:
            if ndev > 1:
                state, samples = self._run_multichip(
                    ndev, devices, device, dtype, chunk, steps, on_chunk,
                    make_outputs, rundir, restart, st_nodes, st_phi, mc_path,
                    drm, on_samples, fb_ids, fb_series)
                return state, self._replay_nl_stations(samples, nl_st_rows,
                                                       n_st)
            route, plan, reason = self.route(solver, drm=drm,
                                             fixed_base=fb_ids is not None)
            self.solver_path_reason = reason
            self.start_step, ck = (read_restart(p, rundir)
                                   if restart is None else restart)
            check_mc_tail(ck)
            outputs = make_outputs()
            hook = on_chunk
            if outputs is not None and outputs.active:
                chunk = outputs.chunk_for(chunk or 1000)
                hook = outputs.make_hook(
                    None if route == "unstructured" else plan, on_chunk,
                    start_step=self.start_step, concat=route == "bricks")
            kw = dict(st_nodes=st_nodes, st_phi=st_phi, dtype=dtype,
                      device=device, chunk=chunk, on_chunk=hook,
                      start_step=self.start_step, on_samples=on_samples)
            args = (self.tables, self.src_ids, self.src_forces, steps,
                    p.delta_t)
            if route == "pallas":
                state, samples = run_pallas_solver(
                    plan, *args, on_route=on_route, state=ck, **kw)
            elif route == "mesh":
                with measure("Solver tables", device):
                    mesh_nl = (None if self.nl_tables is None else
                               attach_nonlinear_mesh(
                                   self.mesh, p, self.tables,
                                   self.nl_tables, plan, dtype, device))
                    mesh_drm = (None if drm is None else attach_drm_mesh(
                        drm, plan, self.tables, dtype, device))
                state, samples = run_mesh_solver(
                    plan, *args, on_route=on_route, state=ck, nl=mesh_nl,
                    drm=mesh_drm, **kw)
            elif route == "bricks":
                state = (None if ck is None else
                         _brick_restart_state(plan, self.tables.damping,
                                              ck, dtype, device))
                on_route("bricks")
                state, samples = run_brick_solver(plan, *args, state=state,
                                                  **kw)
            else:
                nl = None
                if self.nl_tables is not None:
                    with measure("Solver tables", device):
                        nl = attach_nonlinear(self.mesh, p, self.tables,
                                              self.nl_tables, dtype, device)
                state = (None if ck is None else
                         _global_restart_state(self.tables, ck, nl))
                on_route("unstructured")
                state, samples = run_solver(
                    *args, state=state, nl=nl, drm=drm, fb_ids=fb_ids,
                    fb_series=fb_series, **kw)
        finally:
            if drm_rec is not None:
                drm_rec.close()
            if outputs is not None:
                outputs.close()
        return state, self._replay_nl_stations(samples, nl_st_rows, n_st)

    def _run_multichip(self, ndev, devices, device, dtype, chunk, steps,
                       on_chunk, make_outputs, rundir, restart, st_nodes,
                       st_phi, prefer, drm, on_samples, fb_ids, fb_series):
        """The loop on ``ndev`` ranks (hercules_tpu/sim.py:951-1088):
        the path (nonlinear soil alone on "gmesh" where it takes the
        case; nonlinear soil it refuses -- geostatic loading, BKT, a
        nonlinear element in the loose section --, DRM part 2 and
        fixed-base buildings on the sharded path, partition.
        shard_nonlinear / shard_drm / shard_fixedbase; every other mesh
        by driver.choose_path), the stations, the checkpoint restart (a
        carry tail must be this path's at this rank count), the taps
        (SimOutputs.make_mc_hook) and the chunked loop
        (driver.run_multichip).  Records the path as solver_path_name
        "mc:<path>" and, where a path refused the mesh or the physics,
        the reason."""
        from .parallel.driver import (GMeshPath, ShardedPath, choose_path,
                                      run_multichip)
        from .parallel.gmesh import build_gmesh_tables
        from .parallel.partition import (shard_drm, shard_fixedbase,
                                         shard_nonlinear, shard_tables)
        from .parallel.ranks import RankGroup

        p = self.params
        if devices is None:
            if device.type == "cpu":
                devices = [device] * ndev
            else:
                from .solver.fused_brick import solver_device
                solver_device(device)
                n = torch.cuda.device_count()
                if n < ndev:
                    raise RuntimeError(f"requested ndev={ndev} but only {n} "
                                       f"CUDA devices are visible")
                devices = [torch.device("cuda", i) for i in range(ndev)]
        group = RankGroup(devices)
        extras = [name for name, on in (
            ("nonlinear soil", self.nl_tables is not None),
            ("DRM part 2", drm is not None),
            ("fixed-base buildings", fb_ids is not None)) if on]
        path, reason = None, ""
        with measure("Solver tables", devices[0]):
            if extras == ["nonlinear soil"] and prefer in (None, "gmesh"):
                # the gmesh path runs the plastic subset pass on every
                # rank (nonlinear.c:1544-1823 on every MPI rank), on any
                # device (hercules_tpu/sim.py:969-991); geostatic loading
                # and nonlinear soil with BKT fall through to "sharded"
                try:
                    gmt = build_gmesh_tables(
                        self.mesh, self.tables, ndev, src_ids=self.src_ids,
                        nl_tables=self.nl_tables, params=p,
                        plan=self.brick_plan())
                except RuntimeError as e:
                    if prefer == "gmesh":
                        raise
                    reason = f"gmesh: {e}"
                else:
                    path = GMeshPath(gmt, group, dtype, self.mesh.nnum)
            if path is None and extras:
                # per-element plastic state, per-node DRM forces and
                # prescribed displacements shard with the unstructured
                # partition (nonlinear.c:1671, drm.c:2316 and
                # buildings.c:975-1146 run on every MPI rank)
                if prefer not in (None, "sharded"):
                    raise RuntimeError(
                        f"{', '.join(extras)}: multi-chip runs take the "
                        f"sharded path; cannot force mc_path={prefer}")
                ust = shard_tables(self.tables, self.mesh, ndev,
                                   src_ids=self.src_ids)
                nl_b = (None if self.nl_tables is None else shard_nonlinear(
                    ust, self.tables, self.mesh, p, self.nl_tables, ndev))
                drm_b = None if drm is None else shard_drm(ust, drm, ndev)
                fb_b = (None if fb_ids is None
                        else shard_fixedbase(ust, fb_ids, ndev))
                path = ShardedPath(ust, group, dtype, self.mesh.nnum,
                                   nl=nl_b, drm=drm_b, fb=fb_b,
                                   fb_series=fb_series)
                reason = (f"{', '.join(extras)}: the sharded path"
                          + (f" ({reason})" if reason else "")
                          if prefer is None else "")
            elif path is None:
                path, reason = choose_path(self.mesh, self.tables, group,
                                           src_ids=self.src_ids,
                                           dtype=dtype, prefer=prefer,
                                           plans=self.brick_plan)
            if st_nodes is not None and len(st_nodes):
                path.attach_stations(st_nodes, st_phi)
        self.solver_path_reason = reason
        self.start_step, ck = (read_restart(p, rundir) if restart is None
                               else restart)
        check_mc_tail(ck, path.name, ndev)
        state = None
        if ck is not None:
            fields = [np.asarray(x) for x in (ck.u_now, ck.u_prev)]
            if any(x.shape != (self.mesh.nnum, 3) for x in fields):
                raise RuntimeError("a multi-chip restart needs the "
                                   "checkpoint's global [N, 3] fields")
            state = path.state_from_global(*fields, tuple(ck.conv))
        self.solver_path_name = f"mc:{path.name}"
        self.mc_path = path
        outputs = make_outputs()
        try:
            hook = on_chunk
            if outputs is not None and outputs.active:
                chunk = outputs.chunk_for(chunk or 1000)
                hook = outputs.make_mc_hook(path, inner=on_chunk,
                                            start_step=self.start_step)
            return run_multichip(
                path, self.src_forces, steps, p.delta_t, chunk=chunk,
                state=state, start_step=self.start_step, on_chunk=hook,
                on_samples=on_samples)
        finally:
            if outputs is not None:
                outputs.close()

    def _replay_nl_stations(self, samples, nl_st_rows, n_st):
        """Replay the plastic recursion of each station in a nonlinear
        element from its sampled one-hot corner displacements
        (print_nonlinear_stations, nonlinear.c:1947-2228) into
        ``self.nl_station_extras``; returns the samples without those
        rows."""
        p = self.params
        self.nl_station_extras = {}
        if not nl_st_rows:
            return samples
        from .nonlinear import nonlinear_station_series, station_constants
        st, cfg = self.stations, self.nl_tables.cfg
        for i, j in enumerate(nl_st_rows):
            u8 = np.asarray(samples[:, n_st + 8 * i:n_st + 8 * (i + 1), :])
            con = station_constants(self.nl_tables, int(st.eidx[j]))
            self.nl_station_extras[int(st.ids[j])] = \
                nonlinear_station_series(
                    u8, con["h"], con, p.delta_t, cfg.material_model,
                    cfg.plasticity_type.startswith("rate_dep"))
        return samples[:, :n_st]

    def route(self, solver="auto", drm=None, fixed_base=False):
        """(route, plan, reason): the route ``run`` takes for ``solver``
        -- "pallas" (the single-brick kernel routes), "mesh" (the
        multi-brick route), "bricks" or "unstructured" -- the brick plan
        (None on "unstructured" where none was made), and the reason
        the kernel routes were left where "auto" would take them or
        another solver was asked for ("" otherwise).  Each condition is
        the rule of the JAX package's run (hercules_tpu/sim.py:226-271,
        334-363); ``drm`` is DRM part 2's bundle, ``fixed_base`` whether
        fixed-base buildings prescribe displacements.  solver="pallas"
        raises where the kernel routes do not take the case."""
        from .solver.fused_brick import plan_applies
        from .solver.fused_mesh import (drm_mesh_refusal,
                                        mesh_plan_applies,
                                        nl_mesh_refusal)

        p = self.params
        damping = self.tables.damping
        extras = self.nl_tables is not None or drm is not None

        def refuse(plan, reason):
            if solver == "pallas":
                raise RuntimeError(f"solver='pallas': no CUDA kernel route "
                                   f"takes this case: {reason}")
            return "unstructured", plan, reason

        if solver == "unstructured":
            return "unstructured", None, ""
        if fixed_base:
            return refuse(None, "fixed-base buildings run on the "
                                "unstructured solver")
        try:
            with GLOBAL_TIMERS.span("Solver plan"):
                plan = self.brick_plan()
        except RuntimeError as e:
            if solver != "auto":
                raise
            return "unstructured", None, f"no brick plan: {e}"
        if solver == "bricks":
            if extras:
                return "unstructured", plan, (
                    "the plain brick solver has no nonlinear or DRM pass")
            return "bricks", plan, ""
        if not mesh_plan_applies(plan, damping):
            if solver == "pallas":
                raise RuntimeError(f"no CUDA kernel route runs "
                                   f"damping={damping}")
            if extras:
                return "unstructured", plan, (
                    f"no kernel route runs damping={damping}, and the "
                    f"plain brick solver has no nonlinear or DRM pass")
            return "bricks", plan, f"no kernel route runs damping={damping}"
        if solver == "auto" and p.stiffness_method == "conventional":
            if extras:
                return "unstructured", plan, (
                    "stiffness_calculation_method = conventional, and the "
                    "plain brick solver has no nonlinear or DRM pass")
            return "bricks", plan, "stiffness_calculation_method = " \
                                   "conventional"
        if self.nl_tables is not None:
            reason = nl_mesh_refusal(plan, self.tables, self.nl_tables)
            if reason is not None:
                return refuse(plan, f"nonlinear soil: {reason}")
        if drm is not None:
            reason = drm_mesh_refusal(plan, drm)
            if reason is not None:
                return refuse(plan, f"DRM part 2: {reason}")
        if extras or not plan_applies(plan, damping):
            return "mesh", plan, ""
        return "pallas", plan, ""


# Simulation.run's routes, by the JAX package's names
SOLVERS = ("auto", "pallas", "bricks", "unstructured")


def _global_restart_state(tables, ck, nl=None):
    """The unstructured solver's state (u, u-, conv[, nl_state]), numpy,
    from a checkpoint: global [N, 3] fields, with BKT the four [E, 8,
    3] memory variable arrays, then with nonlinear soil (the
    attach_nonlinear bundle ``nl``) the plastic state's arrays
    (hercules_tpu/sim.py:886-909).  Any other layout raises."""
    nconv = 4 if tables.damping == "bkt" else 0
    conv, tail = tuple(ck.conv[:nconv]), tuple(ck.conv[nconv:])
    want = [] if nl is None else nl["parts"]
    if (any(np.shape(x) != (tables.N, 3) for x in (ck.u_now, ck.u_prev))
            or len(conv) != nconv
            or any(np.shape(c) != (tables.E, 8, 3) for c in conv)
            or [np.shape(a) for a in tail] != want):
        raise RuntimeError("checkpoint layout does not match the "
                           "unstructured solver")
    state = (ck.u_now, ck.u_prev, conv or None)
    return state if nl is None else state + (tail,)


def _brick_restart_state(plan, damping, ck, dtype, device):
    """The plain brick solver's state (u, u-, conv) over the plan's
    concatenated columns from a checkpoint (hercules_tpu/sim.py:865-877):
    fields global [N, 3] or component-major [3, X] (cut or zero-padded
    to the plan's columns); with BKT, four arrays per brick ([24, S]
    each) and four for the loose elements ([El, 8, 3]), as this solver
    writes them.  Any other layout raises."""
    from .solver.brickstep import brick_meta
    from .solver.fused_brick import fit_field_cm
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    u, up = (f(fit_field_cm(plan, x, plan.total_nb))
             for x in (ck.u_now, ck.u_prev))
    conv = ()
    if damping == "bkt":
        shapes = [(24, m.S) for m in brick_meta(plan) for _ in range(4)]
        if len(plan.loose_eidx):
            shapes += [(len(plan.loose_eidx), 8, 3)] * 4
        if [np.shape(c) for c in ck.conv] != shapes:
            raise RuntimeError("checkpoint BKT state does not match plan")
        arrs = [f(c) for c in ck.conv]
        conv = tuple(tuple(arrs[i:i + 4]) for i in range(0, len(arrs), 4))
    return (u, up, conv)
