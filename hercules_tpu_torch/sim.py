"""End-to-end simulation pipeline on the port: config, CVM, meshing,
tables, source, stations, the time loop on the CUDA kernels, station
files.

Counterpart of ``hercules_tpu/sim.py`` (which imports jax).  The host
stages are the port's copies of the JAX package's numpy modules
(``config``, ``cvm``, ``meshgen``, ``mesh``, ``physics``, ``source``);
``StationSet``, ``setup_stations`` and ``write_station_files`` are
copied from it.
``Simulation.run`` covers the single-brick routes: elastic (Rayleigh,
mass or no damping) and BKT on its three tiers (uniform Q, general Q
with node-basis memory variables, or corner-basis memory variables);
every other route raises NotImplementedError naming its ROADMAP.md
queue item.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .config import Params, load_params
from .cvm import CVM, open_material_db
from .mesh.locate import local_coords, locate_points
from .meshgen import generate_mesh
from .physics.consts import critical_dt, critical_dt_factors
from .physics.kmats import XI
from .source.model import SourceModel, compute_domain_coords_linearinterp

from .solver.assemble import assemble
from .utils.timers import measure

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
                        accelerations=False, start_step=0):
    """Reference station text format (psolve.c:6636-6795): header line
    then time + displacement per step, with optional velocity and
    acceleration columns.

    The reference computes v = (tm1 - tm2)/dt and a = (tm1 - 2 tm2 +
    tm3)/dt^2 in-loop; since row s holds u(s), the same finite
    differences apply to the recorded series.

    start_step > 0 (checkpoint restart): samples[0] is the field at
    `start_step`; rows are appended to the existing files on the
    absolute print_rate grid."""
    os.makedirs(outdir, exist_ok=True)
    T = samples.shape[0]
    if accelerations:
        velocities = True
    a0 = ((start_step + print_rate - 1) // print_rate) * print_rate
    for k, sid in enumerate(stations.ids):
        path = os.path.join(outdir, f"station.{int(sid)}")
        with open(path, "a" if start_step else "w") as f:
            if not start_step:
                f.write("#  Time(s)         X|(m)         Y-(m)"
                        "         Z.(m)")
                if velocities:
                    f.write("       X|(m/s)       Y-(m/s)       Z.(m/s)")
                if accelerations:
                    f.write("      X|(m/s2)      Y-(m/s2)      Z.(m/s2)")
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
            f.write("\n")


def _unsupported(params):
    """The first feature of ``params`` this slice does not run, with
    the ROADMAP.md queue item that ports it, or None."""
    p = params
    checks = (
        (p.include_nonlinear, "nonlinear soil (Queue 1, item 7)"),
        (p.implement_drm, "DRM (Queue 1, item 7)"),
        (p.include_buildings, "buildings (Queue 1, item 7)"),
        (p.type_of_damping not in ("rayleigh", "mass", "none", "bkt"),
         f"damping={p.type_of_damping} (Queue 1, item 5)"),
        (p.use_checkpoint, "checkpoint/restart (Queue 1, item 3)"),
        (p.output_displacement or p.output_velocity,
         "4-D volume output (Queue 1, item 3)"),
        (p.number_output_planes, "plane output (Queue 1, item 3)"),
    )
    for bad, what in checks:
        if bad:
            return what
    return None


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
    # (bkt_node_step and the mixed-element epilogue per step),
    # "cuda_bkt_corner_step" (bkt_corner_step per step) or
    # "torch_plain" (the plain versions, on the CPU)
    solver_path_name: str = ""

    @classmethod
    def setup(cls, physics_in, numerical_in=None, cvmdb=None,
              verbose=False):
        """hercules_tpu.sim.Simulation.setup without the nonlinear, DRM
        and building stages (which raise)."""
        params = load_params(physics_in, numerical_in)
        what = _unsupported(params)
        if what is not None:
            raise NotImplementedError(
                f"hercules_tpu_torch does not run {what} yet")
        rundir = os.path.dirname(os.path.dirname(
            os.path.abspath(physics_in))) or "."
        if cvmdb is None:
            cvmdb = params.cvmdb_input_file
            if cvmdb and not os.path.isabs(cvmdb):
                cvmdb = os.path.join(rundir, cvmdb)
        cvm = open_material_db(cvmdb, params)
        mesh = generate_mesh(params, cvm, verbose=verbose)
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
        tables = assemble(mesh, params)
        source = SourceModel.parse(params)
        src_ids, src_forces = source.compute_forces(mesh, params)
        stations = setup_stations(mesh, params)
        return cls(params=params, cvm=cvm, mesh=mesh, tables=tables,
                   source=source, src_ids=src_ids, src_forces=src_forces,
                   stations=stations)

    def run(self, device="cuda", dtype=None, chunk=None, total_steps=None,
            on_chunk=None):
        """The time loop on ``device`` in ``dtype`` (float32 on CUDA and
        float64 on the CPU by default), on the first BKT tier that holds
        the brick.  Returns ((u, up[, conv[, conv_mix]]) tensors, samples
        [T, ns, 3] numpy)."""
        from .solver.bricks import build_plan
        from .solver.fused_brick import plan_applies, run_pallas_solver

        device = torch.device(device)
        if dtype is None:
            dtype = torch.float32 if device.type == "cuda" else \
                torch.float64
        p = self.params
        steps = total_steps if total_steps is not None else p.total_steps
        st = self.stations
        try:
            with measure("Solver plan"):
                plan = build_plan(self.mesh)
        except RuntimeError as e:
            raise NotImplementedError(
                f"mesh does not decompose into bricks ({e}); the "
                f"unstructured solver is Queue 1, item 4") from e
        if not plan_applies(plan, self.tables.damping):
            raise NotImplementedError(
                f"{len(plan.bricks)} bricks, {len(plan.loose_eidx)} loose "
                f"elements: the graded multi-brick path is Queue 1, "
                f"item 6")

        def on_route(name):
            self.solver_path_name = name

        return run_pallas_solver(
            plan, self.tables, self.src_ids, self.src_forces, steps,
            p.delta_t, st_nodes=None if st is None else st.nodes,
            st_phi=None if st is None else st.phi, dtype=dtype,
            device=device, chunk=chunk, on_chunk=on_chunk,
            on_route=on_route)
