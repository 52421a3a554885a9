"""psolve-compatible command line entry of the PyTorch/CUDA port.

Usage (the JAX package's argument forms):
  python -m hercules_tpu_torch.cli [--device=cuda|cpu] <parameters.in>
  python -m hercules_tpu_torch.cli [--device=cuda|cpu] <cvmdb> \
      <physics.in> <numerical.in> [mesh.e]

Options:
  --device=cuda   run on the CUDA device through the port's kernels
                  (the default; exits non-zero when no CUDA device is
                  present -- it never carries on on the CPU)
  --device=cpu    run the kernels' plain PyTorch versions on the CPU
  --dtype=float32|float64
                  working precision (default float32 on CUDA, float64
                  on the CPU)
  --ndev=N|auto|1 ranks of the multi-chip pipeline (default auto: every
                  visible CUDA device, one rank on --device=cpu; N > 1
                  on --device=cpu runs N ranks on the CPU; 1 forces the
                  single-device routes)
  --mc-path=NAME  force a multi-chip path (slab, slab_pallas, gslab,
                  gmesh, sharded); one that does not take the mesh
                  exits non-zero with its reason

With more than one rank the monitor says "multi-chip pipeline: N
devices" and names the path, "solver path: mc:slab_pallas" (a step
kernel per z-slab of a one-brick mesh; mc:slab on the CPU),
"mc:gslab" (a depth-graded mesh: a step kernel per z-fragment of each
brick), "mc:gmesh" (any other brick plan, and nonlinear soil) or
"mc:sharded" (any other mesh, and DRM part 2, fixed-base buildings and
the nonlinear soil gmesh refuses); a reason line names each path that
refused the mesh.  On --device=cpu the automatic choice skips gslab and
gmesh (except for nonlinear soil), as the JAX package does off the TPU.

monitor.txt names the route that ran ("solver path: ..."): cuda_chunk
or cuda_step (elastic), cuda_bkt_chunk or cuda_bkt_step (BKT, one Q
set), cuda_bkt_node_step (BKT, several Q sets, node tier),
cuda_bkt_corner_step (BKT, corner tier) for a one-brick plan;
cuda_mesh for a graded (multi-brick) plan, each brick on its own step
kernel; torch_plain for either on --device=cpu; bricks (the plain
brick solver) for a plan the kernels do not run (a damping name other
than rayleigh, mass, none or bkt, which runs undamped, or
stiffness_calculation_method = conventional); unstructured for a mesh
that does not decompose into bricks, fixed-base buildings, or nonlinear
soil or DRM part 2 on a plan the mesh route's rules refuse; a
"solver path reason:" line then says why.  Stations in nonlinear
elements carry 17 more columns (strain, stress, plastic multiplier,
yield value, hardened strength).

The JAX CLI's outputs and restart: output_displacement /
output_velocity (4-D volume files), number_output_planes (plane
files), use_checkpoint with checkpointing_rate (checkpoint.out0/1 in
the checkpoint directory); with use_checkpoint = 1 a checkpoint.in
there resumes the run from its step, and the station files are
appended to.
"""

from __future__ import annotations

import io
import os
import sys
import time


def _looks_like_database(path):
    """Is the first positional argument a material database (etree /
    flat records) rather than a config file?  Decided by content:
    config files are text key=value, databases are binary."""
    if path.endswith(".e"):
        return True
    if path.endswith(".in") or not os.path.exists(path):
        return False
    try:
        with open(path, "rb") as f:
            head = f.read(512)
    except OSError:
        return False
    if b"\0" in head:
        return True
    try:
        head.decode("utf-8")
    except UnicodeDecodeError:
        return True
    return False


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    dtype_name = None
    ndev_opt = "auto"
    mc_path = None
    rest = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--dtype="):
            dtype_name = a.split("=", 1)[1]
        elif a.startswith("--ndev="):
            ndev_opt = a.split("=", 1)[1]
        elif a.startswith("--mc-path="):
            mc_path = a.split("=", 1)[1]
        else:
            rest.append(a)
    argv = rest
    if (not argv or device not in ("cuda", "cpu")
            or dtype_name not in (None, "float32", "float64")
            or not (ndev_opt == "auto" or ndev_opt.isdigit())):
        print(__doc__)
        return 2

    cvmdb = None
    mesh_out = None
    if len(argv) == 1:
        physics_in = numerical_in = argv[0]
    elif len(argv) >= 3 and _looks_like_database(argv[0]):
        cvmdb, physics_in, numerical_in = argv[0], argv[1], argv[2]
        if len(argv) > 3:
            mesh_out = argv[3]
    else:
        physics_in = argv[0]
        numerical_in = argv[1] if len(argv) > 1 else argv[0]

    import torch
    if device == "cuda" and not torch.cuda.is_available():
        print("hercules_tpu_torch: no CUDA device is available; the "
              "solver runs on the GPU (pass --device=cpu for the plain "
              "PyTorch versions on the CPU)", file=sys.stderr)
        return 1

    from .io.monitor import Monitor
    from .physics.consts import critical_dt
    from .utils.stats import mesh_stats

    from .sim import (SimOutputs, Simulation, read_restart,
                      write_station_files)
    from .utils.timers import GLOBAL_TIMERS, measure, print_timing_stat

    t0 = time.time()
    GLOBAL_TIMERS.start("Total Wall Clock")
    sim = Simulation.setup(physics_in, numerical_in, cvmdb=cvmdb,
                           verbose=True)
    p = sim.params
    mpath = p.monitor_file
    rundir = os.path.dirname(os.path.dirname(
        os.path.abspath(physics_in))) or "."
    if mpath and not os.path.isabs(mpath):
        mpath = os.path.join(rundir, mpath)
    mon = Monitor(mpath)
    mon.print(f"mesh_generate + solver_init: {time.time()-t0:.1f} s\n")
    mon.print(f"Total elements: {sim.mesh.lenum}\n"
              f"Total nodes: {sim.mesh.nnum}\n"
              f"Total dangling nodes: {len(sim.mesh.dn_ids)}\n")

    with GLOBAL_TIMERS.span("Mesh Stats Print"):
        buf = io.StringIO()
        mesh_stats(sim.mesh, out=buf)
        mon.print(buf.getvalue())
        if p.stat_mesh_filename:
            path = p.stat_mesh_filename
            if not os.path.isabs(path):
                path = os.path.join(rundir, path)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(buf.getvalue())

    # the JAX CLI's optional outputs, in its order
    # (hercules_tpu/cli.py:124-180)
    if p.print_matrix_k:
        # print_K_stdoutput (psolve.c:3184)
        from .utils.stats import print_k_matrices
        print_k_matrices()

    if (p.schedule_print_file or p.schedule_print_stdout
            or p.schedule_print_error_check):
        from .solver.bricks import build_plan
        from .utils.stats import schedule_stats
        try:
            plan = build_plan(sim.mesh)
        except RuntimeError:
            plan = None
        buf = io.StringIO()
        schedule_stats(sim.mesh, plan, out=buf,
                       error_check=bool(p.schedule_print_error_check))
        if p.schedule_print_stdout:
            sys.stdout.write(buf.getvalue())
        if p.schedule_print_file:
            path = p.stat_schedule_filename
            if not os.path.isabs(path):
                path = os.path.join(rundir, path)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(buf.getvalue())

    if os.environ.get("IO_PES"):
        # the reference splits IO-server ranks off comm_solver
        # (psolve.c:7360-7389); here output overlap comes from the
        # async writer threads, so the env var is a no-op
        mon.print("IO_PES set: async writer threads subsume the "
                  "reference's IO pool; no ranks reserved\n")

    if p.damping_statistics:
        from .utils.stats import critical_t_stats, damping_histograms
        buf = io.StringIO()
        critical_t_stats(sim.mesh, p, out=buf)
        damping_histograms(sim.mesh, p, out=buf)
        mon.print(buf.getvalue())

    if p.mesh_coordinates_for_matlab.lower() == "yes":
        # saveMeshCoordinatesForMatlab (meshformatlab.c:30-250): the
        # corners bound the dumped region, the whole domain when absent
        from .io.matlab import write_matlab_mesh
        mdir = p.mesh_coordinates_directory_for_matlab or "matlab"
        if not os.path.isabs(mdir):
            mdir = os.path.join(rundir, mdir)
        bbox = None
        if p.mesh_corners_matlab is not None:
            c = p.mesh_corners_matlab
            bbox = (c[0], c[2], c[1], c[3], c[4], c[5])
        nml = write_matlab_mesh(mdir, sim.mesh, p, bbox=bbox)
        mon.print(f"matlab mesh coordinates written: {mdir} "
                  f"({nml} elements)\n")

    if p.output_mesh and (mesh_out or p.mesh_etree_output_file):
        from .io.meshout import write_mesh_etree
        path = mesh_out or p.mesh_etree_output_file
        if not os.path.isabs(path):
            path = os.path.join(rundir, path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_mesh_etree(path, sim.mesh)
        mon.print(f"mesh database written: {path}\n")

    t1 = time.time()
    mon.print(f"solver_run() start: {p.total_steps} steps\n")

    def on_chunk(done, state):
        el = time.time() - t1
        eta = el / done * (p.total_steps - done)
        mon.print(f"step {done:8d}/{p.total_steps}  "
                  f"wall {el:8.1f}s  ETA {eta:8.1f}s\n")

    # multi-chip by default on every visible CUDA device, as the JAX
    # CLI takes every device (hercules_tpu/cli.py:204-213)
    if ndev_opt == "auto":
        ndev = torch.cuda.device_count() if device == "cuda" else 1
    else:
        ndev = int(ndev_opt)
    if ndev > 1:
        mon.print(f"multi-chip pipeline: {ndev} devices\n")

    # a checkpoint.in in the checkpoint directory resumes the run: read
    # (and checked) before the output files are opened, which sim.run
    # does once the route is chosen; then the 4-D volume, plane and
    # checkpoint taps (closed by sim.run)
    restart = read_restart(p, rundir)
    with measure("Solver", device):
        state, samples = sim.run(
            device=device, on_chunk=on_chunk,
            outputs=lambda: SimOutputs(sim.mesh, p, rundir=rundir),
            rundir=rundir, restart=restart, ndev=ndev,
            mc_path=mc_path if ndev > 1 else None,
            dtype=None if dtype_name is None else getattr(torch,
                                                          dtype_name))
    el = time.time() - t1
    done_steps = max(p.total_steps - sim.start_step, 1)
    mon.print(f"solver path: {sim.solver_path_name}  "
              f"({done_steps / max(el, 1e-9):.1f} steps/s)\n")
    if sim.solver_path_reason:
        mon.print(f"solver path reason: {sim.solver_path_reason}\n")
    mon.print(f"solver_run done: {el:.1f} s\n")

    if sim.stations is not None:
        outdir = p.stations_dir or "stations"
        if not os.path.isabs(outdir):
            outdir = os.path.join(rundir, outdir)
        write_station_files(outdir, sim.stations, samples, p.delta_t,
                            print_rate=p.stations_print_rate,
                            velocities=bool(p.print_station_velocities),
                            accelerations=bool(
                                p.print_station_accelerations),
                            start_step=sim.start_step,
                            nl_extras=sim.nl_station_extras or None)
        mon.print(f"station files written: {outdir}\n")

    GLOBAL_TIMERS.stop("Total Wall Clock")
    buf = io.StringIO()
    print_timing_stat(p, sim.mesh, out=buf,
                      critical_t=critical_dt(sim.mesh.props,
                                             sim.mesh.edge_m))
    mon.print(buf.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
