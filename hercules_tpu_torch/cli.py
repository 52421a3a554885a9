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

monitor.txt names the route that ran ("solver path: ..."): cuda_chunk
or cuda_step (elastic), cuda_bkt_chunk or cuda_bkt_step (BKT, one Q
set), cuda_bkt_node_step (BKT, several Q sets, node tier),
cuda_bkt_corner_step (BKT, corner tier), torch_plain (--device=cpu).
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
    rest = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--dtype="):
            dtype_name = a.split("=", 1)[1]
        else:
            rest.append(a)
    argv = rest
    if (not argv or device not in ("cuda", "cpu")
            or dtype_name not in (None, "float32", "float64")):
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

    from .sim import Simulation, write_station_files
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

    with measure("Mesh Stats Print"):
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

    with measure("Solver", device):
        state, samples = sim.run(
            device=device, on_chunk=on_chunk,
            dtype=None if dtype_name is None else getattr(torch,
                                                          dtype_name))
    el = time.time() - t1
    mon.print(f"solver path: {sim.solver_path_name}  "
              f"({max(p.total_steps, 1) / max(el, 1e-9):.1f} steps/s)\n")
    mon.print(f"solver_run done: {el:.1f} s\n")

    if sim.stations is not None:
        outdir = p.stations_dir or "stations"
        if not os.path.isabs(outdir):
            outdir = os.path.join(rundir, outdir)
        write_station_files(outdir, sim.stations, samples, p.delta_t,
                            print_rate=p.stations_print_rate,
                            velocities=bool(p.print_station_velocities),
                            accelerations=bool(
                                p.print_station_accelerations))
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
