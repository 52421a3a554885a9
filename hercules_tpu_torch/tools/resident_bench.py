"""The chunk kernel K5 (``kernels/brick_chunk.py``,
``csrc/brick_chunk.cu``) timed on the bench's box:

  python -m hercules_tpu_torch.tools.resident_bench [CH] [--elems=N] \
      [--device=cpu]

Counterpart of ``hercules_tpu/tools/resident_bench.py``.  That tool
builds its box with the root ``bench.build``, which reads the
reference's simple example; this one writes fixture (a), the
homogeneous box (Vp 6000, Vs 3464, rho 2700), with
``fixtures.write_box_case`` at the edge ``bench.build`` picks for the
target element count (``box_edge``: 1,000,000 -> 7.8125 m, 2^20
elements).  It plans the box (``build_plan``), builds its
``PallasBrickTables`` in float32 with Rayleigh damping, and launches CH
steps (default 400) in one K5 call: once to build and warm, then twice
timed, each fenced by ``torch.cuda.synchronize``.  It starts from a
seeded state (u ~ 1e-3 N(0, 1) on the brick's nodes, u- close to it)
and injects no source.

Lines printed: the elements, LEN, and the chunk launch's device bytes
(state and constants, S and K [8, LEN]; the bytes per step and the
bound from ``utils/roofline.route_costs``) beside the card's name and
power limit; the "compile+first" seconds; and for each timed run the
seconds, element updates per second and microseconds per step.  On
``--device=cpu`` it runs K5's plain version, and its times are the
CPU's.
"""

from __future__ import annotations

import math
import sys
import tempfile
import time

import numpy as np
import torch


def box_edge(target_elems):
    """The element edge bench.build picks for a target element count:
    the 1000 x 1000 x 500 m box holds 2^(3k+2) elements at edge
    1000 / 2^(k+1) m."""
    k = int(math.ceil((math.log2(target_elems) - 2.0) / 3.0))
    return 1000.0 / 2 ** (k + 1)


def build(target_elems=1_000_000, damping="rayleigh"):
    """Fixture (a) meshed at ``box_edge(target_elems)`` and assembled
    with ``damping``: (params, mesh, tables, mesh seconds, assembly
    seconds), as the root bench.build returns them."""
    from ..config import load_params
    from ..cvm import CVM
    from ..fixtures import write_box_case
    from ..meshgen import generate_mesh
    from ..solver.assemble import assemble

    with tempfile.TemporaryDirectory(prefix="ht_box_") as root:
        cvmdb, physics, numerical = write_box_case(
            root, box_edge(target_elems), steps=1, n_stations=0,
            damping=damping)
        p = load_params(physics, numerical)
        cvm = CVM(cvmdb)
        t0 = time.perf_counter()
        mesh = generate_mesh(p, cvm)
        t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = assemble(mesh, p)
    t_asm = time.perf_counter() - t0
    return p, mesh, tables, t_mesh, t_asm


def seeded_state(pt):
    """S [8, LEN] in the tables' type and device: u ~ 1e-3 N(0, 1) on
    the brick's nodes, u- = u - 1e-4 N(0, 1), zero padding (seed 0)."""
    rng = np.random.default_rng(0)
    S = np.zeros((8, pt.LEN))
    u = 1e-3 * rng.standard_normal((3, pt.nb))
    S[0:3, :pt.nb] = u
    S[3:6, :pt.nb] = u - 1e-4 * rng.standard_normal((3, pt.nb))
    return torch.as_tensor(S, dtype=pt.dtype, device=pt.device)


def device_label(device):
    """The card's name and power limit (utils/roofline.card) on CUDA;
    on the CPU, a label saying the times are the CPU's."""
    from ..utils import roofline
    if torch.device(device).type == "cuda":
        return roofline.card()
    return "cpu, plain versions"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv):
    """(positional arguments, {--key: value}) of ``argv``."""
    pos, opts = [], {}
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            opts[k] = v
        else:
            pos.append(a)
    return pos, opts


def run(CH=400, elems=1_000_000, device="cuda", problem=None, out=None):
    """Build (or take ``problem``, build's tuple) and time the box;
    prints the tool's lines to ``out`` and returns {"elements", "LEN",
    "chunk", "card", "state_bytes", "bytes_per_step", "bound_ms",
    "compile_first_s", "runs": [{"s", "eups", "us_per_step"}], "S0":
    the seeded start state, "S": the state after 3 CH steps}."""
    from ..solver.bricks import build_plan
    from ..solver.fused_brick import PallasBrickTables, solver_device
    from ..utils import roofline

    out = out or sys.stdout
    device = solver_device(device)
    p, mesh, tables, t_mesh, t_asm = problem or build(elems, "rayleigh")
    if tables.damping != "rayleigh":
        raise ValueError(f"resident_bench times K5 on a Rayleigh box, "
                         f"not {tables.damping}")
    plan = build_plan(mesh)
    pt = PallasBrickTables(plan, tables, dtype=torch.float32, device=device)
    E = mesh.lenum
    card = device_label(device)
    cost = roofline.route_costs(pt, E, chunk=CH)["brick_chunk"]
    w = torch.empty((), dtype=pt.dtype).element_size()
    state_bytes = 2 * 8 * pt.LEN * w
    print(f"# {E} elems, LEN {pt.LEN}, chunk launch device bytes "
          f"{state_bytes / 2 ** 20:.3g} MiB (S and K [8, LEN] float32), "
          f"{cost.bytes / 2 ** 20:.3g} MiB per step, bound "
          f"{cost.bound_ms * 1e3:.3g} us/step by {cost.bound_by} "
          f"({card})", file=out, flush=True)
    S0 = seeded_state(pt)
    S = S0.clone()
    sf = torch.zeros((CH, 3, 0), dtype=pt.dtype, device=device)
    t0 = time.perf_counter()
    S, _ = pt.step.chunk(S, sf)
    _sync(device)
    first = time.perf_counter() - t0
    print(f"# compile+first {first:.1f}s ({card})", file=out, flush=True)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        S, _ = pt.step.chunk(S, sf)
        _sync(device)
        dt = time.perf_counter() - t0
        runs.append({"s": dt, "eups": E * CH / dt,
                     "us_per_step": dt / CH * 1e6})
        print(f"# {CH} steps in {dt:.3f}s -> {E * CH / dt:.3e} eups "
              f"({dt / CH * 1e6:.0f} us/step) ({card})", file=out,
              flush=True)
    return {"elements": E, "LEN": pt.LEN, "chunk": CH, "card": card,
            "state_bytes": state_bytes, "bytes_per_step": cost.bytes,
            "bound_ms": cost.bound_ms, "compile_first_s": first,
            "runs": runs, "S0": S0, "S": S}


def main(argv=None):
    pos, opts = parse_args(list(sys.argv[1:] if argv is None else argv))
    run(CH=int(pos[0]) if pos else 400,
        elems=int(float(opts.get("elems", 1_000_000))),
        device=opts.get("device", "cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
