"""The single-brick solver on the port's kernels: tables, state layout,
routing and the chunked time loop, for the elastic step (Rayleigh, mass
or no damping) and for BKT attenuation (``fused_bkt.py``: one Q set;
``fused_bktq.py``: several, on the node or the corner tier).

Counterpart of the single-brick host side of
``hercules_tpu/solver/pallas_brick.py``; functions keep the JAX names
(``plan_applies``, ``pallas_geometry``, ``PallasBrickTables``,
``init_packed_state``, ``packed_snap_of``, ``run_pallas_solver``,
``pallas_u_global``) so a reader finds each one's reference.

Layout: column n of every [rows, LEN] array is node n of the brick's
flat node grid (the JAX package's column order; only the zero padding
after the nb nodes differs).

- S [8, LEN]: rows 0:3 = u, 3:6 = u- (previous step), 6:8 = 0.
- K [8, LEN]: rows 0:3 = (c1, c2, beta = c3/c1) of the element whose
  lowest corner is column n (0 for padding and invalid elements),
  3:6 = mass_minusaM, 6 = inv_mass (0 on padding), 7 = 0.

Padding nodes therefore never move: their force is 0 and inv_mass 0.
BKT bricks keep S and add memory variables, with their own K: the
state is a tuple, as the JAX carry: (S,) elastic, (S, conv) on the
uniform and corner BKT tiers, (S, conv[, conv_mix]) on the node tier
(``fused_bktq.py``).

Routing (``chunk_applies``, the counterpart of ``resident_applies``
without its on-chip memory clause): float32 runs with at most 128
sources and 128 stations take the chunk kernel -- brick_chunk (K5), or
bkt_chunk (K6) for uniform-Q BKT -- one launch per chunk of steps;
every other run takes the step kernel -- brick_step (K1), bkt_step
(K2), bkt_node_step (K3, then the mixed-element epilogue) or
bkt_corner_step (K4) -- once per step, with the source ``index_add_``
and the station sampling as torch ops between steps, as the JAX package
does them around its step kernels.  ``route_name`` names the route.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..physics.kmats import stiffness_matrices_24

from ..kernels.brick_chunk import brick_chunk, sample_stations
from ..kernels.brick_step import brick_step
from ..utils.timers import measure
from .chunking import run_chunked
from .fused_bktq import bkt_step_module


def plan_applies(plan, damping) -> bool:
    """True if the single-brick solver covers this brick plan.  (The
    JAX package also requires the stencil reach to fit its on-chip tile,
    ``pallas_fits``; the CUDA kernels have no such limit.)  A BKT brick
    takes the uniform, node or corner tier (fused_bktq)."""
    return (len(plan.bricks) == 1
            and len(plan.loose_eidx) == 0
            and len(plan.grp_node) == 0
            and damping in ("rayleigh", "mass", "none", "bkt"))


def solver_device(device) -> torch.device:
    """``device`` as a torch.device.  A CUDA device raises when none is
    present: the solver runs on the card unless the caller asks for the
    CPU, and never carries on on the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' for the plain PyTorch versions")
    return device


def pallas_geometry(nb, align=1024) -> int:
    """LEN: the brick's nb node columns padded with zero columns to a
    multiple of ``align``.  The kernels bounds-check their stencil
    reads, so no halo is needed."""
    return -(-nb // align) * align


@lru_cache(maxsize=None)
def _operator_np():
    M1, M2 = stiffness_matrices_24()
    return np.concatenate([-M1, -M2])


def operators(dtype, device):
    """A = -[M1; M2] as a [48, 24] tensor: the element force is
    c1 A[:24] W + c2 A[24:] W."""
    return torch.tensor(_operator_np(), dtype=dtype, device=device)


def pack_constants(plan, tables, LEN):
    """K [8, LEN] in float64 (see the module docstring)."""
    g = plan.gnid_cat

    def etab(k):
        return np.where(plan.evalid_cat,
                        getattr(tables, k)[plan.eidx_cat], 0.0)

    c1, c2, c3 = etab("c1"), etab("c2"), etab("c3")
    # c3 = beta*c1 and c4 = beta*c2 with one beta = b*dt per element
    # (element_coefficients, consts.py), so (c1, c2, beta) suffice
    beta = np.divide(c3, c1, out=np.zeros_like(c1), where=c1 != 0)
    K = np.zeros((8, LEN))
    nb = len(g)
    K[0, :nb], K[1, :nb], K[2, :nb] = c1, c2, beta
    K[3:6, :nb] = tables.mass_minusaM[g].T
    K[6, :nb] = tables.inv_mass[g]
    return K


def _first_copy(g, ids):
    """Column of each node id in ``ids`` (its first copy in g)."""
    ids = np.asarray(ids).ravel()
    uniq, first = np.unique(g, return_index=True)
    pos = first[np.minimum(np.searchsorted(uniq, ids), len(uniq) - 1)]
    if not (g[pos] == ids).all():
        raise ValueError("source or station node not in the brick")
    return pos


class BrickStep(nn.Module):
    """The brick's step operator: buffers K [8, LEN] and the two 24x24
    stiffness operators, stacked as ops = -[M1; M2] [48, 24]."""

    def __init__(self, K, offs):
        super().__init__()
        self.offs = tuple(int(o) for o in offs)
        self.register_buffer("K", K)
        self.register_buffer("ops", operators(K.dtype, K.device))

    def forward(self, S, out=None):
        """One step (K1)."""
        return brick_step(S, self.K, self.offs, self.ops, out=out)

    def chunk(self, S, srcf, src_pos=None, st_pos=None, st_phi=None):
        """srcf.shape[0] steps in one launch (K5); see brick_chunk.
        Returns (S', samples)."""
        return brick_chunk(S, torch.empty_like(S), self.K, self.offs,
                           self.ops, srcf, src_pos, st_pos, st_phi)


class PallasBrickTables:
    """Padded tables, geometry, source and station positions of a
    single-brick plan, on ``device`` (the CUDA device unless the
    caller asks for the CPU) in ``dtype``.  ``step`` is the
    brick's step operator: BrickStep, or for BKT damping the module of
    its tier (``bkt_tier``: BktStep "uniform", BktNodeStep "node" or
    BktCornerStep "corner"), chosen as fused_bktq.bkt_step_module does,
    or forced by ``bkt_tier`` (raises if that tier cannot hold the
    brick)."""

    def __init__(self, plan, tables, src_ids=None, st_nodes=None,
                 st_phi=None, dtype=torch.float32, device="cuda",
                 bkt_tier=None):
        if not plan_applies(plan, tables.damping):
            raise ValueError("the plan is not a single brick")
        b = plan.bricks[0]
        self.offs = tuple(b.corner_offsets())
        self.nb = b.nb
        self.LEN = pallas_geometry(b.nb)
        self.dtype, self.device = dtype, solver_device(device)
        self.damping = tables.damping
        self.bkt_tier = None
        if self.damping == "bkt":
            self.step, K = bkt_step_module(plan, tables, self.LEN,
                                           self.offs, dtype, self.device,
                                           tier=bkt_tier)
            self.bkt_tier = self.step.tier
            self.invm_row = 3
        else:
            if bkt_tier is not None:
                raise ValueError(f"bkt_tier={bkt_tier!r} on a "
                                 f"{self.damping} brick")
            K = pack_constants(plan, tables, self.LEN)
            self.step = BrickStep(torch.as_tensor(K, dtype=dtype,
                                                  device=self.device),
                                  self.offs)
            self.invm_row = 6
        g = plan.gnid_cat
        self.src_pos = self.st_pos = self.st_phi = None
        if src_ids is not None and len(src_ids):
            pos = _first_copy(g, src_ids)
            self.src_pos = torch.as_tensor(pos, device=self.device)
            # inv_mass at the sources, rounded to the working type as
            # the device table holds it
            self.src_invm = np.asarray(
                K[self.invm_row, pos], np.float32 if dtype == torch.float32
                else np.float64)
        if st_nodes is not None and len(st_nodes):
            pos = _first_copy(g, st_nodes).reshape(np.shape(st_nodes))
            self.st_pos = torch.as_tensor(pos, device=self.device)
            self.st_phi = torch.as_tensor(np.asarray(st_phi), dtype=dtype,
                                          device=self.device)

    @property
    def K(self):
        return self.step.K

    @property
    def n_src(self):
        return 0 if self.src_pos is None else len(self.src_pos)

    @property
    def n_st(self):
        return 0 if self.st_pos is None else len(self.st_pos)


def chunk_applies(dtype, n_src, n_st, bkt_tier=None) -> bool:
    """The chunk kernel (K5, or K6 for uniform-Q BKT) runs float32 runs
    with <=128 sources and <=128 stations; everything else, and every
    run on the node or the corner BKT tier, steps with the step kernel
    (K1, K2, K3 or K4)."""
    return (dtype == torch.float32 and n_src <= 128 and n_st <= 128
            and bkt_tier in (None, "uniform"))


def route_name(pt: PallasBrickTables, route) -> str:
    """The route's name in monitor.txt: cuda_chunk / cuda_step
    (elastic), cuda_bkt_chunk / cuda_bkt_step (uniform-Q BKT),
    cuda_bkt_node_step, cuda_bkt_corner_step, or torch_plain (the plain
    versions, on the CPU)."""
    if pt.device.type == "cpu":
        return "torch_plain"
    if pt.bkt_tier in ("node", "corner"):
        return f"cuda_bkt_{pt.bkt_tier}_step"
    return f"cuda_{'bkt_' if pt.bkt_tier else ''}{route}"


def init_packed_state(pt: PallasBrickTables):
    """Zero state: (S,) elastic, (S, conv[, conv_mix]) BKT."""
    S = torch.zeros((8, pt.LEN), dtype=pt.dtype, device=pt.device)
    if pt.damping != "bkt":
        return (S,)
    return (S,) + tuple(torch.zeros(shape, dtype=dt, device=pt.device)
                        for shape, dt in pt.step.state_parts(pt.LEN))


def fit_packed_state(pt: PallasBrickTables, state):
    """A copy of ``state`` in the solver's layout, type and device.
    Elastic: S [8, LEN] (or (S,)).  BKT: (S, conv [R, LEN]) on the
    uniform and corner tiers, (S, conv[, conv_mix [R, 8, M]]) on the node
    tier; parts left out start at zero."""
    parts = tuple(state) if isinstance(state, (tuple, list)) else (state,)
    want = init_packed_state(pt)
    if len(parts) > len(want):
        raise ValueError(f"state has {len(parts)} parts, the "
                         f"{pt.damping} solver {len(want)}")
    out = []
    for x, z in zip(parts, want):
        t = torch.as_tensor(x).to(dtype=z.dtype, device=z.device)
        if t.shape != z.shape:
            raise ValueError(f"state part must be {list(z.shape)}, got "
                             f"{list(t.shape)}")
        out.append(t.clone())
    return tuple(out) + want[len(out):]


def packed_snap_of(state):
    """(u, up[, conv[, conv_mix]]) views of the packed state."""
    return (state[0][0:3], state[0][3:6]) + tuple(state[1:])


def _step_once(pt, state, spare):
    """One step of the step kernel from ``state`` into ``spare`` (S and
    conv; the node tier's epilogue returns a new conv_mix).  ``state``
    stays as it was: the epilogue reads it after the kernel."""
    if len(state) == 1:
        return (pt.step(state[0], out=spare[0]),)
    return pt.step(*state, out=spare[0], conv_out=spare[1])


def step_advance(pt, src_forces, dt2):
    """advance(state, s, k) for the step route: k steps of K1, K2, K3
    (with its epilogue) or K4, with the station sampling before and the
    source add after each (pallas_brick.py:3435-3460)."""
    invm_src = (None if pt.src_pos is None
                else pt.K[pt.invm_row, pt.src_pos])

    def advance(state, s, k):
        spare = tuple(torch.empty_like(x) for x in state)
        srcf = None
        if pt.src_pos is not None:
            srcf = torch.as_tensor(src_forces[s:s + k] * dt2,
                                   dtype=pt.dtype, device=pt.device)
        samples = []
        for i in range(k):
            samples.append(sample_stations(state[0], pt.st_pos, pt.st_phi))
            new = _step_once(pt, state, spare)
            if srcf is not None:
                new[0][0:3].index_add_(1, pt.src_pos,
                                       srcf[i].T * invm_src[None, :])
            state, spare = new, state
        return state, torch.stack(samples).cpu().numpy()

    return advance


def source_increments(pt, src_forces, dt2, s, k):
    """[k, 3, L] source increments of steps [s, s+k) in the working
    type, as brick_chunk takes them: f dt^2 rounds to the working type
    first, then multiplies inv_mass at the source node -- the rounding
    of the brick_step route's ``srcf.T * invm``."""
    if pt.src_pos is None:
        return torch.zeros((k, 3, 0), dtype=pt.dtype, device=pt.device)
    f = np.asarray(np.asarray(src_forces[s:s + k]) * dt2,
                   pt.src_invm.dtype)
    inc = f.transpose(0, 2, 1) * pt.src_invm[None, None, :]
    return torch.as_tensor(np.ascontiguousarray(inc), device=pt.device)


def chunk_advance(pt, src_forces, dt2):
    """advance(state, s, k) for the chunk route: one launch of K5 (K6)."""

    def advance(state, s, k):
        srcf = source_increments(pt, src_forces, dt2, s, k)
        *state, samples = pt.step.chunk(*state, srcf, pt.src_pos,
                                        pt.st_pos, pt.st_phi)
        return tuple(state), samples.cpu().numpy()

    return advance


def run_pallas_solver(plan, tables, src_ids, src_forces, total_steps, dt,
                      st_nodes=None, st_phi=None, dtype=torch.float32,
                      device="cuda", chunk=None, state=None, on_chunk=None,
                      start_step=0, on_samples=None, route=None,
                      bkt_tier=None, on_route=None):
    """Chunked time loop on one brick; the contract of the JAX
    package's run_pallas_solver.  ``state``: an initial packed state
    (tensors or arrays, see fit_packed_state), zero when None.
    ``route``: "chunk" (brick_chunk / bkt_chunk) or "step" (the step
    kernel of the damping and BKT tier); None picks by chunk_applies.
    ``bkt_tier`` forces a BKT tier (PallasBrickTables).  ``on_route``,
    if given, is called with the route's name (route_name) before the
    loop.  Returns ((u, up) as [3, LEN] views, then the memory variables
    for BKT: conv [R, LEN][, conv_mix [R, 8, M]]; samples [T, ns, 3]
    numpy).  Runs on the CUDA device unless ``device`` is the CPU."""
    device = solver_device(device)
    with measure("Solver tables", device):
        pt = PallasBrickTables(plan, tables, src_ids=src_ids,
                               st_nodes=st_nodes, st_phi=st_phi,
                               dtype=dtype, device=device,
                               bkt_tier=bkt_tier)
    state = (init_packed_state(pt) if state is None
             else fit_packed_state(pt, state))
    if chunk is None:
        chunk = min(total_steps, 1000)
    if route is None:
        route = ("chunk" if chunk_applies(dtype, pt.n_src, pt.n_st,
                                          pt.bkt_tier) else "step")
    elif route == "chunk" and pt.bkt_tier not in (None, "uniform"):
        raise ValueError(f"no chunk kernel for the {pt.bkt_tier} BKT tier")
    if on_route is not None:
        on_route(route_name(pt, route))
    make = {"chunk": chunk_advance, "step": step_advance}[route]
    advance = make(pt, src_forces, dt * dt)
    if on_chunk is not None:
        inner = on_chunk
        on_chunk = lambda done, st: inner(done, packed_snap_of(st))
    with measure("Solver time loop", device):
        state, samples = run_chunked(advance, state, total_steps,
                                     start_step=start_step, chunk=chunk,
                                     on_chunk=on_chunk,
                                     on_samples=on_samples)
    return packed_snap_of(state), samples


def pallas_u_global(plan, u_pad, N):
    """Global [N, 3] displacement from the padded [3, LEN] field."""
    b = plan.bricks[0]
    arr = np.asarray(torch.as_tensor(u_pad).cpu())[:, :b.nb].T
    u = np.zeros((N, 3), arr.dtype)
    u[plan.gnid_cat] = arr
    return u
