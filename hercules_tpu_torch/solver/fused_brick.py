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
(K2), bkt_node_step (K3, the mixed elements included) or
bkt_corner_step (K4) -- once per step, with the source add and the
station sampling that the JAX package does around its step kernels in
one ``SourceSample`` launch between two steps (``step_advance``; on a
CUDA device an elastic brick's chunks replay from a CUDA graph).
``route_name`` names the route.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..physics.kmats import stiffness_matrices_24

from ..kernels.brick_chunk import brick_chunk
from ..kernels.brick_step import brick_step, brick_step_lean, step_grid_of
from ..kernels.source_sample import SourceSample, increments
from ..kernels.tiles import heavy_warp_share
from ..utils.timers import GLOBAL_TIMERS, measure
from .chunking import ChunkBuffers, ChunkGraphs, run_chunked
from .fused_bktq import bkt_step_module
from .restart import Checkpoint, fit_conv


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


def pack_constants(plan, tables, LEN, masked=None):
    """K [8, LEN] in float64 (see the module docstring).  ``masked``:
    optional bool [nb], columns whose element K1 must leave out (the
    nonlinear elements, whose force the mesh route's subset pass adds):
    their c1, c2 and beta are 0, as the JAX package's linear-element map
    zeroes them (pallas_mesh.py:279-286)."""
    g = plan.gnid_cat
    keep = plan.evalid_cat if masked is None else \
        plan.evalid_cat & ~np.asarray(masked, bool)

    def etab(k):
        return np.where(keep, getattr(tables, k)[plan.eidx_cat], 0.0)

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
    stiffness operators, stacked as ops = -[M1; M2] [48, 24], which the
    plain versions multiply by (the kernels K1 and K5 form the force
    from the operators' spectral factors and take no ops)."""

    def __init__(self, K, offs):
        super().__init__()
        self.offs = tuple(int(o) for o in offs)
        self.register_buffer("K", K)
        self.register_buffer("ops", operators(K.dtype, K.device))

    def forward(self, S, out=None):
        """One step of the layout S (K1's canonical form, brick_step):
        the step of the mesh route and of the multi-card fragments."""
        return brick_step(S, self.K, self.offs, self.ops, out=out)

    def lean(self, U, Um, out, canonical=False):
        """One step from u = U and u- = Um into out (K1's lean form,
        brick_step_lean)."""
        return brick_step_lean(U, Um, self.K, self.offs, self.ops, out,
                               canonical)

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


def fit_field_cm(plan, x, LEN):
    """A displacement field as the brick's [3, LEN] (numpy, in the
    field's type), or the plain brick solver's [3, plan.total_nb] over
    the plan's concatenated columns: canonical global [N, 3], or
    component-major [3, X] in the plan's column order with any padding
    (the JAX package's single-brick checkpoints), cut or zero-padded to
    LEN."""
    x = np.asarray(x)
    if x.ndim == 2 and x.shape[1] == 3 and x.shape[0] != 3:
        x = x[plan.gnid_cat].T
    if x.ndim != 2 or x.shape[0] != 3:
        raise RuntimeError("checkpoint field layout does not match the "
                           "brick layout")
    out = np.zeros((3, LEN), x.dtype)
    w = min(LEN, x.shape[1])
    out[:, :w] = x[:, :w]
    return out


def restore_packed_state(pt: PallasBrickTables, plan, ck: Checkpoint):
    """The packed state of a checkpoint (restart.Checkpoint): S from the
    two fields (fit_field_cm); for BKT the memory variables of the
    brick's tier from ``ck.conv`` (restart.fit_conv: conv, then the node
    tier's conv_mix; the other basis converted), in the solver's types
    and device."""
    S = np.zeros((8, pt.LEN))
    S[0:3] = fit_field_cm(plan, ck.u_now, pt.LEN)
    S[3:6] = fit_field_cm(plan, ck.u_prev, pt.LEN)
    conv = ()
    if pt.damping == "bkt":
        conv = fit_conv(pt.step, pt.LEN, ck.conv)
    return fit_packed_state(pt, (S,) + conv)


def packed_snap_of(state):
    """(u, up[, conv[, conv_mix]]) views of the packed state."""
    return (state[0][0:3], state[0][3:6]) + tuple(state[1:])


def _step_once(pt, state, spare):
    """One step of a BKT step kernel from ``state`` into ``spare`` (S,
    then conv, then the node tier's conv_mix)."""
    outs = dict(zip(("out", "conv_out", "conv_mix_out"), spare))
    return pt.step(*state, **outs)


@lru_cache(maxsize=None)
def ring_plan(k, lean=True):
    """The k steps of a chunk of the step route, each (u, u-, out,
    canonical) in numbers of 3-row blocks: 0 and 1 are rows 0:3 and 3:6
    of the state's S [8, LEN], where the chunk finds u and u-, and 2 and
    3 those of its spare.  A lean step reads u and u- from their blocks
    and writes u+ alone into a block that holds neither (K1's lean
    form), so the next step's u- stays where it lies; a canonical step
    writes the layout S (u+, u, 0, 0) into the buffer of first block
    ``out``, which holds neither (K1's lean form with ``canonical``, or
    every other step kernel).  The last step is canonical, so that each
    chunk ends on the layout every reader of the state takes.  Of the
    plans that do, the one with the fewest canonical steps, and of
    those one that ends in the state's own buffer: at k = 3 and from k
    = 5 a single canonical step does both; k = 2 takes two, and k = 1
    and 4 end in the spare.  Without ``lean`` every step is canonical:
    S and its spare in turn."""
    layer = {(0, 1): 0}               # (u, u-) blocks -> canonical steps
    back = []                         # per step: (u, u-) -> its step
    for i in range(k):
        nxt, came = {}, {}
        for (u, um), n in layer.items():
            free = [x for x in range(4) if x not in (u, um)]
            moves = [((x, u), False) for x in free if lean and i < k - 1]
            moves += [((b, b + 1), True) for b in (0, 2)
                      if b in free and b + 1 in free]
            for to, canon in moves:
                if to not in nxt or n + canon < nxt[to]:
                    nxt[to] = n + canon
                    came[to] = (u, um, to[0], canon)
        back.append(came)
        layer = nxt
    at = min(layer, key=lambda b: (layer[b], b[0] != 0))
    steps = []
    for came in reversed(back):
        steps.append(came[at])
        at = came[at][:2]
    return tuple(reversed(steps))


def source_increments(pt, src_forces, dt2, s, k):
    """[k, 3, L] source increments of steps [s, s+k) on the tables'
    device, as brick_chunk takes them (``source_sample.increments``)."""
    if pt.src_pos is None:
        return torch.zeros((k, 3, 0), dtype=pt.dtype, device=pt.device)
    return torch.as_tensor(increments(src_forces[s:s + k], dt2,
                                      pt.src_invm), device=pt.device)


def chunk_steps(pt, io, state, spare, bufs, k):
    """k steps of the step kernel from ``state`` as ``ring_plan`` lays
    them over the displacement blocks of the state and its spare (lean
    steps on an elastic brick, every step canonical on BKT), the
    stations sampled before each (row i of bufs.samples) and the sources
    added after it (row i of bufs.inc): the first step's samples before
    it, then after each step one ``io`` call that adds its increments to
    the u+ it wrote and samples the next step's state.  Returns (the
    state, its spare): the state's tensors where the plan ends there."""
    elastic = len(state) == 1
    plan = ring_plan(k, elastic)
    pair = (state, spare)
    blocks = [x[0][r:r + 3] for x in pair for r in (0, 3)]
    io(blocks[0], samples=bufs.samples[0])
    for i, (u, um, out, canon) in enumerate(plan):
        if not canon:
            pt.step.lean(blocks[u], blocks[um], blocks[out])
        elif elastic:
            pt.step.lean(blocks[u], blocks[um], pair[out // 2][0], True)
        else:
            _step_once(pt, pair[u // 2], pair[out // 2])
        io(blocks[out], bufs.inc[i], bufs.samples[i + 1] if i + 1 < k
           else None)
    end = plan[-1][2] // 2
    return pair[end], pair[1 - end]


def step_advance(pt, src_forces, dt2, chunk):
    """advance(state, s, k) for the step route: k steps of K1, K2, K3
    or K4, with the station sampling before and the source add after
    each (pallas_brick.py:3435-3460), both in one ``SourceSample`` call
    between two steps (chunk_steps).  An elastic brick's steps take
    K1's lean form over the displacement blocks of the state and its
    spare (``ring_plan``), the chunk's last step the layout S.

    On a CUDA device an elastic brick's full chunks (k = ``chunk``,
    where its plan ends in the state's own buffer: every k but 1 and 4)
    replay from a CUDA graph (``ChunkGraphs``): the first runs
    uncaptured, which checks every call signature, then its k steps are
    captured once, into the state's buffers and their spare, and each
    later one uploads its increments and replays.  A run's short last
    chunk, a ``chunk`` whose plan ends in the spare, the BKT tiers and
    the CPU run uncaptured through the same chunk_steps."""
    io = SourceSample(pt.src_pos, pt.st_pos, pt.st_phi)
    graphs = ChunkGraphs([pt.device], chunk, pt.device.type == "cuda"
                         and pt.damping != "bkt")
    bufs = {}
    held = {"spare": None}

    def run(state, b, k):
        sp = held["spare"]
        if sp is None or sp[0] is state[0]:
            sp = tuple(torch.empty_like(x) for x in state)
        state, held["spare"] = chunk_steps(pt, io, state, sp, b, k)
        return state

    def advance(state, s, k):
        b = bufs.get(k)
        if b is None:
            b = bufs[k] = ChunkBuffers((k, 3, pt.n_src), (k, pt.n_st, 3),
                                       pt.dtype, pt.device)
        with GLOBAL_TIMERS.span("Solver forces upload"):
            if pt.src_pos is not None:
                b.upload(increments(src_forces[s:s + k], dt2,
                                    pt.src_invm))
        with GLOBAL_TIMERS.span("Solver issue"):
            state = graphs(state, k, lambda st: run(st, b, k))
        return state, b.samples

    return advance


def chunk_advance(pt, src_forces, dt2):
    """advance(state, s, k) for the chunk route: one launch of K5 (K6)."""

    def advance(state, s, k):
        with GLOBAL_TIMERS.span("Solver forces upload"):
            srcf = source_increments(pt, src_forces, dt2, s, k)
        with GLOBAL_TIMERS.span("Solver issue"):
            *state, samples = pt.step.chunk(*state, srcf, pt.src_pos,
                                            pt.st_pos, pt.st_phi)
        return tuple(state), samples

    return advance


def note_k1_tile(pt):
    """Count K1's tile width on the brick of ``pt`` (as the library
    chooses it, step_grid_of) and its heavy-warp share
    (tiles.heavy_warp_share) on the open "Solver tables" span, as
    ``k1_tile_width`` and ``k1_heavy_warp_share``."""
    width = step_grid_of(pt.offs, pt.LEN, pt.dtype, pt.K.device.index)[5]
    GLOBAL_TIMERS.add("Solver tables", "k1_tile_width", width)
    GLOBAL_TIMERS.add("Solver tables", "k1_heavy_warp_share",
                      heavy_warp_share(pt.offs, width))


def run_pallas_solver(plan, tables, src_ids, src_forces, total_steps, dt,
                      st_nodes=None, st_phi=None, dtype=torch.float32,
                      device="cuda", chunk=None, state=None, on_chunk=None,
                      start_step=0, on_samples=None, route=None,
                      bkt_tier=None, on_route=None):
    """Chunked time loop on one brick; the contract of the JAX
    package's run_pallas_solver.  ``state``: an initial packed state
    (tensors or arrays, see fit_packed_state), zero when None.
    A restart.Checkpoint as ``state`` resumes it (restore_packed_state)
    at ``start_step``.
    ``route``: "chunk" (brick_chunk / bkt_chunk) or "step" (the step
    kernel of the damping and BKT tier); None picks by chunk_applies.
    ``bkt_tier`` forces a BKT tier (PallasBrickTables).  ``on_route``,
    if given, is called with the route's name (route_name) before the
    loop.  The "Solver tables" span of K1's route on the card counts
    K1's tile (note_k1_tile).  Returns ((u, up) as [3, LEN] views, then
    the memory variables for BKT: conv [R, LEN][, conv_mix [R, 8, M]];
    samples [T, ns, 3] numpy).  Runs on the CUDA device unless ``device`` is the CPU."""
    device = solver_device(device)
    with measure("Solver tables", device):
        pt = PallasBrickTables(plan, tables, src_ids=src_ids,
                               st_nodes=st_nodes, st_phi=st_phi,
                               dtype=dtype, device=device,
                               bkt_tier=bkt_tier)
        if route is None:
            route = ("chunk" if chunk_applies(dtype, pt.n_src, pt.n_st,
                                              pt.bkt_tier) else "step")
        if (route == "step" and isinstance(pt.step, BrickStep)
                and pt.device.type == "cuda"):
            note_k1_tile(pt)
    if route == "chunk" and pt.bkt_tier not in (None, "uniform"):
        raise ValueError(f"no chunk kernel for the {pt.bkt_tier} BKT tier")
    if state is None:
        state = init_packed_state(pt)
    elif isinstance(state, Checkpoint):
        state = restore_packed_state(pt, plan, state)
    else:
        state = fit_packed_state(pt, state)
    if chunk is None:
        chunk = min(total_steps, 1000)
    if on_route is not None:
        on_route(route_name(pt, route))
    advance = (chunk_advance(pt, src_forces, dt * dt) if route == "chunk"
               else step_advance(pt, src_forces, dt * dt, chunk))
    if on_chunk is not None:
        inner = on_chunk
        on_chunk = lambda done, st: inner(done, packed_snap_of(st))
    with measure("Solver time loop", device):
        state, samples = run_chunked(advance, state, total_steps,
                                     start_step=start_step, chunk=chunk,
                                     on_chunk=on_chunk,
                                     on_samples=on_samples,
                                     device=pt.device)
    return packed_snap_of(state), samples


def pallas_u_global(plan, u_pad, N, gnid=None):
    """Global [N, 3] displacement (numpy, in the field's type) from the
    padded [3, LEN] field of a one-brick plan, or the [3, TOT] field of
    the plain brick solver over the plan's concatenated columns:
    scattered where the field lies, then one copy to the host.
    ``gnid``: plan.gnid_cat already on the field's device (copied there
    when None)."""
    t = torch.as_tensor(u_pad)
    if gnid is None:
        gnid = torch.as_tensor(plan.gnid_cat, device=t.device)
    u = t.new_zeros((N, 3))
    u[gnid] = t[:3, :len(plan.gnid_cat)].T
    return u.cpu().numpy()
