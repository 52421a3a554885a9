"""Roofline of the port's kernels: bytes and operations per step,
counted from the shapes, and the least time an H100 could take for them.

The port's counterpart of the roofline section of the JAX bench
(``bench.py:751-817``), which divides each route's HBM bytes per step
by the measured streaming ceiling (``tools/hbm_ceiling.py``).  Here
every kernel K1-K7 gets two byte counts and one operation count per
step:

- ``bytes``: what the function must move -- each input row that holds
  data read once, each output row that holds data written once (the
  zero padding rows S[6:8] and K's unused rows are not counted, nor the
  operator constants of a few kB).  The bound uses this count.
- ``moved``: what the port's kernel itself streams per step, with the
  state and constants it reads again in the same step (the tiled K2,
  K3, K4 and K6 read S once for their planes and again for the update;
  K1 and K5 read it once; K4 re-reads the halo elements' K rows 4:8
  and conv rows, ``CORNER_HALO`` of them).  Achieved bandwidth uses this
  count.
- K3's mixed elements (``mixed``, M of them) add their corner-basis
  state conv_mix in and out (2 R 8 M storage words) and their recursion
  rows (9 | 18 per element) to both byte counts, and their recursion at
  8 corners to the operations.  Which columns are mixed is M int32
  column indices in ``bytes`` (what the function needs) and the kernel's
  per-column slot array (4 bytes per column) in ``moved``.
- ``flop``: the algebra each element and node needs, counted once, in
  the spectral form the TPU kernels use (``physics/kmats.py``: 8-point
  Hadamard butterflies around a multiply-add per nonzero of the sparse
  spectral factors, about 330-430 operations per element instead of a
  dense [24, 48] product's 2,304), not the kernels' repeated per-node
  work.

The chunk kernels (K5, K6) take ``chunk`` steps in one launch.  Where
their state and constants (S, conv and K as the kernel holds them) fit
the card's L2 cache, they need to read them from device memory only once
per launch, and their ``bytes`` is the step kernel's divided by
``chunk``; where they do not (at 2^20 elements they come to 69 MB and
more, against 50 MB), every step streams them, and ``bytes`` is the
step kernel's.  Their ``flop`` and ``moved`` are per step.  Their
sources and samples (at most 128 columns each) are left out.

The bound is max(bytes / 3.35 TB/s, flop / peak), the peak being the
H100 SXM data sheet's non-tensor rate for the arithmetic type (67
TFLOP/s float32, 34 TFLOP/s float64) at its 700 W power limit;
``bound_by`` says which term sets it.
"""

from __future__ import annotations

import functools
import subprocess
from dataclasses import dataclass

import torch

from ..physics.kmats import spectral_bkt_factors, spectral_factors

# H100 SXM data sheet (700 W): HBM3 rate, non-tensor arithmetic rates,
# L2 cache (50 MB)
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

# one 8-point Hadamard over the corners of a 24-vector: 3 butterfly
# stages of 8 adds or subtractions, for each of 3 components
BUTTERFLY_FLOP = 3 * 8 * 3
# per node: u+ = u + (force + mm (u - u-)) inv_mass, 3 components
UPDATE_FLOP = 3 * 5
# per node component and memory-variable pair: s0', s1' (5 each), dv (6)
PAIR_FLOP = 16
# K4's reads of an element's K rows 4:8 and conv rows per element: a
# block's 32 x 8 element tile owns 31 x 7, and each 2-plane slab
# recomputes the element plane below it (bkt_corner.cu; large bricks'
# slabs)
CORNER_HALO = (32 * 8) / (31 * 7) * 3 / 2


@functools.cache
def element_flop(bkt: bool) -> int:
    """Operations of one element's force in the spectral form: the
    forward Hadamard of each input field (the elastic W; BKT's dvs and
    dvk), a multiply-add per nonzero of the two sparse factors (M1, M2
    or KMU, KKAPPA), the inverse Hadamard, the 48 products that scale
    the two operators' inputs (c1, c2) or outputs (mu_f, kappa_f) and
    the 24 scatter adds: 330 elastic, 426 BKT."""
    factors = spectral_bkt_factors() if bkt else spectral_factors()
    fields = 2 if bkt else 1
    return ((fields + 1) * BUTTERFLY_FLOP
            + 2 * sum(len(f) for f in factors) + 48 + 24)


@dataclass(frozen=True)
class KernelCost:
    """One kernel's bytes and operations per step (module docstring)."""

    name: str
    bytes: float
    moved: float
    flop: float
    dtype: torch.dtype = torch.float32

    @property
    def bound_ms(self) -> float:
        """The least time the card could take, in ms per step."""
        return 1e3 * max(self.bytes / PEAK_BYTES_PER_S,
                         self.flop / PEAK_FLOP_PER_S[self.dtype])

    @property
    def bound_by(self) -> str:
        """"bytes" or "operations": the term that sets the bound."""
        return ("bytes" if self.bytes / PEAK_BYTES_PER_S
                >= self.flop / PEAK_FLOP_PER_S[self.dtype] else "operations")


def kernel_cost(name, LEN, elements, dtype=torch.float32, conv_rows=0,
                conv_dtype=None, chunk=1, mixed=0) -> KernelCost:
    """Cost per step of kernel ``name`` (a wrapper's name: brick_step,
    brick_chunk, bkt_step, bkt_chunk, bkt_node_step, bkt_corner_step,
    stream_add) on [*, LEN] arrays in ``dtype`` with ``elements`` mesh
    elements; BKT kernels take their memory variables' rows and storage
    type (``conv_rows``, ``conv_dtype``), the chunk kernels the steps per
    launch (``chunk``), K3 its mixed elements (``mixed``)."""
    w = torch.empty((), dtype=dtype).element_size()
    L, E = int(LEN), int(elements)
    if name == "stream_add":
        nbytes = 3 * 8 * L * 4          # a and b read, out written
        return KernelCost(name, nbytes, nbytes, 8 * L, torch.float32)
    c = torch.empty((), dtype=conv_dtype or dtype).element_size()
    conv = 2 * conv_rows * L * c        # memory variables in and out
    # memory-variable pairs: 1 shear-only, 2 with kappa (6 | 12 rows per
    # node, or 48 | 96 per element in K4's corner basis)
    pairs = conv_rows // (48 if name == "bkt_corner_step" else 6)
    # K4's element rows of K: mu_f, kappa_f and a set index per pair
    krows = 2 + pairs
    rec = L * 3 * (1 + PAIR_FLOP * pairs)   # du once, then the pairs
    M = int(mixed)
    # K3's mixed set: conv_mix in and out, the rows; its membership as
    # the M column indices (bytes) or the slot of every column (moved)
    mix = 2 * conv_rows * 8 * M * c + (3 * conv_rows // 2) * M * w
    member, slots = (4 * M, 4 * L) if M else (0, 0)
    el, bkt = element_flop(False), element_flop(True)
    step = {
        # S (u, u-) 6 rows in, K 7 rows in, S' 6 rows out; the tile
        # march reads S 6 and K 3 (c1, c2, beta) for the planes and the
        # element force, K 4 and S 6:8 for the update (u and u- from
        # shared memory), writes S' 8; W = u + beta (u - u-) at the 8
        # corners
        "brick_step": (19 * L * w, 23 * L * w,
                       E * (el + 24 * 3) + L * UPDATE_FLOP),
        # S 6, K 5 (mm, inv_mass, element valid), S' 6; the kernel reads
        # S 6 (recursion), the element-valid row (element force), S 8
        # and K 4 (update), writes S' 8
        "bkt_step": (17 * L * w + conv, 27 * L * w + conv,
                     E * bkt + rec + L * UPDATE_FLOP),
        # S 6, K 7 (mm, inv_mass, mu_f, kappa_f, set index), S' 6; the
        # kernel reads S 6 and the set index (recursion), mu_f and
        # kappa_f (element force), S 8 and K 4 (update), writes S' 8;
        # each mixed element runs the recursion at its 8 corners
        "bkt_node_step": (19 * L * w + conv + mix + member,
                          29 * L * w + conv + mix + slots,
                          E * (bkt + 24) + rec + L * UPDATE_FLOP
                          + M * 8 * 3 * (1 + PAIR_FLOP * pairs)),
        # S 6, K 4 and the element rows, S' 6; the kernel reads S 6
        # (planes), the element rows and conv with its halo elements'
        # re-reads, S 8 and K 4 (update), writes conv' and S' 8; the
        # recursion runs on each element's 8 corners (24 rows per pair)
        # after forming du and u- there (48)
        "bkt_corner_step": ((16 + krows) * L * w + conv,
                            26 * L * w + conv / 2
                            + CORNER_HALO * (krows * L * w + conv / 2),
                            E * (bkt + 48 + 24 * PAIR_FLOP * pairs)
                            + L * UPDATE_FLOP),
    }
    chunked = {"brick_chunk": "brick_step", "bkt_chunk": "bkt_step"}
    if name in chunked:
        nbytes, moved, flop = step[chunked[name]]
        # S and K [8, LEN] each, and conv
        if 16 * L * w + conv // 2 <= L2_BYTES:
            nbytes /= chunk
        return KernelCost(name, nbytes, moved, flop, dtype)
    if name not in step:
        raise ValueError(f"no cost model for kernel {name!r}")
    return KernelCost(name, *step[name], dtype)


def route_costs(pt, elements, chunk=1) -> dict:
    """{name: KernelCost} of the kernels that run the routes of a
    ``PallasBrickTables``: its step kernel, and its chunk kernel (per
    step, at ``chunk`` steps per launch) where the tier has one."""
    step = pt.step
    kw = dict(LEN=pt.LEN, elements=elements, dtype=pt.dtype)
    if pt.bkt_tier is None:
        names = ("brick_step", "brick_chunk")
    else:
        kw.update(conv_rows=step.conv_rows, conv_dtype=step.conv_dtype)
        names = {"uniform": ("bkt_step", "bkt_chunk"),
                 "node": ("bkt_node_step",),
                 "corner": ("bkt_corner_step",)}[pt.bkt_tier]
        if pt.bkt_tier == "node":
            kw["mixed"] = step.mix_M
    return {n: kernel_cost(n, chunk=chunk, **kw) for n in names}


def step_cost(step, LEN, elements, dtype) -> KernelCost:
    """KernelCost per launch of a step module's kernel (fused_brick's
    BrickStep: K1; BktStep: K2; BktNodeStep: K3; BktCornerStep: K4) on
    [*, LEN] arrays with ``elements`` mesh elements."""
    tier = getattr(step, "tier", None)
    if tier is None:
        return kernel_cost("brick_step", LEN, elements, dtype)
    name = {"uniform": "bkt_step", "node": "bkt_node_step",
            "corner": "bkt_corner_step"}[tier]
    return kernel_cost(name, LEN, elements, dtype,
                       conv_rows=step.conv_rows,
                       conv_dtype=step.conv_dtype,
                       mixed=getattr(step, "mix_M", 0))


def unstructured_cost(tables, dtype=torch.float32) -> KernelCost:
    """Cost per step of the unstructured solver's elastic step
    (``solver/step.py``: torch ops, no kernel of its own) on the
    ``assemble`` tables: reading u and u- [N, 3], the element table
    lnid [E, 8], c1-c4 [E], inv_mass [N], mass_minusaM [N, 3] and the
    scatter plan (scat_perm [8E] and N segment lengths), indices as
    int32, and writing u+ [N, 3], each once; the operations of the dense
    [E, 48] @ [48, 24] product the step computes, its operand (7 per
    entry of the 24), the negation and the scatter adds, and the node
    update.  ``moved`` repeats ``bytes``: the torch ops' own traffic is
    not counted."""
    if tables.damping == "bkt":
        raise ValueError("the unstructured cost model is elastic only")
    N, E = tables.N, tables.E
    w = torch.finfo(dtype).bits // 8
    nbytes = (w * (2 * 3 * N + 4 * E + N + 3 * N + 3 * N)
              + 4 * (8 * E + 8 * E + N))
    flop = E * (2 * 48 * 24 + 7 * 24 + 24 + 24) + N * UPDATE_FLOP
    return KernelCost("unstructured_step", nbytes, nbytes, flop, dtype)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W")."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
