"""K7, the streaming probe: its plain version against the JAX tool's
Pallas body (interpret mode), the probe's refusal to run without a
CUDA device, and the roofline counts of every ported kernel."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from hercules_tpu_torch.kernels.stream_add import (stream_add,
                                                   stream_add_plain)
from hercules_tpu_torch.tools import hbm_ceiling
from hercules_tpu_torch.utils import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX tool's grid at a small size: T blocks of (8, B)
B, T = 128, 3
LEN = T * B


def jax_stream(a, b, aliased):
    """The pallas_call of hercules_tpu/tools/hbm_ceiling.py:69-79 (its
    body is local to main), run in interpret mode."""
    def kern(x, y, o):
        o[...] = x[...] + y[...]

    alias = {"input_output_aliases": {0: 0}} if aliased else {}
    call = pl.pallas_call(
        kern, grid=(T,),
        in_specs=[pl.BlockSpec((8, B), lambda t: (0, t))] * 2,
        out_specs=pl.BlockSpec((8, B), lambda t: (0, t)),
        out_shape=jax.ShapeDtypeStruct((8, LEN), jnp.float32),
        interpret=True, **alias)
    return np.asarray(call(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("aliased", [False, True], ids=["plain", "aliased"])
def test_plain_matches_jax_pallas_body(aliased):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((8, LEN)).astype(np.float32)
    b = rng.standard_normal((8, LEN)).astype(np.float32)
    want = jax_stream(a, b, aliased)
    at, bt = torch.from_numpy(a.copy()), torch.from_numpy(b)
    before = stream_add.launches
    if aliased:
        got = stream_add_plain(at, bt, out=at)
        assert got.data_ptr() == at.data_ptr()
        wrapped = torch.from_numpy(a.copy())
        stream_add(wrapped, bt, out=wrapped)
    else:
        got = stream_add_plain(at, bt)
        wrapped = stream_add(torch.from_numpy(a), bt)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(wrapped.numpy(), want)
    # the CPU path is the plain version: no kernel launch counted
    assert stream_add.launches == before


def test_probe_needs_cuda(monkeypatch):
    """Without a CUDA device the probe exits non-zero, as a function and
    as ``python -m``; it has no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        hbm_ceiling.main()
    assert e.value.code not in (0, None)
    r = subprocess.run(
        [sys.executable, "-m", "hercules_tpu_torch.tools.hbm_ceiling"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "GB/s" not in r.stdout


def test_probe_shape():
    """The probe keeps the JAX tool's sizes and byte count."""
    assert (hbm_ceiling.B, hbm_ceiling.T, hbm_ceiling.N) == (32768, 33, 50)
    assert hbm_ceiling.BYTES_PER_ITERATION == 3 * 8 * 33 * 32768 * 4
    k7 = roofline.kernel_cost("stream_add", hbm_ceiling.LEN, 0)
    assert k7.bytes == k7.moved == hbm_ceiling.BYTES_PER_ITERATION
    assert k7.bound_by == "bytes"


# (kernel, its arguments, (rows, halo rows) x LEN x 4 B the kernel
# streams per step: the hand counts of the timings so far, the halo rows
# read CORNER_HALO times; and its operations per element and per column:
# the spectral force (330 elastic, 426 BKT), W (72), the update (15),
# the recursion (3 x (1 + 16 per pair)), K3's set scaling (24), K4's
# corner recursion (48 + 24 x 16 per pair)).  K1's tile march reads S 6
# and K 3 (c1, c2, beta) for the planes and the element force, K 4 and
# S 6:8 for the update (u and u- from shared memory) and writes S' 8.
# K2 and K3 stream no dv since their force passes moved into their one
# launch: K2 reads S 6, K 1 (force), S 8 and K 4 (update), writes S' 8
# and moves conv 6 rows in and out.  K4 streams no element force since
# its two passes became one launch: it reads S 6 (planes), S 8 and K 4
# (update), writes S' 8 and conv' (96 bfloat16 = 48 rows), and reads
# its element rows of K (mu_f, kappa_f, two set indices: 4) and conv
# (48) with its halo elements'.
HAND_COUNTS = [
    ("brick_step", {}, (23, 0), 330 + 72, 15),
    ("bkt_step", dict(conv_rows=6, conv_dtype=torch.float32), (39, 0), 426,
     15 + 3 * 17),
    ("bkt_node_step", dict(conv_rows=12, conv_dtype=torch.bfloat16),
     (41, 0), 426 + 24, 15 + 3 * 33),
    ("bkt_corner_step", dict(conv_rows=96, conv_dtype=torch.bfloat16),
     (74, 52), 426 + 48 + 24 * 16 * 2, 15)]
# K3 with the four-layer box's mixed set at 2^20 elements: conv_mix in
# and out (2 x 12 x 8 bfloat16 values) and the 18 recursion rows in
# float32; the membership as M int32 columns (the function) or an int32
# slot of every column (the kernel); the recursion at 8 corners x 3
# components x (1 + 2 x 16) per mixed element
MIXED = 49533
MIXED_BYTES = MIXED * (2 * 12 * 8 * 2 + 18 * 4)
MIXED_FLOP = MIXED * 8 * 3 * 33


@pytest.mark.parametrize("name,kw,rows,per_element,per_column", HAND_COUNTS,
                         ids=[h[0] for h in HAND_COUNTS])
def test_roofline_hand_counts(name, kw, rows, per_element, per_column):
    L, E = 1082368, 1 << 20
    c = roofline.kernel_cost(name, L, E, **kw)
    plain, halo = rows
    assert c.moved == plain * L * 4 + (roofline.CORNER_HALO * (halo * L * 4)
                                       if halo else 0)
    # the function's own bytes never exceed the kernel's traffic
    assert 0 < c.bytes < c.moved
    assert c.flop == per_element * E + per_column * L
    # at 2^20 elements every step kernel streams more than it computes
    assert c.bound_by == "bytes"
    assert c.bound_ms == 1e3 * max(c.bytes / 3.35e12, c.flop / 67e12)


def test_roofline_hand_count_mixed():
    """K3's mixed set adds its state and rows to both byte counts, its
    membership as M column indices to the function's bytes and as the
    slot array to the kernel's traffic, and its corner recursion to the
    operations: about 23 MB, for a bound of about 157 MB (0.047 ms) at
    2^20 elements."""
    L, E = 1082368, 1 << 20
    kw = dict(conv_rows=12, conv_dtype=torch.bfloat16)
    base = roofline.kernel_cost("bkt_node_step", L, E, **kw)
    c = roofline.kernel_cost("bkt_node_step", L, E, mixed=MIXED, **kw)
    assert c.bytes - base.bytes == MIXED_BYTES + 4 * MIXED
    assert c.moved - base.moved == MIXED_BYTES + 4 * L
    assert c.moved == 41 * L * 4 + MIXED_BYTES + 4 * L
    assert c.flop == (426 + 24) * E + (15 + 3 * 33) * L + MIXED_FLOP
    assert 156e6 < c.bytes < 158e6 and c.bound_by == "bytes"
    assert 0.0467 < c.bound_ms < 0.0470


def test_element_flop_counts_the_spectral_factors():
    """The element count follows the nonzeros of the JAX package's
    spectral factors: butterflies in and out, a multiply-add per
    nonzero, 48 scalings, 24 scatter adds."""
    from hercules_tpu.physics import kmats
    nnz = sum(len(f) for f in kmats.spectral_factors())
    nnz_bkt = sum(len(f) for f in kmats.spectral_bkt_factors())
    assert (nnz, nnz_bkt) == (33 + 24, 45 + 24)
    assert roofline.element_flop(False) == 2 * 72 + 2 * nnz + 72 == 330
    assert roofline.element_flop(True) == 3 * 72 + 2 * nnz_bkt + 72 == 426


def test_roofline_chunk_amortises():
    """On the 2048-element box (its state far inside the L2 cache) the
    chunk kernels read their state once per launch."""
    L, E = 3072, 2048
    step = roofline.kernel_cost("brick_step", L, E)
    chunk = roofline.kernel_cost("brick_chunk", L, E, chunk=20)
    assert chunk.bytes == step.bytes / 20
    assert (chunk.moved, chunk.flop) == (step.moved, step.flop)
    assert chunk.bound_by == "operations"
    f64 = roofline.kernel_cost("brick_step", L, E, dtype=torch.float64)
    assert f64.flop == step.flop and f64.bytes == 2 * step.bytes
    with pytest.raises(ValueError, match="no cost model"):
        roofline.kernel_cost("brick_stp", L, E)


@pytest.mark.parametrize("name,conv_rows", [("brick_chunk", 0),
                                            ("bkt_chunk", 6),
                                            ("bkt_chunk", 12)])
def test_roofline_chunk_amortises_only_in_l2(name, conv_rows):
    """A chunk kernel's bytes are amortised over its steps only while S
    and K [8, LEN] each and conv fit the 50 MB L2 cache: just inside
    the cache by the launch, just outside by the step, and at 2^20
    elements (69 MB and more) by the step."""
    kw = dict(conv_rows=conv_rows, conv_dtype=torch.float32)
    per_col = 4 * (16 + conv_rows)            # float32 bytes per column
    assert roofline.L2_BYTES == 50 * 2 ** 20
    inside = roofline.L2_BYTES // per_col
    for L, fits in ((inside, True), (inside + 1, False),
                    (1082368, False)):
        E = L // 2
        step = roofline.kernel_cost(name.replace("chunk", "step"), L, E,
                                    **kw)
        chunk = roofline.kernel_cost(name, L, E, chunk=400, **kw)
        assert chunk.bytes == (step.bytes / 400 if fits else step.bytes)
        assert (chunk.moved, chunk.flop) == (step.moved, step.flop)
    big = roofline.kernel_cost(name, 1082368, 1 << 20, chunk=400, **kw)
    assert big.bound_by == "bytes"
    assert 16 * 1082368 * 4 > 69e6 > roofline.L2_BYTES


def test_route_costs_of_tables(tmp_path):
    """route_costs names the kernels of each tier's routes and counts
    them at the tables' LEN, type and memory-variable rows."""
    from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, box_simulation,
                                             four_q_freq)
    from hercules_tpu_torch.solver.bricks import build_plan
    from hercules_tpu_torch.solver.fused_brick import PallasBrickTables
    cases = {("brick_step", "brick_chunk"): {},
             ("bkt_step", "bkt_chunk"): dict(damping="bkt"),
             ("bkt_corner_step",): dict(damping="bkt", layers=FOUR_Q_LAYERS,
                                        freq=four_q_freq(62.5))}
    for names, case in cases.items():
        sim = box_simulation(str(tmp_path / names[0]), steps=2, **case)
        pt = PallasBrickTables(build_plan(sim.mesh), sim.tables,
                               device="cpu")
        costs = roofline.route_costs(pt, sim.mesh.lenum, chunk=4)
        assert tuple(costs) == names
        kw = {}
        if pt.bkt_tier is not None:
            kw = dict(conv_rows=pt.step.conv_rows,
                      conv_dtype=pt.step.conv_dtype)
        assert costs[names[0]] == roofline.kernel_cost(
            names[0], pt.LEN, sim.mesh.lenum, **kw)
