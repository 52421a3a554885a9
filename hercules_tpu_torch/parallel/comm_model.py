"""Per-step communication model of the multi-chip paths, and the
scaling it predicts across several cards.

Counterpart of ``hercules_tpu/parallel/comm_model.py`` (``HwModel``,
``PathComm``, ``slab_comm``, ``gslab_comm``, ``gmesh_comm``,
``sharded_comm``, ``predict``, ``slab_comm_dims``,
``plan_scaling_report``, ``scaling_report``).  Every path's exchange is
a fixed set of collectives of static shape (``ranks.RankGroup``), so the
bytes and phases per step follow from the partition tables;
tests/test_torch_comm_model.py holds them equal to what the group
counted in a run.  Byte counts are per rank per step, bytes sent, the
largest rank's; phases are the largest rank's too (the JAX package's
gslab model takes the phases of the rank that sends the most):

- slab (``slab.py``, both steps): two shifts of one [3, nyp * nxp]
  force plane, up and down the ring: 2 phases.
- gslab (``gslab.py``): the slab's two shifts per brick, and per
  interface whose two planes lie on different ranks two sends, the
  [9, plane] coarse (or second) triplet to the fine plane's rank and
  the reconciled [3, plane] back, each a phase at both ends.  (The JAX
  package counts one phase per end.)
- gmesh (``gmesh.py``): the slab's two shifts per brick and one allsum
  of the [K, 9] interface buffer, counted as the sharded path's.
- sharded (``sharded.py``): one allsum of the [B_pad, 3] boundary
  buffer.  The port reduces it on rank 0 in rank order and sends the
  total back (replicas then bit-identical): rank 0 sends (P - 1)
  buffers, 2 phases.  (The JAX package models its psums, here and in
  gmesh, as a ring all-reduce, 2 (P - 1) / P buffers in 2 (P - 1)
  phases.)

A prediction is only that: compute time from a measured one-card
element rate, split evenly over the cards, plus the exchange at the
link rate and a per-phase latency.  Nothing here is a measurement of
several cards; the port has run on one (each rank's exchange then a
device copy on that card).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class HwModel:
    """A card's envelope: HBM bandwidth, one-way bandwidth to the other
    cards and the latency of one dependent exchange phase."""
    name: str
    hbm_gbps: float          # HBM bandwidth, GB/s
    link_gbps: float         # one-way bandwidth to the other cards, GB/s
    link_latency_us: float   # per exchange phase


# NVIDIA H100 SXM5 80GB (what nvidia-smi names "NVIDIA H100 80GB
# HBM3"; power limit 700 W): HBM3 3.35 TB/s and fourth-generation
# NVLink at 900 GB/s per GPU in both directions together, so 450 GB/s
# each way (NVIDIA H100 Tensor Core GPU data sheet, "H100 SXM"
# column).  The data sheet gives no latency: 5 us per phase is an
# assumption (a copy's launch and its stream wait on the host), not a
# measured or published figure.
H100_SXM = HwModel("NVIDIA H100 80GB HBM3 (SXM5, 700 W)", hbm_gbps=3350.0,
                   link_gbps=450.0, link_latency_us=5.0)


@dataclass
class PathComm:
    """Per-step communication of one solver path at one rank count."""
    path: str
    n_dev: int
    bytes_out: int           # bytes sent per rank per step (max rank)
    phases: int              # dependent exchange phases (latency)
    detail: dict = field(default_factory=dict)


def slab_comm(st, dtype_bytes=4) -> PathComm:
    """Exchange volume of the uniform-brick z-slab path: two shifts of
    a [3, plane] force plane (slab.SlabStep and SlabKernelStep)."""
    return slab_comm_dims(st.nxp, st.nyp, st.n_dev, dtype_bytes)


def _allsum_sent(n, payload):
    """Bytes each of n ranks sends in one allsum of ``payload`` bytes
    (ranks.RankGroup.allsum): rank 0 the total to each other rank, each
    other rank its buffer to rank 0."""
    if n == 1:
        return [0]
    return [(n - 1) * payload] + [payload] * (n - 1)


def gslab_comm(st, dtype_bytes=4) -> PathComm:
    """Exchange volume of the graded stacked-slab path (gslab.GSlabStep):
    per brick two shifts of a [3, plane] force plane; per interface
    across ranks the [9, plane] triplet over and the [3, plane] plane
    back."""
    n = st.n_dev
    frag = sum(2 * 3 * fb.plane * dtype_bytes for fb in st.bricks)
    sent = [frag] * n
    phases = [2 * len(st.bricks)] * n
    for h, (df, _, dc, _) in zip(st.hang, st.hang_own):
        if df != dc:
            sent[dc] += 9 * h.nyc * h.nxc * dtype_bytes
            sent[df] += 3 * h.nyc * h.nxc * dtype_bytes
            phases[dc] += 2
            phases[df] += 2
    for s_, (da, _, db, _) in zip(st.same, st.same_own):
        if da != db:
            sent[db] += 9 * s_.ny * s_.nx * dtype_bytes
            sent[da] += 3 * s_.ny * s_.nx * dtype_bytes
            phases[db] += 2
            phases[da] += 2
    return PathComm("gslab", n, max(sent), phases=max(phases),
                    detail={"fragment_bytes": frag,
                            "interface_bytes": max(sent) - frag,
                            "n_bricks": len(st.bricks),
                            "n_interfaces": len(st.hang) + len(st.same)})


def gmesh_comm(st, dtype_bytes=4) -> PathComm:
    """Exchange volume of the general graded path (gmesh.GMeshStep): per
    brick two shifts of a [3, plane] force plane, and one allsum of the
    [K, 9] interface buffer."""
    n = st.n_dev
    frag = sum(2 * 3 * fb.plane * dtype_bytes for fb in st.bricks)
    payload = st.K * 9 * dtype_bytes
    allsum = max(_allsum_sent(n, payload)) if st.K else 0
    ph = 2 * len(st.bricks) + (2 if st.K and n > 1 else 0)
    return PathComm("gmesh", n, frag + allsum, phases=ph,
                    detail={"fragment_bytes": frag, "allsum_bytes": allsum,
                            "K": st.K, "n_bricks": len(st.bricks)})


def sharded_comm(st, dtype_bytes=4) -> PathComm:
    """Exchange volume of the unstructured sharded path: one allsum of
    the [B_pad, 3] boundary buffer (sharded.ShardedStep), reduced on
    rank 0 and sent back."""
    n = st.n_dev
    B_pad = int(st.b_lidx.shape[1])
    payload = B_pad * 3 * dtype_bytes
    return PathComm("sharded", n, max(_allsum_sent(n, payload)),
                    phases=2 if n > 1 else 0,
                    detail={"B_pad": B_pad, "payload": payload})


def predict(comm: PathComm, n_elem: int, eups_1chip: float,
            hw: HwModel = H100_SXM) -> dict:
    """A prediction of one path at one card count: t_compute from the
    measured one-card element rate (the kernels are bound by memory
    traffic, so the time scales with the local element count); t_comm
    = phases x latency + bytes / link rate.  The exchange feeds the
    update, so the serial sum is the step; the overlap column is the
    ceiling if a step hid the exchange behind compute."""
    t_compute = n_elem / comm.n_dev / eups_1chip
    t_comm = (comm.phases * hw.link_latency_us * 1e-6
              + comm.bytes_out / (hw.link_gbps * 1e9))
    t_serial = t_compute + t_comm
    return {
        "kind": "prediction",
        "hw": hw.name,
        "path": comm.path,
        "n_dev": comm.n_dev,
        "bytes_out_per_dev": comm.bytes_out,
        "phases": comm.phases,
        "t_compute_s": t_compute,
        "t_comm_s": t_comm,
        "t_step_s": t_serial,
        "t_step_overlap_s": max(t_compute, t_comm),
        "eups": n_elem / t_serial,
        "efficiency": t_compute / t_serial,
        "detail": comm.detail,
    }


def slab_comm_dims(nxp, nyp, n_dev, dtype_bytes=4) -> PathComm:
    """slab_comm from the node grid's dimensions (no tables needed), so
    a report can project rank counts beyond a built table."""
    plane = nyp * nxp
    return PathComm("slab", n_dev, 2 * 3 * plane * dtype_bytes,
                    phases=2, detail={"plane": plane})


def plan_scaling_report(plan, n_elem, eups_1chip,
                        device_counts=(1, 2, 4, 8), hw: HwModel = H100_SXM,
                        dtype_bytes=4) -> str:
    """Text table of a brick plan's predicted scaling (uniform or
    graded; hercules_tpu/parallel/comm_model.py:193-230): every brick is
    split over the ring along its outer storage axis (gslab.py,
    gmesh.py), so each rank's fragment halo is the sum of the bricks'
    two force planes, constant in the card count; the interface
    exchange is left out (gslab_comm and gmesh_comm count it once
    tables are built).  Rows past the smallest brick's outer element
    layers (the split's cap) are marked; every line says it is a
    prediction."""
    planes = [b.node_shape[1] * b.node_shape[2] for b in plan.bricks]
    nbytes = sum(2 * 3 * pl * dtype_bytes for pl in planes)
    phases = 2 * len(planes)
    cap = min(b.node_shape[0] - 1 for b in plan.bricks)
    lines = [
        f"# prediction, comm model: {hw.name} (link {hw.link_gbps:.0f} "
        f"GB/s one way, {hw.link_latency_us:.1f} us/phase assumed); "
        f"{len(planes)} brick(s), fragment halo {nbytes / 1e6:.2f} MB per "
        f"card and step ({phases} phases), {n_elem:.3e} elem, measured "
        f"{eups_1chip:.3e} eups on one card",
        "# ndev  t_comp(us)  t_comm(us)  t_step(us)   eups         eff",
    ]
    for n in device_counts:
        if n > cap:
            lines.append(f"# {n:5d}  -- exceeds the smallest brick's {cap} "
                         f"outer element layers (split cap)")
            continue
        c = (PathComm("gslab", 1, 0, 0) if n == 1
             else PathComm("gslab", n, nbytes, phases))
        r = predict(c, n_elem, eups_1chip, hw)
        lines.append(
            f"# {n:5d}  {r['t_compute_s'] * 1e6:10.1f}  "
            f"{r['t_comm_s'] * 1e6:10.1f}  {r['t_step_s'] * 1e6:10.1f}   "
            f"{r['eups']:.3e}  {r['efficiency'] * 100:5.1f}%")
    return "\n".join(lines)


def scaling_report(nxp, nyp, nzp, n_elem, eups_1chip,
                   device_counts=(1, 2, 4, 8), hw: HwModel = H100_SXM,
                   dtype_bytes=4) -> str:
    """Text table of the slab path's predicted scaling over a ring of
    cards; rows past nzp - 1 element layers (the split's cap) are
    marked.  Every line says it is a prediction."""
    lines = [
        f"# prediction, comm model: {hw.name} (link {hw.link_gbps:.0f} "
        f"GB/s one way, {hw.link_latency_us:.1f} us/phase assumed); "
        f"mesh {nxp - 1}x{nyp - 1}x{nzp - 1} elem = {n_elem:.3e}, "
        f"measured {eups_1chip:.3e} eups on one card",
        "# ndev  bytes/dev/step  t_comp(us)  t_comm(us)  t_step(us)"
        "   eups         eff",
    ]
    for n in device_counts:
        if n > nzp - 1:
            lines.append(f"# {n:5d}  -- exceeds {nzp - 1} z element "
                         f"layers (slab split cap)")
            continue
        c = (PathComm("slab", 1, 0, 0) if n == 1
             else slab_comm_dims(nxp, nyp, n, dtype_bytes))
        r = predict(c, n_elem, eups_1chip, hw)
        lines.append(
            f"# {n:5d}  {r['bytes_out_per_dev']:>14,}  "
            f"{r['t_compute_s'] * 1e6:10.1f}  {r['t_comm_s'] * 1e6:10.1f}  "
            f"{r['t_step_s'] * 1e6:10.1f}   {r['eups']:.3e}  "
            f"{r['efficiency'] * 100:5.1f}%")
    return "\n".join(lines)
