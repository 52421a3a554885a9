"""K5: CH steps of the uniform-brick elastic step in one launch, with
the per-step station sampling and source injection fused in.

``brick_chunk`` launches the persistent cooperative CUDA kernel of
``csrc/brick_chunk.cu`` on CUDA tensors and runs ``brick_chunk_plain``
on CPU tensors.  It counts its kernel launches in
``brick_chunk.launches``.

Per step t, in this order: the station samples of the state before
the step (``samples[t]``), the step itself (K1's tiled body), then the
source increments ``srcf[t]`` added at ``src_pos`` (sources sharing a
position are added one after another in source order).  The
increments are pre-scaled by the caller: f(t) dt^2 rounded to the
working type, then times inv_mass at the source node.  On the card the
thread that updates a source node adds them; the host lists each
tile's sources once for each ``src_pos`` tensor and version
(``tiles.source_lists``).
"""

from __future__ import annotations

import torch

from . import build
from .brick_step import brick_step_plain, check_args
from .tiles import source_lists


def sample_stations(S, st_pos, st_phi):
    """[ns, 3] phi-weighted displacement at the stations' 8 nodes."""
    if st_pos is None:
        return S.new_zeros((0, 3))
    return torch.einsum("sn,csn->sc", st_phi, S[0:3][:, st_pos])


def brick_chunk_plain(S, K, offs, ops, srcf, src_pos, st_pos, st_phi):
    """A loop of brick_step_plain with the same sampling and injection
    order as the kernel.  Returns (S after CH steps, samples
    [CH, ns, 3])."""
    samples = []
    for t in range(srcf.shape[0]):
        samples.append(sample_stations(S, st_pos, st_phi))
        S = brick_step_plain(S, K, offs, ops)
        if src_pos is not None:
            S[0:3].index_add_(1, src_pos, srcf[t])
    ns = 0 if st_pos is None else st_pos.shape[0]
    out = (torch.stack(samples) if samples
           else S.new_zeros((0, ns, 3)))
    return S, out


def _ptr(t):
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _prepare(S, spare, K, offs, srcf, src_pos, st_pos, st_phi):
    """Raise unless the arguments are what the kernel takes; returns (C
    entry, LEN, offsets, CH, L, ns, device).  It reads no tensor's
    values: the cache keeps it by signature."""
    check_args("brick_chunk", S, K, offs, spare)
    CH = srcf.shape[0]
    L = 0 if src_pos is None else src_pos.shape[0]
    ns = 0 if st_pos is None else st_pos.shape[0]
    if L > 128 or ns > 128:
        raise ValueError(f"brick_chunk: {L} sources and {ns} stations "
                         f"(at most 128 each)")
    if tuple(srcf.shape) != (CH, 3, L) or srcf.dtype != S.dtype \
            or srcf.device != S.device or not srcf.is_contiguous():
        raise ValueError(f"brick_chunk: srcf must be a contiguous "
                         f"{(CH, 3, L)} {S.dtype} tensor on {S.device}")
    if L and src_pos.device != S.device:
        raise ValueError("brick_chunk: src_pos must be on the state's "
                         "device")
    if ns and (tuple(st_pos.shape) != (ns, 8)
               or tuple(st_phi.shape) != (ns, 8)
               or st_phi.dtype != S.dtype
               or st_pos.device != S.device
               or st_phi.device != S.device):
        raise ValueError("brick_chunk: st_pos/st_phi must be [ns, 8] on "
                         "the state's device")
    sfx = "f32" if S.dtype == torch.float32 else "f64"
    return (build.entry(f"ht_brick_chunk_{sfx}"), S.shape[1],
            build.offsets_arg(offs), CH, L, ns, S.device.index)


_CHECKS = build.CheckCache(_prepare)


def brick_chunk(S, spare, K, offs, ops, srcf, src_pos=None, st_pos=None,
                st_phi=None):
    """CH = srcf.shape[0] steps from S.  srcf [CH, 3, L] holds the
    pre-scaled source increments for the L positions src_pos [L]
    (int64); st_pos [ns, 8] (int64) and st_phi [ns, 8] place the
    stations.  ``ops`` is the plain version's operator (CPU tensors
    only).  On CUDA, S and ``spare`` (same shape) are the kernel's
    ping-pong buffers and both are overwritten.

    Returns (the tensor holding the final state, samples [CH, ns, 3])."""
    if S.device.type == "cpu":
        return brick_chunk_plain(S, K, offs, ops, srcf, src_pos, st_pos,
                                 st_phi)
    offs = tuple(offs)
    fn, LEN, offs_arg, CH, L, ns, dev = _CHECKS(
        S, spare, K, offs, srcf, src_pos, st_pos, st_phi)
    pos32, tile_ptr, tile_src = source_lists(src_pos, offs, LEN, S.device)
    samples = S.new_empty((CH, ns, 3))
    if CH == 0:
        return S, samples
    # the kernel indexes with 32-bit ints
    st32 = None if not ns else st_pos.to(torch.int32).contiguous()
    phi = None if not ns else st_phi.contiguous()
    rc = fn(S.data_ptr(), spare.data_ptr(), K.data_ptr(), LEN, offs_arg, CH,
            _ptr(srcf), _ptr(pos32), L, tile_ptr.data_ptr(), _ptr(tile_src),
            _ptr(st32), _ptr(phi), ns, _ptr(samples), dev, build.stream(S))
    build.check(rc, "brick_chunk launch")
    brick_chunk.launches += 1
    return (S if CH % 2 == 0 else spare), samples


brick_chunk.launches = 0
