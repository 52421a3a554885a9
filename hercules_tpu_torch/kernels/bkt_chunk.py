"""K6: CH steps of the uniform-Q BKT step in one launch, with the
per-step station sampling and source injection fused in.

``bkt_chunk`` launches the persistent cooperative CUDA kernel of
``csrc/bkt_chunk.cu`` on CUDA tensors and runs ``bkt_chunk_plain`` on
CPU tensors.  It counts its kernel launches in ``bkt_chunk.launches``.

Per step t, in this order (as brick_chunk, K5): the station samples of
the state before the step (``samples[t]``), the step itself (K2's
tiled body), then the source increments ``srcf[t]`` added at
``src_pos`` (sources sharing a position are added one after another in
source order).  The increments are pre-scaled by the caller: f(t) dt^2
rounded to the working type, then times inv_mass at the source node.
On the card the thread that updates a source node adds them; the host
lists each tile's sources (``tiles.tile_sources``) once for each
``src_pos`` tensor and version (``source_lists``).
"""

from __future__ import annotations

import torch

from . import build
from .bkt_step import bkt_step_plain, check_args, rec_arg
from .brick_chunk import sample_stations
from .tiles import source_lists


def bkt_chunk_plain(S, conv, K, offs, scales, rec, srcf, src_pos, st_pos,
                    st_phi):
    """A loop of bkt_step_plain with the kernel's sampling and injection
    order.  Returns (S, conv after CH steps, samples [CH, ns, 3])."""
    samples = []
    for t in range(srcf.shape[0]):
        samples.append(sample_stations(S, st_pos, st_phi))
        S, conv = bkt_step_plain(S, conv, K, offs, scales, rec)
        if src_pos is not None:
            S[0:3].index_add_(1, src_pos, srcf[t])
    ns = 0 if st_pos is None else st_pos.shape[0]
    out = torch.stack(samples) if samples else S.new_zeros((0, ns, 3))
    return S, conv, out


def _ptr(t):
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _prepare(S, spare, conv, conv_spare, K, offs, scales, rec, srcf,
             src_pos, st_pos, st_phi):
    """Raise unless the arguments are what the kernel takes; returns (C
    entry, LEN, offsets, kernel scalars, kappa flag, CH, L, ns, device).
    It reads no tensor's values: the cache keeps it by signature."""
    sfx = check_args("bkt_chunk", S, conv, K, offs, scales, rec, spare,
                     conv_spare)
    CH = srcf.shape[0]
    L = 0 if src_pos is None else src_pos.shape[0]
    ns = 0 if st_pos is None else st_pos.shape[0]
    if L > 128 or ns > 128:
        raise ValueError(f"bkt_chunk: {L} sources and {ns} stations "
                         f"(at most 128 each)")
    if tuple(srcf.shape) != (CH, 3, L) or srcf.dtype != S.dtype \
            or srcf.device != S.device or not srcf.is_contiguous():
        raise ValueError(f"bkt_chunk: srcf must be a contiguous "
                         f"{(CH, 3, L)} {S.dtype} tensor on {S.device}")
    if L and src_pos.device != S.device:
        raise ValueError("bkt_chunk: src_pos must be on the state's device")
    if ns and (tuple(st_pos.shape) != (ns, 8)
               or tuple(st_phi.shape) != (ns, 8)
               or st_phi.dtype != S.dtype
               or st_pos.device != S.device
               or st_phi.device != S.device):
        raise ValueError("bkt_chunk: st_pos/st_phi must be [ns, 8] on "
                         "the state's device")
    return (build.entry(f"ht_bkt_chunk_{sfx}"), S.shape[1],
            build.offsets_arg(offs), rec_arg(rec, scales, S.dtype),
            int(conv.shape[0] == 12), CH, L, ns, S.device.index)


_CHECKS = build.CheckCache(_prepare)

def bkt_chunk(S, spare, conv, conv_spare, K, offs, scales, rec, srcf,
              src_pos=None, st_pos=None, st_phi=None):
    """CH = srcf.shape[0] steps from (S, conv), with the operator's
    scales and recursion scalars as bkt_step takes them.  srcf
    [CH, 3, L] holds the pre-scaled source increments for the L
    positions src_pos [L] (int64); st_pos [ns, 8] (int64) and st_phi
    [ns, 8] place the stations.  On CUDA, (S, spare) and (conv,
    conv_spare) are the kernel's ping-pong buffers and all four are
    overwritten.

    Returns (the tensors holding the final S and conv, samples
    [CH, ns, 3])."""
    if S.device.type == "cpu":
        return bkt_chunk_plain(S, conv, K, offs, scales, rec, srcf,
                               src_pos, st_pos, st_phi)
    fn, LEN, offs_arg, rec_c, kappa, CH, L, ns, dev = _CHECKS(
        S, spare, conv, conv_spare, K, offs, tuple(scales), tuple(rec),
        srcf, src_pos, st_pos, st_phi)
    pos32, tile_ptr, tile_src = source_lists(src_pos, offs, LEN, S.device)
    samples = S.new_empty((CH, ns, 3))
    if CH == 0:
        return S, conv, samples
    st32 = None if not ns else st_pos.to(torch.int32).contiguous()
    phi = None if not ns else st_phi.contiguous()
    rc = fn(S.data_ptr(), spare.data_ptr(), conv.data_ptr(),
            conv_spare.data_ptr(), K.data_ptr(), LEN, offs_arg, rec_c, kappa,
            CH, _ptr(srcf), _ptr(pos32), L, tile_ptr.data_ptr(),
            _ptr(tile_src), _ptr(st32), _ptr(phi), ns,
            _ptr(samples), dev, build.stream(S))
    build.check(rc, "bkt_chunk launch")
    bkt_chunk.launches += 1
    if CH % 2:
        return spare, conv_spare, samples
    return S, conv, samples


bkt_chunk.launches = 0
