"""The launch path every kernel wrapper shares (kernels/build.py): the
argument checks kept per call signature, and the memory-overlap test
the wrappers refuse aliased outputs with.  CPU only: the cache holds
whatever a wrapper's check returns, for any tensors."""

import pytest
import torch

from hercules_tpu_torch.kernels import bkt_node_step, build, stream_add


def counting_cache(refuse=lambda *a: False):
    """A CheckCache whose check counts its calls and raises where
    ``refuse`` says so."""
    calls = []

    def check(*args):
        calls.append(args)
        if refuse(*args):
            raise ValueError("refused")
        return ("entry", len(calls))

    return build.CheckCache(check), calls


def test_repeat_call_runs_checks_once():
    cache, calls = counting_cache()
    a, b = torch.zeros(8, 16), torch.ones(8, 16)
    first = cache(a, b, 3)
    assert cache(a, b, 3) == first and len(calls) == 1
    # another tensor object over the same memory and layout is the same
    # signature
    assert cache(a.view(8, 16), b, 3) == first and len(calls) == 1


@pytest.mark.parametrize("change", ["shape", "stride", "dtype", "pointer",
                                    "scalar"])
def test_signature_changes_miss(change):
    """Each of shape, strides, dtype, data pointer and a non-tensor
    argument is part of the key: changing one runs the checks again."""
    cache, calls = counting_cache()
    a = torch.zeros(8, 16)
    cache(a, 3)
    other = {"shape": (a.view(16, 8), 3),
             "stride": (torch.zeros(16, 8).t(), 3),
             "dtype": (a.view(torch.int32), 3),
             "pointer": (torch.zeros(8, 16), 3),
             "scalar": (a, 4)}[change]
    assert build.signature(other) != build.signature((a, 3))
    cache(*other)
    assert len(calls) == 2


def test_refused_signature_is_never_kept():
    """A call the checks refuse raises every time and keeps nothing, so
    a later call with the same arguments is checked (and refused)
    again."""
    cache, calls = counting_cache(refuse=lambda t: t.shape[0] != 8)
    bad = torch.zeros(4, 16)
    for n in (1, 2):
        with pytest.raises(ValueError, match="refused"):
            cache(bad)
        assert len(calls) == n
    assert not cache.kept
    good = torch.zeros(8, 16)
    cache(good)
    cache(good)
    assert len(calls) == 3 and len(cache.kept) == 1


def test_cache_drops_oldest_beyond_size():
    cache, calls = counting_cache()
    cache.size = 2
    ts = [torch.zeros(8, 4) for _ in range(3)]
    for t in ts:
        cache(t)
    assert len(cache.kept) == 2
    cache(ts[0])                        # dropped: checked again
    assert len(calls) == 4


def test_wrapper_checks_refuse_cpu_tensors_and_keep_nothing():
    """The wrappers' own checks raise for a tensor that is not on a CUDA
    device; their caches keep nothing of the refused call."""
    a = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        stream_add._CHECKS(a, a, torch.empty_like(a), 0)
    assert not stream_add._CHECKS.kept
    S = torch.zeros(8, 64, dtype=torch.float64)
    conv = torch.zeros(6, 64, dtype=torch.float64)
    offs = (0, 1, 4, 5, 16, 17, 20, 21)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        bkt_node_step._CHECKS(S, conv, S, offs, S, S, conv, None, None,
                              None, None)
    assert not bkt_node_step._CHECKS.kept


def test_overlap():
    base = torch.zeros(64)
    assert build.overlap(base[:32], base[16:48])
    assert not build.overlap(base[:32], base[32:])
    assert build.overlap(base, base)
    assert not build.overlap(base[:0], base)
    assert not build.overlap(base, torch.zeros(64))
    # strided views: the span runs from the first to the last element
    assert build.overlap(base[0::2], base[1::2])


def test_brick_strides():
    """K3 reads the node grid as planes of tiles: the strides come from
    the corner offsets in any axis order; offsets that are not a brick's
    are refused."""
    offs = (0, 1, 4, 5, 16, 17, 20, 21)
    assert bkt_node_step.brick_strides(offs) == (4, 16)
    # the same grid with x the plane axis
    swapped = (0, 16, 1, 17, 4, 20, 5, 21)
    assert bkt_node_step.brick_strides(swapped) == (4, 16)
    for bad in ((0, 1, 4, 5, 16, 17, 20, 22), (0, 2, 4, 6, 16, 18, 20, 22),
                (0, 1, 4, 5, 6, 7, 10, 11)):
        with pytest.raises(ValueError, match="brick's node grid"):
            bkt_node_step.brick_strides(bad)


def test_signature_is_flat():
    """One flat tuple: a tensor's five fields in its place, every other
    argument as it is; a tensor and None in one place give keys of
    different lengths."""
    a, b = torch.zeros(8, 16), torch.ones(8, 16)
    key = build.signature((a, None, b, 3))
    assert key == (a.data_ptr(), a.shape, a.stride(), a.dtype, a.device,
                   None,
                   b.data_ptr(), b.shape, b.stride(), b.dtype, b.device, 3)
    assert len(build.signature((a, b, None, 3))) == len(key)
    assert build.signature((a, b, None, 3)) != key
    assert len(build.signature((a, b, b, 3))) != len(key)
