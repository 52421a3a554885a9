"""The check fails what it must: the control (the reference in bfloat16
in the program's place) and runs whose timed path is broken underneath
(the program's chunked loop wrapped, or on several ranks the exchange
between them), at sizes a CPU test holds."""

import numpy as np
import pytest
import torch

from port_bench import check

CASES = [("b1_1hz", 0.125), ("loh1_4hz", 1.0)]
F64 = [("b1_1hz_f64", 0.125)]
# the four-card cell on four CPU ranks (the program's plain slab path)
MC = [("b1_2hz_x4", 0.125)]


def _tree(x, f):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(v, f) for v in x)
    return f(x) if isinstance(x, torch.Tensor) else x


def _breaking(fault):
    """A breaker: the route function with its loop's ``advance`` broken
    by ``fault(state_in, state_out, samples) -> (state, samples)``."""
    from hercules_tpu_torch.parallel import driver
    from hercules_tpu_torch.solver import fused_brick, fused_mesh

    def wrap(fn):
        def broken(*a, **kw):
            real = {m: m.run_chunked for m in (fused_brick, fused_mesh,
                                               driver)}

            def run_chunked(advance, state, *ra, **rk):
                def adv(st, s, k):
                    before = _tree(st, lambda t: t.clone())
                    out, ys = advance(st, s, k)
                    return fault(before, out, ys)
                return real[fused_brick](adv, state, *ra, **rk)

            for m in real:
                m.run_chunked = run_chunked
            try:
                return fn(*a, **kw)
            finally:
                for m, f in real.items():
                    m.run_chunked = f
        return broken
    return wrap


def unchanged(before, out, ys):
    """The step returns its state unchanged."""
    return before, ys


def half_left_out(before, out, ys):
    """Half of the field is left out of the update."""
    def keep_half(a, b):
        n = a.shape[-1] // 2
        b = b.clone()
        b[..., n:] = a[..., n:]
        return b
    flat_b, flat_o = [], []
    _tree(before, flat_b.append)
    _tree(out, flat_o.append)
    it = iter([keep_half(a, b) for a, b in zip(flat_b, flat_o)])
    return _tree(out, lambda t: next(it)), ys


def answer_altered(before, out, ys):
    """A receiver's sample altered where it is produced."""
    ys = np.array(ys)
    ys[len(ys) // 2, 0, 0] += 0.01 * np.abs(ys).max()
    return out, ys


def exchange_left_out(fn):
    """A breaker: the exchange between ranks left out, each rank
    receiving zeros in place of its neighbour's plane."""
    from hercules_tpu_torch.parallel import ranks

    def broken(*a, **kw):
        real = ranks.RankGroup.shift

        def shift(self, xs, d):
            return [None if x is None else torch.zeros_like(x)
                    for x in real(self, xs, d)]

        ranks.RankGroup.shift = shift
        try:
            return fn(*a, **kw)
        finally:
            ranks.RankGroup.shift = real
    return broken


@pytest.mark.parametrize("name,fmax", CASES + MC)
@pytest.mark.parametrize("fault", [unchanged, half_left_out,
                                   answer_altered],
                         ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(tiny, name, fmax, fault):
    result, lines = tiny(name, fmax, 2 ** 31 + 11, breaker=_breaking(fault))
    assert not result["correct"], lines
    assert result["failed"] >= 1


@pytest.mark.parametrize("name,fmax", MC)
def test_a_path_without_its_exchange_is_not_correct(tiny, name, fmax):
    result, lines = tiny(name, fmax, 2 ** 31 + 15, breaker=exchange_left_out)
    assert result["route"].startswith("mc:")
    assert not result["correct"], lines
    assert result["failed"] >= 1


@pytest.mark.parametrize("name,fmax", CASES)
def test_the_control_is_not_correct(tiny, name, fmax):
    from port_bench import cell as C
    limits = C.load_json(f"{C.HERE}/limits/b1_1hz.stations.json")
    result, lines = tiny(name, fmax, 2 ** 31 + 12, control=torch.bfloat16)
    assert result["correct"], lines
    ok, _ = check.judge(result["control"], limits)
    assert not ok, result["control"]


@pytest.mark.parametrize("name,fmax", MC)
def test_the_control_of_a_multi_card_cell_is_not_correct(tiny, name, fmax):
    from port_bench import cell as C
    limits = C.load_json(f"{C.HERE}/limits/{name}.stations.json")
    result, lines = tiny(name, fmax, 2 ** 31 + 16, control=torch.bfloat16)
    assert result["correct"] and result["route"].startswith("mc:"), lines
    ok, _ = check.judge(result["control"], limits)
    assert not ok, result["control"]


@pytest.mark.parametrize("name,fmax", F64)
def test_the_float32_control_of_float64_is_not_correct(tiny, name, fmax):
    from port_bench import cell as C
    limits = C.load_json(f"{C.HERE}/limits/b1_1hz_f64.stations.json")
    result, lines = tiny(name, fmax, 2 ** 31 + 13, control=torch.float32)
    assert result["correct"], lines
    ok, _ = check.judge(result["control"], limits)
    assert not ok, result["control"]


@pytest.mark.parametrize("name,fmax", F64)
@pytest.mark.parametrize("fault", [unchanged, half_left_out,
                                   answer_altered],
                         ids=lambda f: f.__name__)
def test_a_broken_float64_path_is_not_correct(tiny, name, fmax, fault):
    result, lines = tiny(name, fmax, 2 ** 31 + 14, breaker=_breaking(fault))
    assert not result["correct"], lines
