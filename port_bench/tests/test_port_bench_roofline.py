"""The benchmark's roofline count against hand counts at 2^20."""

import pytest

from port_bench import roofline as R
from port_bench.reference import fem


def test_brick_of_2_20_by_hand():
    # a 128 x 128 x 64 brick of float32: 2^20 elements, 129^2 65 nodes
    E, N = 128 * 128 * 64, 129 * 129 * 65
    assert E == 2 ** 20
    # one step: 13 words a node (u, u-, damped mass, inverse mass in, u+
    # out) and 2 an element (mu, lambda); a chunk writes u and u- out
    assert R.call_bytes(E, N, 1, "float32") == \
        4 * (13 * 1081665 + 2 * 1048576)
    assert R.call_bytes(E, N, 1000, "float64") == \
        8 * (16 * 1081665 + 2 * 1048576)
    assert R.call_flop(E, N, 1) == 330 * 1048576 + 15 * 1081665
    one = R.least_seconds(E, N, 1, "float32")
    assert one == pytest.approx(4 * (13 * 1081665 + 2 * 1048576) / 3.35e12)
    chunk = R.least_seconds(E, N, 1000, "float32")
    assert chunk == pytest.approx(1000 * (330 * 1048576 + 15 * 1081665)
                                  / 67e12)
    assert R.least_step_seconds([(E, N)], 1000, "float32") == \
        pytest.approx(chunk / 1000)
    f64 = R.least_seconds(E, N, 1000, "float64")
    assert f64 == pytest.approx(chunk * 67 / 34)
    # the floor of any route is the operations of a step alone
    assert R.floor_step_seconds([(E, N)], "float32") == \
        pytest.approx((330 * 1048576 + 15 * 1081665) / 67e12)
    assert R.floor_step_seconds([(E, N)], "float32") <= \
        R.least_step_seconds([(E, N)], 1000, "float32") < one


def test_bricks_of_the_cells():
    b1 = fem.element_rows(__import__("json").load(open(
        f"{fem.__file__.rsplit('/', 2)[0]}/configs/b1_1hz.json")))
    assert R.bricks(b1, (30000.0, 30000.0, 30000.0)) == \
        [(128 ** 3, 129 ** 3)]
    loh = fem.element_rows(__import__("json").load(open(
        f"{fem.__file__.rsplit('/', 2)[0]}/configs/loh1_4hz.json")))
    got = R.bricks(loh, (12000.0, 12000.0, 6000.0))
    assert got == [(256 * 256 * 20, 257 * 257 * 21),
                   (128 * 128 * 54, 129 * 129 * 55)]
    assert sum(e for e, _ in got) == 2195456
