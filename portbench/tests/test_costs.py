"""The cost functions against PERF.md section 6's byte bounds, at its shapes."""

import pytest

from portbench.costs import apply_updates, exchange, fused_stream
from portbench.lib.readers import bound_s


@pytest.mark.parametrize("cost,bound_ms", [
    (apply_updates.at(1024), 0.0270),  # [1024, 1024], union, masks, refute
    (fused_stream.at(1024, 1024), 0.0125),  # B = N = 1024, RW = 9
    (exchange.at(1_000_000, 16), 0.0776),  # N = 1M, W = 16
])
def test_bound_matches_perf_md(cost, bound_ms):
    nbytes, ops = cost
    assert bound_s(cost) * 1e3 == pytest.approx(bound_ms, abs=5e-5)
    # the bytes bound every one of them
    assert nbytes / 3.35e12 > ops / 67e12


def test_a_batched_launch_costs_b_clusters():
    one, thirty_two = apply_updates.at(1024, b=1), apply_updates.at(1024, b=32)
    assert thirty_two[0] == pytest.approx(32 * one[0], rel=1e-9)
    assert exchange.at(1000, 16, b=4)[0] > 3.9 * exchange.at(1000, 16, b=1)[0]


def test_absent_operands_cost_nothing():
    full = apply_updates.at(1024)
    bare = apply_updates.at(1024, union=False, masks=False, refute=False)
    assert full[0] - bare[0] == 2 * 4 * 1024 * 32 + 1024 * 1024 + 1024
