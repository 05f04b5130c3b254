"""The cases of ``tests/test_row_window_edges.py``, read on ``repro_torch``
with the same inputs and settings. The reference's docstring follows.

Row-window cascading edge cases: strided
consumers, 1-row windows (1x1 kernels), windows taller than the producer
activation, and the InfeasibleNetworkError message-content regression.
"""
import pytest

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.network_planner import (InfeasibleNetworkError,
                                              greedy_network_duration,
                                              plan_network, row_window_rows)
from repro_torch.core.strategies import best_heuristic
from _torch_port import fast_polish_port  # noqa: F401

HW = HardwareModel(nbop_pe=10 ** 9, size_mem=None)
FAST = dict(polish_iters=600, polish_restarts=1)


def _budget_for_rows(prev_s, nxt_s, nxt, rows):
    """size_mem that leaves exactly ``rows`` input rows of spare next to
    both layers' peaks (the row_window_rows fit condition)."""
    base = max(prev_s.peak_footprint_elements(),
               nxt_s.peak_footprint_elements())
    return base + rows * nxt.w_in * nxt.c_in


def test_window_rows_with_strided_consumer():
    """A stride-2 consumer still gets a halo-extended window: at least
    h_k input rows, never more than its input height."""
    prev = ConvSpec(2, 12, 12, 4, 3, 3)
    nxt = ConvSpec(4, 10, 10, 4, 3, 3, s_h=2, s_w=2)
    prev_s = best_heuristic(prev, 4, HW)
    nxt_s = best_heuristic(nxt, 4, HW)
    # spare for 5 rows: admissible (>= h_k = 3)
    hw = HardwareModel(nbop_pe=10 ** 9,
                       size_mem=_budget_for_rows(prev_s, nxt_s, nxt, 5))
    rows = row_window_rows(prev, prev_s, nxt, nxt_s, hw)
    assert nxt.h_k <= rows <= nxt.h_in
    assert rows == 5
    # spare for h_k - 1 rows only: no admissible window
    hw2 = HardwareModel(
        nbop_pe=10 ** 9,
        size_mem=_budget_for_rows(prev_s, nxt_s, nxt, nxt.h_k - 1))
    assert row_window_rows(prev, prev_s, nxt, nxt_s, hw2) == 0
    # the planner keeps every saving clamped on the strided pair
    plan = plan_network((prev, nxt), hw, **FAST)
    for lp in plan.layers:
        assert lp.duration >= 0
        assert lp.input_load_saved <= \
            lp.strategy.first_load_duration(hw) + 1e-9


def test_one_row_window_with_1x1_kernel():
    """h_k = 1 (1x1 conv): a single resident row is already a legal
    halo-extended window."""
    prev = ConvSpec(2, 8, 8, 4, 1, 1)
    nxt = ConvSpec(4, 8, 8, 8, 1, 1)
    prev_s = best_heuristic(prev, 4, HW)
    nxt_s = best_heuristic(nxt, 4, HW)
    hw = HardwareModel(nbop_pe=10 ** 9,
                       size_mem=_budget_for_rows(prev_s, nxt_s, nxt, 1))
    assert row_window_rows(prev, prev_s, nxt, nxt_s, hw) == 1
    # one fewer element: nothing fits
    hw2 = HardwareModel(nbop_pe=10 ** 9, size_mem=hw.size_mem - 1)
    assert row_window_rows(prev, prev_s, nxt, nxt_s, hw2) == 0


def test_window_clamped_to_consumer_input_height():
    """A consumer whose input is taller than the producer's activation
    (pooling/padding mismatch): the window never claims more rows than
    the consumer's input has, and savings stay clamped in a plan."""
    prev = ConvSpec(1, 8, 8, 2, 3, 3)       # 6x6 output
    nxt = ConvSpec(2, 12, 12, 2, 3, 3)      # 12-row input
    prev_s = best_heuristic(prev, 4, HW)
    nxt_s = best_heuristic(nxt, 4, HW)
    hw = HardwareModel(nbop_pe=10 ** 9,
                       size_mem=_budget_for_rows(prev_s, nxt_s, nxt, 1000))
    rows = row_window_rows(prev, prev_s, nxt, nxt_s, hw)
    assert rows == nxt.h_in                  # clamped, not 1000
    plan = plan_network((prev, nxt), hw, **FAST)
    for lp in plan.layers:
        assert lp.duration >= 0
        assert lp.input_load_saved <= \
            lp.strategy.first_load_duration(hw) + 1e-9


def test_infeasible_error_message_names_layer_and_budget():
    """Regression: the error must carry enough context to act on — the
    failing layer's index/shape and the budget that rejected it."""
    net = (ConvSpec(1, 10, 10, 2, 3, 3), ConvSpec(2, 8, 8, 4, 3, 3))
    hw = HardwareModel(nbop_pe=10 ** 9, size_mem=4)
    with pytest.raises(InfeasibleNetworkError,
                       match=r"layer 0 \(1x10x10->2\).*size_mem=4"):
        plan_network(net, hw, **FAST)
    with pytest.raises(InfeasibleNetworkError, match=r"size_mem=4"):
        greedy_network_duration(net, hw)
