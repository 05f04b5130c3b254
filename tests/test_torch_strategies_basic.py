"""The cases of ``tests/test_strategies_basic.py``, read on ``repro_torch``
with the same inputs and settings. The reference's docstring follows.

Strategy builders — deterministic tests (no hypothesis dependency, so
they run even when the property-test extras are not installed).
"""
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.strategies import (GroupedStrategy, best_heuristic,
                                         k_min, row_by_row, tiled, zigzag)
from _torch_port import fast_polish_port  # noqa: F401

BIG_HW = HardwareModel(nbop_pe=10**9)


def test_zigzag_equals_row_when_group_is_multiple_of_wout():
    """Paper Sec 7.2: 'for group sizes that are a multiple of W_out the
    ZigZag and Row-by-Row strategies are identical' (in duration)."""
    spec = ConvSpec(1, 10, 10, 1, 3, 3)        # W_out = 8
    for mult in (1, 2):
        p = spec.w_out * mult
        assert zigzag(spec, p).objective(BIG_HW) == \
            row_by_row(spec, p).objective(BIG_HW)


def test_zigzag_beats_row_for_small_groups():
    """Paper Sec 7.2: for small group sizes ZigZag outperforms Row-by-Row."""
    spec = ConvSpec(1, 12, 12, 1, 3, 3)
    assert zigzag(spec, 2).objective(BIG_HW) < \
        row_by_row(spec, 2).objective(BIG_HW)


def test_best_heuristic_matches_min():
    spec = ConvSpec(1, 8, 8, 1, 3, 3)
    b = best_heuristic(spec, 3, BIG_HW)
    assert b.objective(BIG_HW) == min(
        zigzag(spec, 3).objective(BIG_HW),
        row_by_row(spec, 3).objective(BIG_HW))


def test_k_min_definition():
    spec = ConvSpec(1, 12, 12, 1, 3, 3)        # |X| = 100
    assert k_min(spec, 4) == 25
    assert k_min(spec, 3) == 34


def test_tiled_beats_rbr_and_zigzag_on_square_budget():
    """Beyond-paper: 2-D tiles minimise halo perimeter, so with p=4 a 2x2
    tile should beat both 1-D heuristics on a large enough input."""
    spec = ConvSpec(1, 12, 12, 1, 3, 3)
    t = tiled(spec, 4).objective(BIG_HW)
    assert t <= zigzag(spec, 4).objective(BIG_HW)
    assert t <= row_by_row(spec, 4).objective(BIG_HW)


def test_duplicate_patch_rejected():
    spec = ConvSpec(1, 4, 4, 1, 3, 3)
    try:
        GroupedStrategy("bad", spec, ((0, 1), (1, 2), (3,)))
    except ValueError:
        return
    raise AssertionError("duplicate patch not rejected")


def test_full_duration_decomposition():
    """full_duration = eq. 15 objective + kernel load + write-back — the
    network planner's per-layer accounting (validated against the Sec-6
    simulator in test_network_planner.py)."""
    spec = ConvSpec(2, 8, 8, 3, 3, 3)
    strat = zigzag(spec, 4)
    hw = HardwareModel(nbop_pe=10**9, t_l=2.0, t_w=3.0, t_acc=5.0)
    assert strat.full_duration(hw) == (
        strat.objective(hw)
        + spec.kernel_elements * hw.t_l
        + spec.num_patches * hw.t_w)
    assert strat.peak_footprint_elements() >= (
        spec.kernel_elements + strat.peak_input_footprint() * spec.c_in)
