"""The cases of ``tests/test_s2_sim.py``, read on ``repro_torch`` with the
same inputs and settings. The reference's docstring follows.

sim.s2 against strategies_s2 model outputs:
functional correctness and exact Def-3 duration reconciliation for both
schedule orders, and for ``best_s2`` search results under memory caps.
"""
import pytest

from repro_torch.core import strategies_s2 as s2
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.sim import ConvLayer
from repro_torch.sim.s2 import run_s2
from _torch_port import fast_polish_port  # noqa: F401

BIG = HardwareModel(nbop_pe=10 ** 9, size_mem=None)
SPEC = ConvSpec(c_in=2, h_in=7, w_in=7, n_kernels=6, h_k=3, w_k=3)


@pytest.mark.parametrize("builder", [s2.kernel_major, s2.patch_major])
@pytest.mark.parametrize("p,kg", [(1, 1), (3, 2), (4, 3), (25, 6)])
def test_s2_sim_reconciles_model_exactly(builder, p, kg):
    """Simulator-measured Def-3 duration == strategy.full_duration, for
    both the weight-stationary and input-stationary orders."""
    strat = builder(SPEC, p, kg)
    rep = run_s2(ConvLayer.random(SPEC, seed=1), BIG, strat)
    assert rep.correct, rep.max_abs_err
    assert rep.total_duration == pytest.approx(strat.full_duration(BIG),
                                               abs=1e-9)
    assert rep.peak_memory <= strat.peak_footprint_elements()
    assert rep.elements_written == SPEC.num_patches * SPEC.c_out
    assert rep.total_macs == SPEC.macs_total


def test_s2_protocol_write_back_and_first_load():
    """Protocol terms decompose full_duration and bound reuse savings."""
    strat = s2.patch_major(SPEC, 4, 2)
    assert strat.full_duration(BIG) == pytest.approx(
        strat.objective(BIG) + strat.write_back_duration(BIG))
    assert strat.write_back_duration(BIG) == \
        SPEC.num_patches * SPEC.c_out * BIG.t_w
    assert strat.first_load_duration(BIG) == \
        SPEC.all_pixels_mask.bit_count() * BIG.t_l
    assert strat.peak_working_set_elements() <= \
        strat.peak_footprint_elements()


def test_best_s2_results_run_and_reconcile_under_budgets():
    """The searched strategy executes functionally under every cap it was
    selected for, within the budget, at the advertised duration."""
    spec = ConvSpec(2, 6, 6, 8, 3, 3)
    layer = ConvLayer.random(spec)
    for frac in (0.5, 1.0, 2.0):
        budget = int(spec.kernel_elements * frac)
        hw = HardwareModel(nbop_pe=10 ** 9, size_mem=budget)
        res = s2.best_s2(spec, hw)
        rep = run_s2(layer, hw, res.strategy)
        assert rep.correct, (frac, rep.max_abs_err)
        assert rep.peak_memory <= budget
        assert rep.total_duration == pytest.approx(
            res.strategy.full_duration(hw))
        assert res.objective == pytest.approx(res.strategy.objective(hw))
        assert res.peak_memory == res.strategy.peak_footprint_elements()


def test_s2_lower_bound_is_a_lower_bound():
    for builder in (s2.kernel_major, s2.patch_major):
        for kg in (1, 2, 3, 6):
            strat = builder(SPEC, 4, kg)
            assert strat.objective(BIG) >= s2.s2_lower_bound(SPEC, BIG)
