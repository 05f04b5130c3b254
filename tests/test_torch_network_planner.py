"""The cases of ``tests/test_network_planner.py``, read on ``repro_torch``
with the same inputs and settings. The reference's docstring follows.

Network-level planner: determinism, solve-cache reuse, dominance over
the per-layer-greedy baseline, inter-layer reuse gating, exact agreement
of the duration model with the Sec-6 simulator, and memory feasibility —
the S2 kernel-swapping fallback plus row-window cascading.
"""
import pytest

from repro_torch.configs import lenet5, resnet8, tight
from repro_torch.core import solver
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.network_planner import (InfeasibleNetworkError,
                                              activation_fits,
                                              greedy_network_duration,
                                              plan_network, resolve_group_size,
                                              row_window_rows)
from repro_torch.core.strategies import best_heuristic
from repro_torch.sim import simulate_network
from _torch_port import fast_polish_port  # noqa: F401

HW = HardwareModel(nbop_pe=10 ** 9, size_mem=None)

SMALL_NET = (ConvSpec(1, 10, 10, 2, 3, 3),
             ConvSpec(2, 8, 8, 4, 3, 3),
             ConvSpec(2, 8, 8, 4, 3, 3))     # repeated layer for the cache

FAST = dict(polish_iters=800, polish_restarts=2)


def test_deterministic_under_fixed_seed():
    solver.solve_cached.cache_clear()
    a = plan_network(SMALL_NET, HW, rng_seed=7, **FAST)
    solver.solve_cached.cache_clear()
    b = plan_network(SMALL_NET, HW, rng_seed=7, **FAST)
    assert a.total_duration == b.total_duration
    assert [lp.strategy for lp in a.layers] == \
        [lp.strategy for lp in b.layers]


def test_solve_cache_hits_on_repeated_layers():
    solver.solve_cached.cache_clear()
    plan = plan_network(SMALL_NET, HW, **FAST)
    # layers 1 and 2 share a spec: one miss, one hit
    assert plan.solver_calls == 3
    assert plan.cache_hits == 1
    # planning the same network again is all hits
    plan2 = plan_network(SMALL_NET, HW, **FAST)
    assert plan2.cache_hits == 3
    assert plan2.total_duration == plan.total_duration


def test_network_beats_per_layer_greedy_baseline():
    """Network objective <= sum of per-layer best-heuristic objectives
    (same full Def-3 accounting, no reuse) — per layer and in aggregate."""
    plan = plan_network(SMALL_NET, HW, **FAST)
    for lp in plan.layers:
        greedy = best_heuristic(lp.spec, lp.p, HW).full_duration(HW)
        assert lp.gross_duration <= greedy
    assert plan.baseline_duration == greedy_network_duration(SMALL_NET, HW)
    assert plan.total_duration <= plan.gross_duration <= \
        plan.baseline_duration


def test_reuse_only_when_activation_fits_budget():
    # unconstrained: every adjacent pair reuses
    plan = plan_network(SMALL_NET, HW, **FAST)
    assert all(lp.reuse_output for lp in plan.layers[:-1])
    assert all(lp.reuse_input for lp in plan.layers[1:])
    assert not plan.layers[-1].reuse_output    # nothing follows the last
    assert not plan.layers[0].reuse_input      # network input is in DRAM

    # a budget that fits each layer alone but not layer + held activation:
    # reuse must be dropped, never claimed infeasibly
    spec = SMALL_NET[1]
    tight_mem = max(s.kernel_elements + s.num_pixels * s.c_in
                    + 3 * 16 * s.c_out for s in SMALL_NET)
    tight = HardwareModel(nbop_pe=10 ** 9, size_mem=tight_mem)
    plan_t = plan_network(SMALL_NET, tight, **FAST)
    for prev, nxt in zip(plan_t.layers, plan_t.layers[1:]):
        if prev.reuse_output:
            assert activation_fits(prev.spec, prev.strategy,
                                   nxt.spec, nxt.strategy, tight)
        assert prev.reuse_output == nxt.reuse_input
    assert plan_t.total_duration <= plan_t.gross_duration

    # a budget smaller than any held activation: zero reuse claimed
    tiny = HardwareModel(nbop_pe=10 ** 9, size_mem=1)
    strat = best_heuristic(spec, 4, tiny)
    assert not activation_fits(spec, strat, spec, strat, tiny)


def test_duration_model_matches_simulator_exactly():
    """Per-layer gross durations must equal the Sec-6 simulator's measured
    Def-3 durations, and the functional outputs must be correct."""
    plan = plan_network(SMALL_NET, HW, **FAST)
    rep = simulate_network(plan)
    assert rep.correct
    assert rep.accounting_exact
    assert rep.sim_gross_duration == pytest.approx(plan.gross_duration)


def test_plans_paper_networks():
    """LeNet-5 and ResNet-8 configs plan end-to-end and beat greedy."""
    for layers in (lenet5.LAYERS, resnet8.LAYERS):
        plan = plan_network(layers, HW, polish_iters=300, polish_restarts=1)
        assert plan.n_layers == len(layers)
        assert plan.total_duration < plan.baseline_duration
        crit = plan.critical_path()
        assert len(crit) == plan.n_layers
        assert crit[0][1] == max(lp.duration for lp in plan.layers)
        assert plan.report()


def test_tight_budget_falls_back_to_s2_and_stays_feasible():
    """Regression: a budget smaller than the largest layer's
    kernel set used to produce an infeasible S1 plan silently; now the
    planner must emit a feasible plan using S2 for that layer."""
    net = tight.LAYERS_SMALL
    budget = max(s.kernel_elements for s in net) - 1
    hw = HardwareModel(nbop_pe=10 ** 9, size_mem=budget)
    plan = plan_network(net, hw, **FAST)
    assert plan.n_s2_layers >= 1
    assert plan.peak_footprint <= budget
    for lp in plan.layers:
        assert lp.strategy.peak_footprint_elements() <= budget
        assert lp.duration >= 0
    # plan must not lose to the feasible per-layer-greedy baseline
    assert plan.total_duration <= plan.baseline_duration
    # exact functional + accounting + memory validation through the sims
    rep = simulate_network(plan)
    assert rep.correct
    assert rep.accounting_exact
    assert rep.peak_within_budget


def test_infeasible_budget_raises_not_silent():
    """plan_network / greedy_network_duration raise instead of returning
    an infeasible schedule when nothing fits."""
    hw = HardwareModel(nbop_pe=10 ** 9, size_mem=4)
    with pytest.raises(InfeasibleNetworkError):
        plan_network(SMALL_NET, hw, **FAST)
    with pytest.raises(InfeasibleNetworkError):
        greedy_network_duration(SMALL_NET, hw)


def test_savings_clamped_and_durations_nonnegative():
    """input_load_saved never exceeds the strategy's measured first-load
    traffic and no layer's net duration goes negative, across budgets."""
    for size_mem in (None, 600, 1200, 2400, 4800):
        hw = HardwareModel(nbop_pe=10 ** 9, size_mem=size_mem)
        try:
            plan = plan_network(SMALL_NET, hw, **FAST)
        except InfeasibleNetworkError:
            continue
        for lp in plan.layers:
            assert lp.duration >= 0
            assert lp.input_load_saved <= \
                lp.strategy.first_load_duration(hw) + 1e-9
            assert lp.write_back_saved <= \
                lp.strategy.write_back_duration(hw) + 1e-9


def test_row_window_cascade_partial_savings():
    """When the full activation does not fit, a halo-extended row window
    is held instead: partial first-load savings, no write-back savings.
    (Budget chosen for the joint (p, strategy) planner: at tighter budgets
    it now prefers a cheaper larger-footprint S2 schedule over windowing.)"""
    hw = HardwareModel(nbop_pe=10 ** 9, size_mem=4400)
    plan = plan_network(lenet5.LAYERS, hw, **FAST)
    windowed = [lp for lp in plan.layers if lp.window_rows]
    assert windowed, "expected a row-window cascade at this budget"
    for lp in windowed:
        assert not lp.reuse_input          # partial, not full residency
        assert lp.window_rows >= lp.spec.h_k   # halo-extended minimum
        assert 0 < lp.input_load_saved <= \
            lp.strategy.first_load_duration(hw)
        # the producer of a windowed consumer still writes back
        assert not plan.layers[lp.index - 1].reuse_output
    rep = simulate_network(plan)
    assert rep.correct and rep.accounting_exact and rep.peak_within_budget


def _resident_during(plan, i):
    """Everything resident while layer i executes: its held input map
    (full or window) plus — when it also holds its output — the
    accumulating output map next to its working set, else its full peak
    footprint (write-back buffers included)."""
    lp = plan.layers[i]
    held_in = 0
    if i > 0:
        prev = plan.layers[i - 1].spec
        if lp.reuse_input:
            held_in = max(prev.num_patches * prev.c_out,
                          lp.spec.num_pixels * lp.spec.c_in)
        elif lp.window_rows:
            held_in = lp.window_rows * lp.spec.w_in * lp.spec.c_in
    if lp.reuse_output:
        nxt = plan.layers[i + 1].spec
        held_out = max(lp.spec.num_patches * lp.spec.c_out,
                       nxt.num_pixels * nxt.c_in)
        return held_in + held_out + lp.strategy.peak_working_set_elements()
    return held_in + lp.strategy.peak_footprint_elements()


def test_combined_residency_within_budget():
    """A middle layer holding both its input map and its accumulating
    output map must still fit the budget — pairwise-only reuse checks
    used to overcommit memory on chains of three or more layers."""
    for specs in (SMALL_NET, tight.LAYERS):
        big = max(s.kernel_elements for s in specs)
        for frac in (0.5, 1.0, 1.5, 2.0, 3.0, 6.0):
            hw = HardwareModel(nbop_pe=10 ** 9, size_mem=int(big * frac))
            try:
                plan = plan_network(specs, hw, **FAST)
            except InfeasibleNetworkError:
                continue
            for i in range(plan.n_layers):
                assert _resident_during(plan, i) <= hw.size_mem, \
                    (hw.size_mem, i)


def test_row_window_rows_fit_condition():
    """Window sizing: bounded by the spare budget next to both layers'
    working sets, at least h_k rows, at most the consumer's input."""
    spec = SMALL_NET[1]
    strat = best_heuristic(spec, 4, HW)
    # unconstrained: full residency path, no window needed
    assert row_window_rows(spec, strat, spec, strat, HW) == 0
    # generous budget: full input window
    roomy = HardwareModel(nbop_pe=10 ** 9, size_mem=10 ** 6)
    assert row_window_rows(spec, strat, spec, strat, roomy) == spec.h_in
    # just enough spare for fewer than h_k rows: no window
    base = strat.peak_footprint_elements()
    barely = HardwareModel(
        nbop_pe=10 ** 9,
        size_mem=base + (spec.h_k - 1) * spec.w_in * spec.c_in)
    assert row_window_rows(spec, strat, spec, strat, barely) == 0


def test_reuse_aware_refinement_never_loses_to_raw_assembly():
    """The reuse-aware refinement (re-solving a consumer under a
    tightened cap to unblock inter-layer reuse) must only ever lower the
    total: plan_network's result is <= the assembly of the raw per-layer
    joint-search results."""
    from repro_torch.core.network_planner import _assemble_layers, _resolve_ps

    for specs, size_mem in ((lenet5.LAYERS, 2400), (tight.LAYERS, 9216)):
        hw = HardwareModel(nbop_pe=10 ** 9, size_mem=size_mem)
        solver.solve_cached.cache_clear()
        solver.best_s2_cached.cache_clear()
        plan = plan_network(specs, hw, **FAST)
        ps = _resolve_ps(specs, hw, None, 16)
        raw = [solver.solve_cached(s, pp, hw, time_limit=10.0,
                                   use_milp=False, polish_iters=800,
                                   polish_restarts=2)
               for s, pp in zip(specs, ps)]
        _, raw_total, _ = _assemble_layers(specs, ps, raw, hw, True)
        assert plan.total_duration <= raw_total + 1e-9
        # refined plans stay feasible
        for lp in plan.layers:
            assert lp.strategy.peak_footprint_elements() <= size_mem
            assert lp.duration >= 0


def test_resolve_group_size_respects_pe_and_cap():
    spec = ConvSpec(1, 10, 10, 2, 3, 3)
    small_pe = HardwareModel(nbop_pe=spec.nb_op_value * spec.c_out * 3)
    assert resolve_group_size(spec, small_pe) == 3
    big_pe = HardwareModel(nbop_pe=10 ** 12)
    assert resolve_group_size(spec, big_pe, max_group=8) == 8
    assert resolve_group_size(spec, big_pe, max_group=None) == \
        spec.num_patches
    # PE below one full S1 patch row: group size 1 (solver goes S2)
    tiny_pe = HardwareModel(nbop_pe=spec.nb_op_value * spec.c_out - 1)
    assert resolve_group_size(spec, tiny_pe) == 1
