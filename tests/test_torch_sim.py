"""The port's simulator (``repro_torch.sim``, paper Sec 6) against the
JAX package's.

The first part mirrors ``tests/test_simulator_basic.py`` and
``tests/test_s2_sim.py`` on the port.  The second holds the port's
``simulate_network`` against the reference's on every registered network
that both packages plan alike, on the same seeds: the simulators keep
their values in numpy, so outputs, durations, DRAM element counts and
peaks must be identical, not merely close.

The port's oracle ``reference_conv_torch`` (``F.conv2d`` on the CPU in
float32) is held against the numpy ``reference_conv`` at ``atol = 1e-5``:
both sum at most 27 products of O(1) values in float32, in another order,
so they differ by a few units in the last place of values below 10.
"""
import dataclasses

import numpy as np
import pytest

from _torch_port import fast_polish_port  # noqa: F401
from repro.analysis.kerncheck import network_budget as j_network_budget
from repro.configs.networks import NETWORKS as J_NETWORKS
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.core.network_planner import plan_network as j_plan_network
from repro.kernels.emit import plan_emitable_network as j_plan_emitable
from repro.sim import ConvLayer as JConvLayer
from repro.sim import simulate_network as j_simulate_network
from repro.sim.functional import reference_conv as j_reference_conv
from repro_torch.analysis.kerncheck import network_budget
from repro_torch.configs.networks import NETWORKS
from repro_torch.core import strategies_s2 as s2
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import run_steps
from repro_torch.core.network_planner import plan_network
from repro_torch.core.strategies import row_by_row, zigzag
from repro_torch.kernels.emit import plan_emitable_network
from repro_torch.sim import ConvLayer, System, simulate_network
from repro_torch.sim.functional import reference_conv, reference_conv_torch
from repro_torch.sim.s2 import S2Report, run_s2
from repro_torch.sim.trace import render_group_grid, render_input_heatmap

HW = HardwareModel(nbop_pe=10**9, size_mem=10**9)
BIG = HardwareModel(nbop_pe=10 ** 9, size_mem=None)
S2_SPEC = ConvSpec(c_in=2, h_in=7, w_in=7, n_kernels=6, h_k=3, w_k=3)


# --------------------------------------------------------------------- #
# test_simulator_basic.py, on the port
# --------------------------------------------------------------------- #

def test_oracles_agree():
    spec = ConvSpec(3, 8, 9, 4, 3, 2, 2, 1)
    layer = ConvLayer.random(spec)
    np.testing.assert_allclose(reference_conv(layer),
                               reference_conv_torch(layer), rtol=0,
                               atol=1e-5)


def test_the_torch_oracle_agrees_with_the_reference_oracle():
    """``reference_conv_torch`` against the JAX package's numpy oracle on
    the same seeded layer, strides included."""
    for spec in (ConvSpec(3, 8, 9, 4, 3, 2, 2, 1), ConvSpec(2, 7, 7, 3, 3, 3),
                 ConvSpec(3, 10, 10, 5, 3, 3, 2, 2)):
        mine, theirs = ConvLayer.random(spec, 4), JConvLayer.random(spec, 4)
        np.testing.assert_array_equal(mine.input, theirs.input)
        np.testing.assert_allclose(reference_conv_torch(mine),
                                   j_reference_conv(theirs), rtol=0,
                                   atol=1e-5)


def test_metrics_match_formalism():
    spec = ConvSpec(2, 6, 6, 2, 3, 3)
    layer = ConvLayer.random(spec)
    strat = zigzag(spec, 3)
    rep = System(layer, HW).run(strat)
    formal = run_steps(strat.to_steps(), spec, HW)
    assert rep.total_duration == formal.total_duration
    # Def 3's size_i^step unions M_{i-1} with the new loads *before* frees,
    # so it upper-bounds the actual footprint of the free-then-load sequence.
    assert rep.peak_footprint <= formal.peak_footprint
    assert rep.elements_read == (strat.pixels_loaded() * spec.c_in
                                 + spec.kernel_elements)
    assert rep.elements_written == spec.num_patches * spec.c_out
    assert rep.total_macs == spec.macs_total


def test_capacity_overflow_detected():
    spec = ConvSpec(2, 6, 6, 2, 3, 3)
    layer = ConvLayer.random(spec)
    tiny = HardwareModel(nbop_pe=10**9, size_mem=spec.kernel_elements + 5)
    with pytest.raises(MemoryError):
        System(layer, tiny).run(zigzag(spec, 3))


def test_pe_capacity_enforced():
    spec = ConvSpec(2, 6, 6, 2, 3, 3)
    layer = ConvLayer.random(spec)
    small_pe = HardwareModel(nbop_pe=spec.nb_op_value * spec.c_out,
                             size_mem=10**9)
    System(layer, small_pe).run(row_by_row(spec, 1))      # 1 patch ok
    with pytest.raises(RuntimeError, match="PE overrun"):
        System(layer, small_pe).run(row_by_row(spec, 2))  # 2 patches too many


def test_trace_rendering():
    spec = ConvSpec(2, 5, 5, 2, 3, 3)
    strat = zigzag(spec, 2)
    grid = render_group_grid(strat)
    assert "zigzag" in grid and len(grid.splitlines()) == spec.h_out + 1
    heat = render_input_heatmap(strat)
    assert len(heat.splitlines()) == spec.h_in + 1
    layer = ConvLayer.random(spec)
    rep = System(layer, HW).run(strat)
    assert all(t.describe(spec) for t in rep.traces)


def test_solver_strategy_runs_functionally():
    from repro_torch.core import solver
    spec = ConvSpec(1, 6, 6, 1, 3, 3)
    res = solver.solve(spec, p=4, hw=HW, time_limit=5, polish_iters=2000,
                       use_milp=False)
    layer = ConvLayer.random(spec)
    rep = System(layer, HW).run(res.strategy)
    assert rep.correct


def test_retries_add_reads_and_backoff_but_not_a_different_output():
    """``System.run``'s ``retry_at`` keeps the reference's meaning: a
    re-issued step re-reads its I_slice and K_sub and waits
    ``backoff_base * 2**(attempt - 1)``; the output does not change."""
    spec = ConvSpec(2, 6, 6, 2, 3, 3)
    layer = ConvLayer.random(spec)
    strat = zigzag(spec, 3)
    clean = System(layer, HW).run(strat)
    hit = System(layer, HW).run(strat, retry_at={1: 2}, backoff_base=4.0)
    s = strat.to_steps()[1]
    reread = (s.i_slice.bit_count() * spec.c_in
              + s.k_sub.bit_count() * spec.c_in * spec.h_k * spec.w_k)
    assert hit.retry_elements == 2 * reread
    assert hit.elements_read == clean.elements_read + 2 * reread
    load = clean.traces[1].load_duration
    assert hit.retry_duration == pytest.approx(2 * load + 4.0 + 8.0)
    np.testing.assert_array_equal(hit.output, clean.output)


# --------------------------------------------------------------------- #
# test_s2_sim.py, on the port
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("builder", [s2.kernel_major, s2.patch_major])
@pytest.mark.parametrize("p,kg", [(1, 1), (3, 2), (4, 3), (25, 6)])
def test_s2_sim_reconciles_model_exactly(builder, p, kg):
    strat = builder(S2_SPEC, p, kg)
    rep = run_s2(ConvLayer.random(S2_SPEC, seed=1), BIG, strat)
    assert rep.correct, rep.max_abs_err
    assert rep.total_duration == pytest.approx(strat.full_duration(BIG),
                                               abs=1e-9)
    assert rep.peak_memory <= strat.peak_footprint_elements()
    assert rep.elements_written == S2_SPEC.num_patches * S2_SPEC.c_out
    assert rep.total_macs == S2_SPEC.macs_total


def test_s2_protocol_write_back_and_first_load():
    strat = s2.patch_major(S2_SPEC, 4, 2)
    assert strat.full_duration(BIG) == pytest.approx(
        strat.objective(BIG) + strat.write_back_duration(BIG))
    assert strat.write_back_duration(BIG) == \
        S2_SPEC.num_patches * S2_SPEC.c_out * BIG.t_w
    assert strat.first_load_duration(BIG) == \
        S2_SPEC.all_pixels_mask.bit_count() * BIG.t_l
    assert strat.peak_working_set_elements() <= \
        strat.peak_footprint_elements()


def test_best_s2_results_run_and_reconcile_under_budgets():
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
            strat = builder(S2_SPEC, 4, kg)
            assert strat.objective(BIG) >= s2.s2_lower_bound(S2_SPEC, BIG)


# --------------------------------------------------------------------- #
# The port's simulate_network against the reference's
# --------------------------------------------------------------------- #

def _steps(plan):
    """Every layer's Def-3 steps as plain tuples, comparable across the
    two packages."""
    return [(lp.mode, [dataclasses.astuple(s) for s in lp.strategy.to_steps()])
            for lp in plan.layers]


def _assert_same_reports(mine, theirs):
    assert mine.correct and theirs.correct
    assert mine.accounting_exact and theirs.accounting_exact
    assert mine.peak_within_budget and theirs.peak_within_budget
    assert len(mine.layer_reports) == len(theirs.layer_reports)
    for a, b in zip(mine.layer_reports, theirs.layer_reports):
        assert type(a).__name__ == type(b).__name__
        np.testing.assert_array_equal(a.output, b.output)
        assert a.total_duration == b.total_duration
        assert a.elements_read == b.elements_read
        assert a.elements_written == b.elements_written
        assert a.total_macs == b.total_macs
        assert a.max_abs_err == b.max_abs_err
        if isinstance(a, S2Report):
            assert a.peak_memory == b.peak_memory
            assert a.kernel_loads == b.kernel_loads
        else:
            assert a.peak_footprint == b.peak_footprint
        assert [(t.duration, t.read_elements, t.written_elements,
                 t.mem_elements) for t in a.traces] == \
            [(t.duration, t.read_elements, t.written_elements,
              t.mem_elements) for t in b.traces]
    assert mine.sim_gross_duration == theirs.sim_gross_duration
    assert mine.elements_read == theirs.elements_read
    assert mine.elements_written == theirs.elements_written


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_simulate_network_matches_the_reference(name, seed):
    """The emitable plans at kerncheck's budget (what the kernels run):
    both packages plan every registered network alike there."""
    jhw = j_network_budget(J_NETWORKS[name])
    plan = plan_emitable_network(list(NETWORKS[name]),
                                 network_budget(NETWORKS[name]), name=name)
    jplan = j_plan_emitable(J_NETWORKS[name], jhw, name=name)
    assert _steps(plan) == _steps(jplan)
    _assert_same_reports(simulate_network(plan, seed=seed),
                         j_simulate_network(jplan, seed=seed))


def test_simulate_network_matches_the_reference_through_s2_layers():
    """``lenet5`` at 2400 elements: its second layer's kernel set no
    longer fits, and both packages plan it as kernel-group swapping."""
    kw = dict(name="lenet5", polish_iters=300, polish_restarts=1)
    plan = plan_network(list(NETWORKS["lenet5"]),
                        HardwareModel(nbop_pe=1 << 20, size_mem=2400), **kw)
    jplan = j_plan_network(J_NETWORKS["lenet5"],
                           JHardwareModel(nbop_pe=1 << 20, size_mem=2400),
                           **kw)
    assert [lp.mode for lp in plan.layers] == ["s1", "s2"]
    assert _steps(plan) == _steps(jplan)
    _assert_same_reports(simulate_network(plan, seed=3),
                         j_simulate_network(jplan, seed=3))


@pytest.mark.parametrize("name", ["tight2", "resnet8"])
def test_plain_k1_fetches_what_simulator_kerncheck_and_plan_count(name):
    """The CPU side of ``chip_smoke.py``'s phase 8: under the H100's
    budget, the boxes K1's plain version slices at each layer, times the
    channels, plus the kernel set, are the simulator's DRAM reads,
    kerncheck's ``kern/traffic`` total and the plan's charge; and the plain
    version's output is the simulator's (f32, ``rtol = atol = 1e-4``: sums
    of at most 576 products of O(1) values in another order)."""
    import torch

    from repro_torch.analysis.kerncheck import (build_conv_trace,
                                                check_conv_trace)
    from repro_torch.core.cost_model import H100_SXM
    from repro_torch.kernels.conv2d_offload import \
        conv2d_offload_planned_plain
    from repro_torch.kernels.emit import emit_layer_kernel
    hw = H100_SXM.as_hardware_model(dtype_bytes=4)
    plan = plan_emitable_network(list(NETWORKS[name]), hw, name=name)
    sim = simulate_network(plan, seed=31)
    assert sim.correct and sim.accounting_exact and sim.peak_within_budget
    for lp, rep in zip(plan.layers, sim.layer_reports):
        em, s = emit_layer_kernel(lp), lp.spec
        layer = ConvLayer.random(s, seed=31 + lp.index)
        out, fetches = conv2d_offload_planned_plain(
            torch.from_numpy(layer.input), torch.from_numpy(layer.kernels),
            t_run=em.t_run, s_h=s.s_h, s_w=s.s_w, order=em.order,
            return_fetches=True)
        plain = sum((h1 - h0) * (w1 - w0) for _, h0, h1, w0, w1 in fetches) \
            * s.c_in + s.kernel_elements
        trace = build_conv_trace(em)
        assert check_conv_trace(trace, lp.strategy, hw.size_mem) == []
        assert plain == rep.elements_read == trace.fetched_elements == (
            lp.strategy.pixels_loaded() * s.c_in + s.kernel_elements)
        np.testing.assert_allclose(out.numpy(), rep.output, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("modes", [None, ("row", "row")])
def test_simulate_multichip_matches_the_reference(modes):
    """``tight2`` on 4 chips of 3000 elements each (kernel-channel shards
    as planned, or row bands when asked): every shard's report, the
    stitched check and the cluster accounting as the reference's."""
    from repro.core.cost_model import ClusterModel as JClusterModel
    from repro.core.multichip import plan_multichip_network as j_plan_mc
    from repro.sim import simulate_multichip as j_simulate_multichip
    from repro_torch.core.cost_model import ClusterModel
    from repro_torch.core.multichip import plan_multichip_network
    from repro_torch.sim import simulate_multichip
    kw = dict(name="tight2", polish_iters=300, polish_restarts=1,
              modes=modes)
    plan = plan_multichip_network(
        list(NETWORKS["tight2"]),
        ClusterModel(chip=HardwareModel(nbop_pe=1 << 20, size_mem=3000),
                     n_chips=4), **kw)
    jplan = j_plan_mc(
        J_NETWORKS["tight2"],
        JClusterModel(chip=JHardwareModel(nbop_pe=1 << 20, size_mem=3000),
                      n_chips=4), **kw)
    assert [lp.mode for lp in plan.layers] == [lp.mode for lp in jplan.layers]
    mine, theirs = simulate_multichip(plan, seed=2), \
        j_simulate_multichip(jplan, seed=2)
    assert mine.correct and mine.accounting_exact and mine.peak_within_budget
    assert (theirs.correct, theirs.accounting_exact) == (True, True)
    assert mine.stitched_ok == theirs.stitched_ok
    for reps, jreps in zip(mine.shard_reports, theirs.shard_reports):
        for a, b in zip(reps, jreps):
            np.testing.assert_array_equal(a.output, b.output)
            assert (a.total_duration, a.elements_read, a.elements_written) \
                == (b.total_duration, b.elements_read, b.elements_written)
    assert mine.sim_compute_duration == theirs.sim_compute_duration
    assert mine.modeled_total_duration == theirs.modeled_total_duration
