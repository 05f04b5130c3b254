"""The cases of ``tests/test_s2_basic.py``, read on ``repro_torch`` with
the same inputs and settings. The reference's docstring follows.

S2 strategies (paper Sec 9 future work) — deterministic tests: formal
semantics, memory-budget claims, and the dataflow trade.  (The functional
property test lives in test_s2.py and needs hypothesis.)
"""
import pytest

from repro_torch.core import strategies_s2 as s2
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import run_steps
from repro_torch.sim import ConvLayer
from repro_torch.sim.s2 import run_s2
from _torch_port import fast_polish_port  # noqa: F401

BIG = HardwareModel(nbop_pe=10 ** 9, size_mem=None)


def _spec(n_kernels=4):
    return ConvSpec(c_in=2, h_in=6, w_in=6, n_kernels=n_kernels,
                    h_k=3, w_k=3)


def test_s2_formal_semantics_execute():
    spec = _spec()
    for builder in (s2.kernel_major, s2.patch_major):
        strat = builder(spec, p=3, kg_size=2)
        res = run_steps(strat.to_steps(), spec, BIG,
                        validate=False)          # out ids are (pid, kg) units
        assert res.states[-1].empty
        # every (patch, kernel-group) unit computed exactly once
        computed = 0
        for s in strat.to_steps():
            assert (computed & s.out) == 0
            computed |= s.out
        assert computed.bit_count() == spec.num_patches * 2


def test_s2_runs_where_s1_cannot():
    """The headline claim: S1 needs all kernels resident; S2 fits a budget
    smaller than the kernel set itself."""
    spec = ConvSpec(c_in=2, h_in=6, w_in=6, n_kernels=8, h_k=3, w_k=3)
    # budget below kernel_elements: S1 is infeasible by construction
    budget = spec.kernel_elements - 1
    res = s2.best_s2(spec, HardwareModel(nbop_pe=10 ** 9, size_mem=budget))
    assert not res.feasible_s1
    assert res.peak_memory <= budget
    hw = HardwareModel(nbop_pe=10 ** 9, size_mem=budget)
    rep = run_s2(ConvLayer.random(spec), hw, res.strategy)
    assert rep.correct
    assert rep.peak_memory <= budget


def test_s2_dataflow_trade():
    """kernel_major loads each kernel once but re-reads the input per
    kernel group; patch_major is the transpose.  Small kernels + big input
    -> kernel_major's input re-reads dominate -> patch_major wins, and
    vice versa."""
    hw = BIG
    # big input, few small kernels, few patch groups: re-cycling kernels
    # per patch group is far cheaper than re-sweeping the input per kernel
    spec_a = ConvSpec(1, 16, 16, 2, 3, 3)
    pm = s2.patch_major(spec_a, 49, 1).objective(hw)
    km = s2.kernel_major(spec_a, 49, 1).objective(hw)
    assert pm < km
    # tiny input, many big kernels, several patch groups: re-cycling the
    # kernel set per patch group (patch_major) is the expensive direction
    spec_b = ConvSpec(8, 5, 5, 16, 3, 3)
    pm_b = s2.patch_major(spec_b, 3, 1).objective(hw)
    km_b = s2.kernel_major(spec_b, 3, 1).objective(hw)
    assert km_b < pm_b


def test_s2_kernel_reload_counts():
    spec = _spec(n_kernels=4)
    layer = ConvLayer.random(spec)
    km = run_s2(layer, BIG, s2.kernel_major(spec, 2, 2))
    pm = run_s2(layer, BIG, s2.patch_major(spec, 2, 2))
    assert km.kernel_loads == spec.n_kernels          # once each
    n_patch_groups = -(-spec.num_patches // 2)
    assert pm.kernel_loads == spec.n_kernels * n_patch_groups


def test_s2_objective_matches_simulator_duration():
    spec = _spec()
    strat = s2.patch_major(spec, 3, 2)
    rep = run_s2(ConvLayer.random(spec), BIG, strat)
    # objective counts loads + t_acc; simulator additionally counts t_w
    assert rep.total_duration == pytest.approx(
        strat.objective(BIG) + spec.num_patches * spec.c_out * BIG.t_w)


def test_s2_reduces_duration_under_tight_memory():
    """Under a tight budget, the S2 search still finds a runnable strategy
    and its duration lower-bounds gracefully vs the unconstrained best."""
    spec = ConvSpec(2, 8, 8, 8, 3, 3)
    hw_free = HardwareModel(nbop_pe=10 ** 9, size_mem=None)
    free = s2.best_s2(spec, hw_free)
    tight = s2.best_s2(spec, HardwareModel(
        nbop_pe=10 ** 9, size_mem=free.peak_memory // 2))
    assert tight.objective >= free.objective
    assert tight.peak_memory <= free.peak_memory // 2


def test_nb_patches_max_s2_scales_inverse_with_kernels():
    spec = _spec(n_kernels=8)
    hw = HardwareModel(nbop_pe=spec.nb_op_value * 8 * 3)
    assert s2.nb_patches_max_s2(spec, hw, 1) == 24
    assert s2.nb_patches_max_s2(spec, hw, 8) == 3
