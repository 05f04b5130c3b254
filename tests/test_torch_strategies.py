"""The cases of ``tests/test_strategies.py``, read on ``repro_torch`` with
the same inputs and settings. The reference's docstring follows.

Hypothesis property tests of strategy/system invariants.  Deterministic
strategy tests live in test_strategies_basic.py so they run without the
hypothesis extra; this module skips cleanly when it is missing.
"""
import pytest

pytest.importorskip("hypothesis")

import hypothesis
from hypothesis import given, settings, strategies as st

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import run_steps
from repro_torch.core.strategies import (hilbert, lower_bound, row_by_row,
                                         s1_baseline, tiled, zigzag)
from _torch_port import fast_polish_port  # noqa: F401

BIG_HW = HardwareModel(nbop_pe=10**9)


def specs():
    return st.builds(
        ConvSpec,
        c_in=st.integers(1, 3),
        h_in=st.integers(3, 9),
        w_in=st.integers(3, 9),
        n_kernels=st.integers(1, 4),
        h_k=st.integers(1, 3),
        w_k=st.integers(1, 3),
        s_h=st.integers(1, 2),
        s_w=st.integers(1, 2),
    ).filter(lambda s: s.h_in >= s.h_k and s.w_in >= s.w_k)


@settings(max_examples=40, deadline=None)
@given(spec=specs(), p=st.integers(1, 6),
       builder=st.sampled_from([row_by_row, zigzag, tiled, hilbert]))
def test_property_every_patch_exactly_once(spec, p, builder):
    strat = builder(spec, p)
    seen = sorted(pid for g in strat.groups for pid in g)
    assert seen == list(range(spec.num_patches))
    assert strat.max_group_size() <= p


@settings(max_examples=30, deadline=None)
@given(spec=specs(), p=st.integers(1, 6),
       builder=st.sampled_from([row_by_row, zigzag, tiled, hilbert]))
def test_property_semantics_execute_and_duration_matches(spec, p, builder):
    """Invariant: Def-16 strategies always execute under the Def-2 semantics,
    memory ends empty, and eq. 15 == t_l*sum|I_slice| + n*t_acc recomputed
    from the raw steps."""
    strat = builder(spec, p)
    res = run_steps(strat.to_steps(), spec, BIG_HW)
    assert res.states[-1].empty
    islice_sum = sum(s.i_slice.bit_count() for s in strat.to_steps())
    assert strat.objective(BIG_HW) == islice_sum + strat.n_steps
    assert strat.pixels_loaded() == islice_sum


@settings(max_examples=30, deadline=None)
@given(spec=specs(), p=st.integers(1, 6))
def test_property_objective_at_least_lower_bound(spec, p):
    for builder in (row_by_row, zigzag, tiled, hilbert):
        assert builder(spec, p).objective(BIG_HW) >= \
            lower_bound(spec, p, BIG_HW)


@settings(max_examples=20, deadline=None)
@given(spec=specs(), p=st.integers(2, 6))
def test_property_grouping_never_worse_than_baseline(spec, p):
    """S1 with groups (paper's extension) dominates S1-baseline (1 patch per
    step) for any heuristic order, since merging consecutive patches can only
    remove steps and increase intra-group reuse."""
    assert row_by_row(spec, p).objective(BIG_HW) <= \
        s1_baseline(spec).objective(BIG_HW)
