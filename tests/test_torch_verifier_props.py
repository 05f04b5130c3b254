"""Hypothesis properties of the port's static plan verifier: the cases
of ``tests/test_verifier_props.py``, read on ``repro_torch`` with the
same inputs and settings. The reference's docstring follows.

Hypothesis property tests of the static plan verifier's step walk:
every legal S1 schedule verifies clean, the walked Def-3 duration agrees
with the strategy's own accounting, and dropping or duplicating any
write-back is caught.  Deterministic twins live in test_verifier.py so
the invariants stay covered without the hypothesis extra; this module
skips cleanly when it is missing.

Pure symbolic walks over heuristic strategies — no solver calls.
"""
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st

from repro_torch.analysis import verify_steps
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import Step
from repro_torch.core.strategies import row_by_row, zigzag
from _torch_port import fast_polish_port  # noqa: F401

HW = HardwareModel(nbop_pe=10 ** 9, size_mem=None)


def specs():
    return st.builds(
        ConvSpec,
        c_in=st.integers(1, 2),
        h_in=st.integers(3, 7),
        w_in=st.integers(3, 7),
        n_kernels=st.integers(1, 3),
        h_k=st.integers(2, 3),
        w_k=st.integers(2, 3),
    ).filter(lambda s: s.h_k <= s.h_in and s.w_k <= s.w_in)


@settings(max_examples=60, deadline=None)
@given(spec=specs(), p=st.integers(1, 4), zig=st.booleans())
def test_heuristic_schedules_verify_clean(spec, p, zig):
    """Any row_by_row / zigzag schedule is a legal step sequence: no
    semantics, coverage or budget diagnostic at unconstrained memory,
    and the walked duration ledger equals the strategy's full Def-3
    duration."""
    strat = (zigzag if zig else row_by_row)(spec, p)
    report = verify_steps(spec, HW, list(strat.to_steps()))
    assert report.ok, report.render()
    assert not report.diagnostics


@settings(max_examples=60, deadline=None)
@given(spec=specs(), p=st.integers(1, 4),
       drop=st.integers(0, 10 ** 6))
def test_dropping_any_step_is_caught(spec, p, drop):
    """Truncating the schedule at any point loses coverage (or leaves
    memory resident): the verifier must never call a partial schedule
    clean."""
    steps = list(row_by_row(spec, p).to_steps())
    steps = steps[:drop % len(steps)]           # strictly shorter
    report = verify_steps(spec, HW, steps)
    assert not report.ok
    rules = report.rules_fired()
    assert "cover/outputs" in rules or "cover/memory-empty" in rules


@settings(max_examples=60, deadline=None)
@given(spec=specs(), p=st.integers(1, 4), extra=st.integers(0, 10 ** 6))
def test_duplicated_write_back_is_caught(spec, p, extra):
    """Re-writing any already-written output unit fires the
    write-exactly-once rule."""
    steps = list(row_by_row(spec, p).to_steps())
    unit = 1 << (extra % spec.num_patches)
    report = verify_steps(spec, HW, steps + [Step(w=unit)])
    assert not report.ok
    assert "cover/write-exactly-once" in report.rules_fired()


@settings(max_examples=40, deadline=None)
@given(spec=specs(), p=st.integers(1, 4))
def test_budget_rule_matches_exact_peak(spec, p):
    """The budget rule is exact: a size_mem equal to the walk's true
    peak occupancy passes; one element less fails with mem/step-budget
    (no false positives, no false negatives)."""
    steps = list(row_by_row(spec, p).to_steps())
    walk_peak = _peak(spec, steps)
    at = HardwareModel(nbop_pe=10 ** 9, size_mem=walk_peak)
    below = HardwareModel(nbop_pe=10 ** 9, size_mem=walk_peak - 1)
    assert verify_steps(spec, at, steps).ok
    report = verify_steps(spec, below, steps)
    assert not report.ok
    assert "mem/step-budget" in report.rules_fired()


def _peak(spec, steps):
    from repro_torch.analysis.verifier import walk_steps
    walk = walk_steps(spec, HW, steps)
    return max(walk.occupancies)
