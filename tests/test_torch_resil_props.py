"""Hypothesis properties of the port's fault-injection engine: the cases
of ``tests/test_resil_props.py``, with its settings, on
``repro_torch.resil`` (``tests/test_torch_resil.py`` holds the port's
fingerprints against the reference's).  Skips cleanly without
hypothesis.

Every example plans and simulates tight2 on a 2-chip ring, the cheapest
registered configuration; the shared ``solve_cached`` LRU re-plans
repeated examples from cache.
"""
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st

from _torch_port import fast_polish_port  # noqa: F401
from repro_torch.configs.clusters import make_cluster
from repro_torch.configs.networks import NETWORKS
from repro_torch.resil.engine import run_faulted
from repro_torch.resil.faults import (ChipDeath, DmaTransient,
                                      FaultSchedule, LinkDegrade,
                                      VmemShrink)

SPECS = NETWORKS["tight2"]
N_CHIPS = 2
FAST = dict(polish_iters=40, polish_restarts=1)


def _cluster():
    size_mem = max(s.kernel_elements for s in SPECS) // 2
    return make_cluster(N_CHIPS, size_mem=size_mem, topology="ring")


def _events():
    layer = st.integers(0, len(SPECS) - 1)
    chip = st.integers(0, N_CHIPS - 1)
    return st.one_of(
        st.builds(ChipDeath, layer=layer, chip=chip),
        st.builds(LinkDegrade, layer=layer,
                  factor=st.sampled_from((2.0, 3.0, 4.0))),
        st.builds(VmemShrink, layer=layer,
                  factor=st.sampled_from((0.9, 0.75))),
        st.builds(DmaTransient, layer=layer, chip=chip,
                  step=st.integers(0, 3), retries=st.integers(1, 3)))


def _schedules(events=_events()):
    def ok(evs):
        return sum(isinstance(e, ChipDeath) for e in evs) <= N_CHIPS - 1
    return st.lists(events, min_size=0, max_size=3).filter(ok).map(
        lambda evs: FaultSchedule(seed=0, events=tuple(evs)))


@settings(max_examples=12, deadline=None)
@given(sch=_schedules(), seed=st.integers(0, 3))
def test_recovery_is_exact_and_verified(sch, seed):
    rep = run_faulted(SPECS, _cluster(), sch, name="tight2", seed=seed,
                      verify=True, **FAST)
    assert rep.ok, rep.findings
    assert rep.recovery_exact and rep.write_counts_ok
    assert rep.accounting_ok
    assert all(r.verified for r in rep.recoveries)
    assert all(c is not None for c in rep.committed)


@settings(max_examples=10, deadline=None)
@given(sch=_schedules(st.one_of(
    st.builds(ChipDeath, layer=st.integers(0, len(SPECS) - 1),
              chip=st.integers(0, N_CHIPS - 1)),
    st.builds(DmaTransient, layer=st.integers(0, len(SPECS) - 1),
              chip=st.integers(0, N_CHIPS - 1),
              step=st.integers(0, 3), retries=st.integers(1, 3)))))
def test_no_free_lunch_under_recompute_faults(sch):
    rep = run_faulted(SPECS, _cluster(), sch, name="tight2", **FAST)
    assert rep.no_free_lunch
    assert rep.faulted_duration >= rep.baseline_duration - 1e-6
    if any(isinstance(e, ChipDeath) for e in sch.events):
        assert rep.wasted_cycles > 0 or rep.skipped_events


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 100))
def test_random_schedules_are_deterministic(seed):
    a = FaultSchedule.random(seed, n_layers=len(SPECS), n_chips=N_CHIPS,
                             n_events=3)
    b = FaultSchedule.random(seed, n_layers=len(SPECS), n_chips=N_CHIPS,
                             n_events=3)
    assert a == b
    rep1 = run_faulted(SPECS, _cluster(), a, name="tight2", **FAST)
    rep2 = run_faulted(SPECS, _cluster(), b, name="tight2", **FAST)
    assert rep1.fingerprint == rep2.fingerprint
