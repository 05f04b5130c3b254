"""The cases of ``tests/test_fault_tolerance.py``, read on ``repro_torch``
with the same inputs and settings. The reference's docstring follows.

Unit tests for the host-side fault-tolerance scaffold
(``repro.runtime.fault_tolerance``) — resurrected as the control plane
of ``repro.resil``.  All clocks are fake: no sleeps anywhere.
"""
import pytest

from repro_torch.runtime import fault_tolerance as ft
from _torch_port import fast_polish_port  # noqa: F401


# --------------------------- HeartbeatTracker -------------------------- #

def test_host_that_never_beats_is_detected():
    """Registration stamps the construction time, so a host that dies
    before its first beat is still declared dead at timeout."""
    t = [0.0]
    hb = ft.HeartbeatTracker([0, 1], timeout_s=10, clock=lambda: t[0])
    t[0] = 10.0
    hb.beat(0, 0)
    assert hb.dead_hosts() == []            # exactly at timeout: alive
    t[0] = 10.5
    assert hb.dead_hosts() == [1]
    assert hb.alive_hosts() == [0]


def test_timeout_boundary_is_strict():
    """``now - last == timeout`` is alive — the resil engine beats
    survivors exactly at stage end + detection window and must not see
    them flagged alongside the genuinely silent chip."""
    t = [0.0]
    hb = ft.HeartbeatTracker([0], timeout_s=5, clock=lambda: t[0])
    t[0] = 5.0
    assert hb.dead_hosts() == []
    t[0] = 5.0 + 1e-9
    assert hb.dead_hosts() == [0]


def test_beat_from_unknown_host_raises():
    hb = ft.HeartbeatTracker([0, 1], timeout_s=10, clock=lambda: 0.0)
    with pytest.raises(ft.UnknownHostError):
        hb.beat(7, 0)


def test_beat_keeps_monotonic_step():
    hb = ft.HeartbeatTracker([0], timeout_s=10, clock=lambda: 0.0)
    hb.beat(0, 5)
    hb.beat(0, 3)                           # stale/reordered report
    assert hb.last_step[0] == 5


# --------------------------- StragglerDetector ------------------------- #

def test_ewma_first_sample_is_the_sample():
    """The EWMA must seed from the first observation, not blend it with
    the 0.0 placeholder (which would undercount every host forever)."""
    sd = ft.StragglerDetector([0], alpha=0.2)
    sd.record(0, 4.0)
    assert sd.ewma[0] == 4.0
    sd.record(0, 2.0)
    assert sd.ewma[0] == pytest.approx(0.8 * 4.0 + 0.2 * 2.0)


def test_record_from_unknown_host_raises():
    sd = ft.StragglerDetector([0])
    with pytest.raises(ft.UnknownHostError):
        sd.record(9, 1.0)


def test_no_stragglers_before_warmup():
    sd = ft.StragglerDetector([0, 1, 2], warmup=3)
    for _ in range(2):
        sd.record(0, 1.0)
        sd.record(1, 1.0)
        sd.record(2, 10.0)
    assert sd.fleet_median() == 0.0
    assert sd.stragglers() == []
    sd.record(0, 1.0)
    sd.record(1, 1.0)
    sd.record(2, 10.0)
    assert sd.stragglers() == [2]


# ------------------------------ ElasticPlan ---------------------------- #

def test_plan_rescale_no_survivors_raises():
    with pytest.raises(ft.NoSurvivorsError):
        ft.plan_rescale([], model_shards=4)


def test_plan_rescale_validates_degrees():
    with pytest.raises(ft.FaultToleranceError):
        ft.plan_rescale([0, 1], model_shards=0)
    with pytest.raises(ft.FaultToleranceError):
        ft.plan_rescale([0, 1], model_shards=2, chips_per_host=0)


def test_plan_rescale_single_host():
    plan = ft.plan_rescale([5], model_shards=1, chips_per_host=4)
    assert plan.hosts == (5,)
    assert plan.data_shards == 4 and plan.world == 4


# ---------------------------- TrainSupervisor -------------------------- #

def _run_supervisor(sup, total, fail_at):
    state = {"ckpt": 0}
    armed = dict(fail_at)

    def run_step(step, plan):
        if step in armed:
            raise ft.HostFailure(armed.pop(step))
        return 1.0

    return sup.run(total, run_step, lambda s: state.update(ckpt=s),
                   lambda: state["ckpt"])


def test_supervisor_evicts_dead_host_from_all_trackers():
    """A dead host must leave the straggler EWMA too — otherwise its
    frozen step time skews the fleet median after every restart."""
    sup = ft.TrainSupervisor(hosts=[0, 1, 2, 3], model_shards=1,
                             checkpoint_every=2, chips_per_host=4)
    for _ in range(5):
        sup.straggle.record(3, 50.0)        # host 3 was crawling...
        for h in (0, 1, 2):
            sup.straggle.record(h, 1.0)
    rep = _run_supervisor(sup, 6, fail_at={2: 3})    # ...then it dies
    assert rep.steps_done == 6 and rep.restarts == 1
    assert 3 not in sup.hb.last_seen and 3 not in sup.hb.last_step
    assert 3 not in sup.straggle.ewma and 3 not in sup.straggle.count
    assert sup.straggle.stragglers() == []


def test_supervisor_all_hosts_dead_raises_not_loops():
    sup = ft.TrainSupervisor(hosts=[0, 1], model_shards=1,
                             checkpoint_every=10, chips_per_host=4)
    with pytest.raises(ft.NoSurvivorsError):
        _run_supervisor(sup, 10, fail_at={0: 0, 1: 1})


def test_supervisor_resumes_from_checkpoint():
    sup = ft.TrainSupervisor(hosts=list(range(4)), model_shards=2,
                             checkpoint_every=3, chips_per_host=4)
    rep = _run_supervisor(sup, 10, fail_at={7: 2})
    assert rep.steps_done == 10
    assert rep.restarts == 1
    assert len(rep.rescales) == 1 and rep.rescales[0] <= 8
