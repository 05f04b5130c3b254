"""The control plane of the simulated recovery loop.

``repro_torch.runtime.fault_tolerance`` is a host-side scaffold
(heartbeats, straggler EWMA, elastic rescale).  The fault-injection
engine drives it here, on *simulated time*: the
controller's clock is the engine's Def-3 cycle cursor, so heartbeat
timeouts are priced in the same abstract cycles as everything else and
detection is deterministic — no wall-clock, no sleeps.

Per stage the engine reports a heartbeat (and the measured shard
duration) for every chip that finished; a chip that died mid-stage
reports nothing, and after ``detection_cycles`` of silence
:meth:`RecoveryController.detect_dead` names it.  The surviving mesh is
recorded as an :class:`ElasticPlan` — built directly over the survivors
(model axis 1, one data shard per chip), because the conv planner
re-shards over *every* survivor; ``plan_rescale``'s power-of-two policy
is the training-fleet variant and stays untouched.
"""
from __future__ import annotations

from repro_torch.resil.faults import FaultError
from repro_torch.runtime.fault_tolerance import (ElasticPlan,
                                                 HeartbeatTracker,
                                                 StragglerDetector)


class ControlPlaneError(FaultError):
    """The control plane and the fault injection disagree — e.g. the
    heartbeat tracker missed a death the schedule injected, or detected
    one that never happened.  Always an engine bug."""


class RecoveryController:
    """Heartbeats + straggler EWMA over the engine's cycle clock."""

    def __init__(self, chips: "list[int]", *,
                 detection_cycles: float = 256.0):
        self._now = 0.0
        self.detection_cycles = detection_cycles
        self.hb = HeartbeatTracker(chips, timeout_s=detection_cycles,
                                   clock=lambda: self._now)
        self.straggle = StragglerDetector(chips)
        self.dead: list[int] = []

    @property
    def now(self) -> float:
        return self._now

    def advance(self, cycles: float) -> None:
        if cycles < 0:
            raise ControlPlaneError(f"clock went backwards ({cycles})")
        self._now += cycles

    def stage_done(self, chips: "list[int]", stage: int,
                   durations: "dict[int, float]") -> None:
        """Chips that finished ``stage`` beat and report their measured
        shard duration (feeding the straggler EWMA)."""
        for chip in chips:
            self.hb.beat(chip, stage)
            if chip in durations:
                self.straggle.record(chip, durations[chip])

    def detect_dead(self) -> "list[int]":
        """Newly dead chips (silent longer than the timeout), removed
        from tracking so they are reported exactly once."""
        newly = [c for c in self.hb.dead_hosts() if c not in self.dead]
        for c in newly:
            self.dead.append(c)
            self.hb.last_seen.pop(c, None)
            self.hb.last_step.pop(c, None)
            # a dead chip must not keep tripping the straggler EWMA
            self.straggle.ewma.pop(c, None)
            self.straggle.count.pop(c, None)
        return newly

    def expect_death(self, chip: int) -> None:
        """Cross-check: the schedule killed ``chip`` — the heartbeat
        tracker must name exactly it once the timeout has elapsed."""
        newly = self.detect_dead()
        if newly != [chip]:
            raise ControlPlaneError(
                f"heartbeat tracker detected {newly}, schedule killed "
                f"chip {chip}")

    def elastic_plan(self, survivors: "list[int]") -> ElasticPlan:
        """The surviving mesh record: every survivor carries one shard
        (the conv planner re-shards over all of them)."""
        hosts = tuple(sorted(survivors))
        return ElasticPlan(hosts=hosts, data_shards=len(hosts),
                           model_shards=1,
                           shard_of_host={h: i for i, h in
                                          enumerate(hosts)})

    def stragglers(self) -> "list[int]":
        return self.straggle.stragglers()
