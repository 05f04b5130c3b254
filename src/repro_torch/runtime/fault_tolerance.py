"""Fault tolerance & elasticity runtime (host-side control plane).

Pieces needed at 1000+ nodes, kept hardware-agnostic so the same logic runs
under a real multi-host launcher or in the single-process tests:

  * ``HeartbeatTracker`` — hosts report a monotonically increasing step;
    a host silent for longer than ``timeout_s`` is declared dead;
  * ``StragglerDetector`` — per-host step-time EWMA; a host whose step time
    exceeds ``factor`` x fleet median is flagged for mitigation (reorder
    its data shard, exclude from critical collectives, or preemptively
    evict);
  * ``ElasticPlan`` — given the surviving hosts, computes the new mesh
    shape and the (data-shard -> host) remap; a deterministic data
    pipeline and a re-sharding checkpoint restore make the rescale
    exactly-once;
  * ``TrainSupervisor`` — the restart loop: run steps, checkpoint every K,
    on failure shrink/regrow the mesh and restore from the newest commit.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Iterable


# --------------------------------------------------------------------- #
# Typed failures
# --------------------------------------------------------------------- #

class FaultToleranceError(RuntimeError):
    """Base class for control-plane misuse/impossibility errors."""


class UnknownHostError(FaultToleranceError):
    """A beat/record arrived from a host the tracker never registered —
    either a wiring bug or a zombie host that was already evicted.
    Silently resurrecting it would mask both, so it is an error."""


class NoSurvivorsError(FaultToleranceError):
    """Every host is gone: no mesh can be built.  Raised instead of
    returning an empty :class:`ElasticPlan` (which callers would loop on
    forever, restoring and re-planning a zero-host fleet)."""


# --------------------------------------------------------------------- #
# Failure detection
# --------------------------------------------------------------------- #

class HeartbeatTracker:
    def __init__(self, hosts: Iterable[int], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last_seen: dict[int, float] = {h: clock() for h in hosts}
        self.last_step: dict[int, int] = {h: -1 for h in hosts}

    def beat(self, host: int, step: int) -> None:
        if host not in self.last_seen:
            raise UnknownHostError(
                f"heartbeat from unregistered host {host}")
        self.last_seen[host] = self.clock()
        self.last_step[host] = max(self.last_step.get(host, -1), step)

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        return sorted(h for h, t in self.last_seen.items()
                      if now - t > self.timeout)

    def alive_hosts(self) -> list[int]:
        dead = set(self.dead_hosts())
        return sorted(h for h in self.last_seen if h not in dead)


class StragglerDetector:
    """EWMA step times; flag hosts slower than factor x fleet median."""

    def __init__(self, hosts: Iterable[int], alpha: float = 0.2,
                 factor: float = 1.5, warmup: int = 3):
        self.alpha = alpha
        self.factor = factor
        self.warmup = warmup
        self.ewma: dict[int, float] = {h: 0.0 for h in hosts}
        self.count: dict[int, int] = {h: 0 for h in hosts}

    def record(self, host: int, step_time_s: float) -> None:
        if host not in self.ewma:
            raise UnknownHostError(
                f"step-time report from unregistered host {host}")
        c = self.count.get(host, 0)
        prev = self.ewma.get(host, 0.0)
        self.ewma[host] = step_time_s if c == 0 else \
            (1 - self.alpha) * prev + self.alpha * step_time_s
        self.count[host] = c + 1

    def fleet_median(self) -> float:
        vals = sorted(v for h, v in self.ewma.items()
                      if self.count[h] >= self.warmup)
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def stragglers(self) -> list[int]:
        med = self.fleet_median()
        if med <= 0:
            return []
        return sorted(h for h, v in self.ewma.items()
                      if self.count[h] >= self.warmup
                      and v > self.factor * med)


# --------------------------------------------------------------------- #
# Elastic rescale planning
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    hosts: tuple[int, ...]           # surviving hosts, rank order
    data_shards: int                 # new data-parallel degree
    model_shards: int                # unchanged TP degree
    shard_of_host: dict[int, int]    # host -> data shard index

    @property
    def world(self) -> int:
        return self.data_shards * self.model_shards


def plan_rescale(alive: Iterable[int], model_shards: int,
                 chips_per_host: int = 4) -> ElasticPlan:
    """Largest mesh we can build from the survivors: TP degree is fixed
    (weights layout), the data axis shrinks to the largest multiple that
    the surviving chip count supports."""
    if model_shards < 1 or chips_per_host < 1:
        raise FaultToleranceError(
            f"model_shards and chips_per_host must be >= 1, got "
            f"{model_shards}/{chips_per_host}")
    hosts = tuple(sorted(alive))
    if not hosts:
        raise NoSurvivorsError("no surviving hosts to build a mesh from")
    chips = len(hosts) * chips_per_host
    data = max(1, chips // model_shards)
    # data axis must evenly divide the global batch handling; keep a power
    # of two for collective efficiency.
    data = 1 << int(math.log2(data)) if data > 0 else 1
    used_hosts = hosts[: (data * model_shards) // chips_per_host]
    shard_of = {h: i % data for i, h in enumerate(used_hosts)}
    return ElasticPlan(hosts=used_hosts, data_shards=data,
                       model_shards=model_shards, shard_of_host=shard_of)


# --------------------------------------------------------------------- #
# Restart supervisor
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class SupervisorReport:
    steps_done: int
    restarts: int
    rescales: list[int]              # data_shards after each rescale
    straggler_events: int


class TrainSupervisor:
    """Deterministic restart loop used by tests and the real launcher.

    ``run_step(step, plan) -> step_time_s`` may raise HostFailure to signal
    a lost host; the supervisor then replans the mesh, restores from the
    last checkpoint step, and continues."""

    def __init__(self, hosts: list[int], model_shards: int,
                 checkpoint_every: int = 10, chips_per_host: int = 4):
        self.hb = HeartbeatTracker(hosts, timeout_s=float("inf"))
        self.straggle = StragglerDetector(hosts)
        self.model_shards = model_shards
        self.chips_per_host = chips_per_host
        self.checkpoint_every = checkpoint_every

    def run(self, total_steps: int,
            run_step: Callable[[int, ElasticPlan], float],
            save: Callable[[int], None],
            restore: Callable[[], int],
            fail_host: Callable[[int], None] | None = None
            ) -> SupervisorReport:
        plan = plan_rescale(self.hb.alive_hosts(), self.model_shards,
                            self.chips_per_host)
        step, restarts, rescales, stragglers = 0, 0, [], 0
        while step < total_steps:
            try:
                dt = run_step(step, plan)
                for h in plan.hosts:
                    self.hb.beat(h, step)
                    self.straggle.record(h, dt)
                if self.straggle.stragglers():
                    stragglers += 1
                if (step + 1) % self.checkpoint_every == 0:
                    save(step + 1)
                step += 1
            except HostFailure as hf:
                restarts += 1
                # evict the host from *every* tracker: a dead host left
                # in the straggler EWMA would keep skewing the fleet
                # median (and could be flagged) forever after
                self.hb.last_seen.pop(hf.host, None)
                self.hb.last_step.pop(hf.host, None)
                self.straggle.ewma.pop(hf.host, None)
                self.straggle.count.pop(hf.host, None)
                if fail_host:
                    fail_host(hf.host)
                plan = plan_rescale(self.hb.alive_hosts(),
                                    self.model_shards,
                                    self.chips_per_host)
                rescales.append(plan.data_shards)
                step = restore()
        return SupervisorReport(steps_done=step, restarts=restarts,
                                rescales=rescales,
                                straggler_events=stragglers)


class HostFailure(RuntimeError):
    def __init__(self, host: int):
        super().__init__(f"host {host} failed")
        self.host = host
