"""Fault model: typed fault events and the seeded deterministic schedule.

Four fault kinds, each anchored to a *stage boundary* of the multichip
schedule (the network executes layer by layer — a stage — and recovery
is layer-granular, so stages are also the detection points):

=================  =====================================================
:class:`ChipDeath`      chip slot ``chip`` dies *during* stage ``layer``:
                        the whole attempt is wasted (its partial writes
                        never commit), the death is detected by the
                        heartbeat control plane at the stage boundary,
                        and the remaining layers are re-planned on the
                        surviving topology.
:class:`LinkDegrade`    from stage ``layer`` on, every ICI link moves
                        elements ``factor``x slower (``t_ici *=
                        factor``); detected *before* the stage runs
                        (link-level CRC/latency telemetry), so nothing
                        is recomputed — the tail is re-planned at the
                        degraded price.
:class:`VmemShrink`     from stage ``layer`` on, the per-chip on-chip
                        budget shrinks to ``floor(size_mem * factor)``
                        (e.g. a co-tenant claims VMEM); the tail is
                        re-planned under the tighter budget.
:class:`DmaTransient`   the DMA load of Def-3 step ``step`` of the
                        shard on chip slot ``chip`` in stage ``layer``
                        fails ``retries`` times before succeeding; each
                        retry re-reads the step's loads (idempotent —
                        DRAM reads have no side effects) and waits an
                        exponential backoff.  Purely a duration/traffic
                        fault: values are unchanged.
=================  =====================================================

``chip`` always names a *slot* of the plan currently executing (after a
recovery re-plan the surviving chips are renumbered ``0..n_surv-1``);
events whose slot does not exist in the current plan are recorded as
skipped, never silently dropped.

A :class:`FaultSchedule` is frozen and seeded: :meth:`FaultSchedule.random`
derives every event from ``random.Random(seed)`` so a faulted run is
reproducible bit-for-bit — the engine fingerprints its committed outputs
and ledger, and equality of fingerprints across runs is part of the
``faultsim`` exit criteria.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Union


class FaultError(RuntimeError):
    """Base class for every typed failure the resil subsystem raises."""


class ClusterExhaustedError(FaultError):
    """Every chip died — no surviving topology can run the remaining
    layers."""


class RecoveryCorruptionError(FaultError):
    """A recovery-correctness invariant broke: an output element was
    committed zero or multiple times, or the stitched output diverged
    from the fault-free reference convolution."""


class DegradedInfeasibleError(FaultError):
    """The degraded cluster cannot run the remaining layers (e.g. the
    shrunk VMEM budget fits no strategy) — recovery is impossible, not
    merely slow."""


class FaultScheduleError(FaultError):
    """A malformed fault schedule (bad factor, negative layer, ...)."""


@dataclasses.dataclass(frozen=True)
class ChipDeath:
    """Chip slot ``chip`` dies during stage ``layer``."""

    layer: int
    chip: int


@dataclasses.dataclass(frozen=True)
class LinkDegrade:
    """Every ICI link is ``factor``x slower from stage ``layer`` on."""

    layer: int
    factor: float


@dataclasses.dataclass(frozen=True)
class VmemShrink:
    """Per-chip budget shrinks to ``floor(size_mem * factor)`` from
    stage ``layer`` on."""

    layer: int
    factor: float


@dataclasses.dataclass(frozen=True)
class DmaTransient:
    """The loads of step ``step`` on chip slot ``chip`` in stage
    ``layer`` fail ``retries`` times before succeeding."""

    layer: int
    chip: int
    step: int
    retries: int


FaultEvent = Union[ChipDeath, LinkDegrade, VmemShrink, DmaTransient]


def _validate(events: "tuple[FaultEvent, ...]") -> None:
    deaths: set[int] = set()
    for e in events:
        if e.layer < 0:
            raise FaultScheduleError(f"negative layer in {e}")
        if isinstance(e, ChipDeath):
            if e.chip < 0:
                raise FaultScheduleError(f"negative chip in {e}")
            deaths.add(e.chip)
        elif isinstance(e, LinkDegrade):
            if e.factor < 1.0:
                raise FaultScheduleError(
                    f"LinkDegrade factor must be >= 1 (slower), got {e}")
        elif isinstance(e, VmemShrink):
            if not 0.0 < e.factor <= 1.0:
                raise FaultScheduleError(
                    f"VmemShrink factor must be in (0, 1], got {e}")
        elif isinstance(e, DmaTransient):
            if e.chip < 0 or e.step < 0 or e.retries < 1:
                raise FaultScheduleError(f"malformed DmaTransient {e}")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A seeded, deterministic set of fault events plus the recovery
    cost knobs the engine prices into the Def-3 ledger (all in abstract
    cycles, the same unit as ``t_l``/``t_w``/``t_acc``/``t_ici``):

    * ``detection_cycles`` — heartbeat timeout: how long after a stage
      ends the control plane declares a silent chip dead;
    * ``replan_cycles_per_layer`` — deterministic price of re-planning
      one remaining layer (planning wall-clock is machine-dependent, so
      the *ledger* uses this fixed rate; the measured seconds are
      reported separately and never enter the fingerprint);
    * ``backoff_base_cycles`` — DMA retry backoff: attempt ``a`` waits
      ``backoff_base_cycles * 2**(a-1)`` before re-issuing the load.
    """

    seed: int
    events: tuple[FaultEvent, ...]
    detection_cycles: float = 256.0
    replan_cycles_per_layer: float = 64.0
    backoff_base_cycles: float = 16.0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        _validate(self.events)

    @classmethod
    def random(cls, seed: int, *, n_layers: int, n_chips: int,
               n_events: int = 2,
               kinds: "tuple[str, ...]" = ("chip_death", "link_degrade",
                                           "vmem_shrink", "dma_transient"),
               **knobs: float) -> "FaultSchedule":
        """Draw ``n_events`` events deterministically from ``seed``.

        At most ``n_chips - 1`` chip deaths are drawn (the engine must
        always keep one survivor), and death slots are distinct within
        the schedule (a slot can only die once per plan epoch)."""
        if n_layers < 1 or n_chips < 1:
            raise FaultScheduleError(
                f"need n_layers >= 1 and n_chips >= 1, got "
                f"{n_layers}/{n_chips}")
        rng = random.Random(seed)
        events: list[FaultEvent] = []
        deaths: set[int] = set()
        for _ in range(n_events):
            kind = rng.choice(list(kinds))
            layer = rng.randrange(n_layers)
            if kind == "chip_death":
                free = sorted(set(range(n_chips)) - deaths)
                if len(free) <= 1 or len(deaths) >= n_chips - 1:
                    kind = "dma_transient"      # keep one survivor
                else:
                    chip = rng.choice(free)
                    deaths.add(chip)
                    events.append(ChipDeath(layer=layer, chip=chip))
                    continue
            if kind == "link_degrade":
                events.append(LinkDegrade(
                    layer=layer, factor=1.0 + rng.choice((1, 2, 3))))
            elif kind == "vmem_shrink":
                events.append(VmemShrink(
                    layer=layer, factor=rng.choice((0.9, 0.75, 0.6))))
            else:
                events.append(DmaTransient(
                    layer=layer, chip=rng.randrange(n_chips),
                    step=rng.randrange(4), retries=rng.randrange(1, 4)))
        events.sort(key=lambda e: (e.layer, type(e).__name__,
                                   getattr(e, "chip", -1)))
        return cls(seed=seed, events=tuple(events), **knobs)

    def describe(self) -> str:
        parts = [f"seed={self.seed}"]
        for e in self.events:
            parts.append(f"{type(e).__name__}{dataclasses.astuple(e)}")
        return " ".join(parts)
