"""Symbolic region algebra + happens-before hazard analysis for kernels.

The kernel contract checker (:mod:`repro_torch.analysis.kerncheck`) walks a
Pallas kernel's grid *symbolically* — evaluating BlockSpec index_maps and
``make_async_copy`` source slices on concrete grid indices, never
executing the kernel — and needs two pieces of machinery:

* **regions** — rectangular boxes over named tensors/buffers
  (:class:`Region`): the HBM window a DMA reads, the VMEM slice it
  writes, the output block a step writes back.  Boxes support exact
  element counts and overlap tests, which is all the hazard and
  contract rules need (conv windows, GeMM tiles and KV pages are all
  boxes; scattered sets are handled by the bitmask ledger in
  :mod:`repro_torch.analysis.verifier`).

* **events** — a linear happens-before trace of the kernel's manual
  DMA pipeline (:class:`DmaStart`/:class:`DmaWait` on named semaphores,
  :class:`BufRead`/:class:`BufWrite` for compute-side accesses).  Grid
  steps execute sequentially on a TPU core, so program order *is* the
  happens-before order for issued operations; a DMA's effect (writing
  its destination, reading its source) is only ordered by the
  ``DmaWait`` that retires it.  :func:`hazard_scan` replays the trace
  under semaphore FIFO semantics and reports every access that races an
  in-flight DMA (RAW/WAR/WAW), every wait with no outstanding transfer
  (a lost-wait deadlock) and every transfer never retired (a leaked
  signal that desynchronises later waits).

:func:`timed_delivery_violations` is the *timed* variant used for
``overlap=True`` multi-chip halo schedules: there the consumer never
waits (that is the point of overlapping), so soundness is a timing
proof — every read of an in-flight transfer's destination must start
after the transfer completes.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Iterable, Sequence, Union

_ABS = 1e-6


# --------------------------------------------------------------------- #
# Regions
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Region:
    """A rectangular box over a named tensor or buffer.

    ``box`` is a tuple of half-open ``(lo, hi)`` intervals, one per axis.
    Two regions can only overlap when they name the same tensor.
    """

    tensor: str
    box: tuple[tuple[int, int], ...]

    def __post_init__(self) -> None:
        for lo, hi in self.box:
            if hi < lo:
                raise ValueError(f"empty axis interval ({lo}, {hi}) in "
                                 f"region of {self.tensor!r}")

    @property
    def elements(self) -> int:
        n = 1
        for lo, hi in self.box:
            n *= hi - lo
        return n

    def overlaps(self, other: "Region") -> bool:
        if self.tensor != other.tensor or len(self.box) != len(other.box):
            return False
        return all(lo < ohi and olo < hi
                   for (lo, hi), (olo, ohi) in zip(self.box, other.box))

    def contains(self, other: "Region") -> bool:
        if self.tensor != other.tensor or len(self.box) != len(other.box):
            return False
        return all(lo <= olo and ohi <= hi
                   for (lo, hi), (olo, ohi) in zip(self.box, other.box))

    def describe(self) -> str:
        spans = ",".join(f"{lo}:{hi}" for lo, hi in self.box)
        return f"{self.tensor}[{spans}]"


def box_region(tensor: str, *spans: tuple[int, int]) -> Region:
    """Convenience constructor: ``box_region("x", (0, 4), (2, 8))``."""
    return Region(tensor, tuple(spans))


# --------------------------------------------------------------------- #
# Happens-before events
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class DmaStart:
    """``make_async_copy(src, dst, sem).start()`` at grid step ``step``."""

    sem: str
    src: Region
    dst: Region
    step: int
    tag: str = ""               # human label ("win full", "col prefetch")


@dataclasses.dataclass(frozen=True)
class DmaWait:
    """``.wait()`` on ``sem`` — retires the oldest outstanding start."""

    sem: str
    step: int


@dataclasses.dataclass(frozen=True)
class BufRead:
    """Compute-side read of a buffer region (im2col, dot operand)."""

    region: Region
    step: int


@dataclasses.dataclass(frozen=True)
class BufWrite:
    """Compute-side write of a buffer region (shift, output store)."""

    region: Region
    step: int


Event = Union[DmaStart, DmaWait, BufRead, BufWrite]


@dataclasses.dataclass(frozen=True)
class Hazard:
    """One happens-before violation found by :func:`hazard_scan`."""

    kind: str                   # "raw" | "war" | "waw" | "lost-wait" | "leak"
    step: int                   # grid step of the violating event
    detail: str

    def describe(self) -> str:
        return f"[step {self.step}] {self.kind}: {self.detail}"


def hazard_scan(events: Iterable[Event]) -> list[Hazard]:
    """Replay a kernel's event trace under semaphore FIFO semantics.

    A started DMA is *in flight* (asynchronously writing ``dst`` and
    reading ``src``) until a ``DmaWait`` on its semaphore retires it —
    waits retire starts oldest-first, matching the hardware's counting
    semantics for the one-transfer-per-wait idiom the kernels use.
    Any program-ordered access that touches an in-flight transfer's
    destination (or overwrites its source) is unordered with the DMA
    engine and reported as a hazard.
    """
    hazards: list[Hazard] = []
    outstanding: dict[str, deque[DmaStart]] = {}
    in_flight: list[DmaStart] = []

    def _conflicts(region: Region, write: bool, step: int,
                   what: str) -> None:
        for d in in_flight:
            if region.overlaps(d.dst):
                kind = "waw" if write else "raw"
                hazards.append(Hazard(
                    kind, step,
                    f"{what} {region.describe()} while DMA "
                    f"{d.tag or d.sem} (started step {d.step}) is still "
                    f"writing {d.dst.describe()} — missing wait"))
            elif write and region.overlaps(d.src):
                hazards.append(Hazard(
                    "war", step,
                    f"{what} {region.describe()} while DMA "
                    f"{d.tag or d.sem} (started step {d.step}) still "
                    f"reads {d.src.describe()}"))

    for ev in events:
        if isinstance(ev, DmaStart):
            _conflicts(ev.dst, write=True, step=ev.step,
                       what=f"DMA {ev.tag or ev.sem} writes")
            # a start whose *source* is being written by an in-flight DMA
            for d in in_flight:
                if ev.src.overlaps(d.dst):
                    hazards.append(Hazard(
                        "raw", ev.step,
                        f"DMA {ev.tag or ev.sem} reads "
                        f"{ev.src.describe()} while DMA {d.tag or d.sem} "
                        f"is still writing {d.dst.describe()}"))
            outstanding.setdefault(ev.sem, deque()).append(ev)
            in_flight.append(ev)
        elif isinstance(ev, DmaWait):
            queue = outstanding.get(ev.sem)
            if not queue:
                hazards.append(Hazard(
                    "lost-wait", ev.step,
                    f"wait on semaphore {ev.sem!r} with no outstanding "
                    f"transfer — the kernel deadlocks here"))
                continue
            done = queue.popleft()
            in_flight.remove(done)
        elif isinstance(ev, BufRead):
            _conflicts(ev.region, write=False, step=ev.step, what="read of")
        elif isinstance(ev, BufWrite):
            _conflicts(ev.region, write=True, step=ev.step, what="write of")
        else:                                        # pragma: no cover
            raise TypeError(f"unknown event {ev!r}")

    for d in in_flight:
        hazards.append(Hazard(
            "leak", d.step,
            f"DMA {d.tag or d.sem} (started step {d.step}) is never "
            f"waited on — its completion signal desynchronises any later "
            f"wait on {d.sem!r}"))
    return hazards


# --------------------------------------------------------------------- #
# Timed delivery (overlapped transfers that are never waited on)
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class TimedViolation:
    """A read that starts before the transfer feeding it completes."""

    read_time: float
    complete_time: float
    region: Region


def timed_delivery_violations(
        transfers: Sequence[tuple[float, Region]],
        reads: Sequence[tuple[float, Region]],
) -> list[TimedViolation]:
    """Soundness of *overlapped* (wait-free) transfers, by timing.

    ``transfers`` are ``(complete_time, dst_region)`` pairs — e.g. the
    inbound halo exchange of an ``overlap=True`` multi-chip stage, which
    completes at ``ici_duration`` after stage start.  ``reads`` are
    ``(start_time, region)`` pairs from the consumer's step walk.  A read
    overlapping a transfer's destination must start at or after the
    transfer's completion; everything earlier is returned, earliest
    first.  An empty result is a proof that the overlap claim is sound
    under the plan's own step timing.
    """
    found: list[TimedViolation] = []
    for t_read, region in reads:
        for t_done, dst in transfers:
            if region.overlaps(dst) and t_read + _ABS < t_done:
                found.append(TimedViolation(t_read, t_done, region))
                break
    found.sort(key=lambda v: v.read_time)
    return found


def first_violation_or_none(
        transfers: Sequence[tuple[float, Region]],
        reads: Sequence[tuple[float, Region]],
) -> "TimedViolation | None":
    vs = timed_delivery_violations(transfers, reads)
    return vs[0] if vs else None


def total_order_ok(times: Sequence[float]) -> bool:
    """True when a step-time sequence is sane (monotone, finite)."""
    prev = -math.inf
    for t in times:
        if not math.isfinite(t) or t + _ABS < prev:
            return False
        prev = t
    return True
