"""The shared timeline-event model.

One vocabulary for every duration producer in the repo: a
:class:`Timeline` holds :class:`Span`\\ s on per-chip *lanes* and
:class:`CounterSample`\\ s.  Lanes mirror the Def-3 action order within a
step — a3 write-backs drain first, then a4/a5 DMA loads, then the a6
accelerator trigger — so a step occupies ``[t, t + step_duration)`` with
its ``write_back`` / ``dma_in`` / ``compute`` spans laid back-to-back in
that order and the invariant

    write_dur + load_dur + compute_dur == Def-3 step_duration

holds exactly (:func:`decompose_step` mirrors the weighted write-back
accounting of ``analysis.verifier._out_weights``: S1 output units are
patches — one spatial write each, ``c_out`` elements; S2 units are
(patch, kernel-group) cells — writes and elements both count the group's
kernels, cf. ``sim.s2.run_s2``).

Element attribution follows the simulators' DRAM counters exactly:
``dma_in`` elements are channel-expanded (``|I_slice| * C_in +
|K_sub| * kelem``), ``write_back`` elements are ``c_out`` per patch (S1)
or one per (patch, kernel) cell (S2) — so predicted-vs-simulated element
drift is an integer and zero means *exactly* reconciled.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import Step

#: Lane vocabulary, in intra-step execution order (``ici`` is the
#: inter-chip interconnect lane of multichip stages; single-chip
#: timelines simply never populate it).  ``fault`` and ``recovery`` are
#: the resilience lanes (fault injection): ``fault`` spans cover wasted
#: work — a dead chip's in-flight stage, heartbeat detection latency,
#: DMA retry backoff — and ``recovery`` spans cover the repair — tail
#: re-planning and recovery-point restaging.  Fault-free timelines
#: simply never populate either.
LANES = ("dma_in", "compute", "write_back", "ici", "fault", "recovery")


@dataclasses.dataclass(frozen=True)
class Span:
    """One timed interval on a (chip, lane)."""

    name: str
    lane: str
    chip: int
    t0: float
    dur: float
    layer: int | None = None
    step: int | None = None
    elements: int = 0            # DRAM/ICI elements moved (0 for compute)
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def t1(self) -> float:
        return self.t0 + self.dur


@dataclasses.dataclass(frozen=True)
class CounterSample:
    """One sample of a monotone or gauge counter on a chip."""

    name: str
    chip: int
    t: float
    value: float


@dataclasses.dataclass(frozen=True)
class StepLanes:
    """The Def-3 lane decomposition of one step (see module note)."""

    write_dur: float
    write_elements: int
    load_dur: float
    load_elements: int
    compute_dur: float
    macs: int

    @property
    def total_dur(self) -> float:
        return self.write_dur + self.load_dur + self.compute_dur


def decompose_step(step: Step, spec: ConvSpec, hw: HardwareModel,
                   kernel_groups: "tuple[tuple[int, ...], ...] | None" = None,
                   ) -> StepLanes:
    """Split one step's Def-3 duration across the three on-chip lanes.

    ``kernel_groups`` marks an S2 schedule: the step's ``w`` mask indexes
    (patch, kernel-group) units and each written unit drains (and costs
    ``t_w`` for) one element per kernel of its group — the exact
    accounting of ``sim.s2.run_s2`` and ``analysis.verifier``.
    """
    kelem = spec.c_in * spec.h_k * spec.w_k
    n_pix = step.i_slice.bit_count()
    n_ker = step.k_sub.bit_count()
    load_dur = (n_pix + n_ker * kelem) * hw.t_l
    load_elements = n_pix * spec.c_in + n_ker * kelem

    if kernel_groups is None:
        wb_units = step.w.bit_count()
        write_dur = wb_units * hw.t_w
        write_elements = wb_units * spec.c_out
    else:
        g_count = len(kernel_groups)
        cells = 0
        mask = step.w
        while mask:
            low = mask & -mask
            unit = low.bit_length() - 1
            cells += len(kernel_groups[unit % g_count])
            mask ^= low
        write_dur = cells * hw.t_w
        write_elements = cells

    if step.computes:
        n_k = len(step.kernel_group) if step.kernel_group is not None \
            else spec.c_out
        compute_dur = hw.t_acc
        macs = len(step.group) * spec.nb_op_value * n_k
    else:
        compute_dur = 0.0
        macs = 0
    return StepLanes(write_dur=write_dur, write_elements=write_elements,
                     load_dur=load_dur, load_elements=load_elements,
                     compute_dur=compute_dur, macs=macs)


class Timeline:
    """An append-only collection of spans and counters, with the query
    surface the drift report and the invariant tests are built on."""

    def __init__(self, label: str):
        self.label = label
        self.spans: list[Span] = []
        self.counters: list[CounterSample] = []

    # -- construction -------------------------------------------------- #

    def add_span(self, name: str, lane: str, chip: int, t0: float,
                 dur: float, *, layer: int | None = None,
                 step: int | None = None, elements: int = 0,
                 **attrs: Any) -> Span | None:
        """Append a span; zero-duration zero-element spans are dropped
        (a step with nothing to write emits no ``write_back`` span)."""
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r} (have {LANES})")
        if dur < 0:
            raise ValueError(f"negative span duration {dur} ({name})")
        if dur == 0 and elements == 0:
            return None
        span = Span(name=name, lane=lane, chip=chip, t0=t0, dur=dur,
                    layer=layer, step=step, elements=elements, attrs=attrs)
        self.spans.append(span)
        return span

    def add_counter(self, name: str, chip: int, t: float,
                    value: float) -> None:
        self.counters.append(CounterSample(name=name, chip=chip, t=t,
                                           value=value))

    def add_step(self, step: Step, spec: ConvSpec, hw: HardwareModel, *,
                 chip: int, layer: int | None, index: int, t0: float,
                 kernel_groups: "tuple[tuple[int, ...], ...] | None" = None,
                 ) -> float:
        """Emit one Def-3 step as its lane spans (a3 -> a4/a5 -> a6
        order, back-to-back) and return the step's end time."""
        lanes = decompose_step(step, spec, hw, kernel_groups)
        t = t0
        self.add_span(f"L{layer} s{index} wb", "write_back", chip, t,
                      lanes.write_dur, layer=layer, step=index,
                      elements=lanes.write_elements, w=step.w)
        t += lanes.write_dur
        self.add_span(f"L{layer} s{index} dma", "dma_in", chip, t,
                      lanes.load_dur, layer=layer, step=index,
                      elements=lanes.load_elements, i_slice=step.i_slice,
                      k_sub=step.k_sub)
        t += lanes.load_dur
        self.add_span(f"L{layer} s{index} acc", "compute", chip, t,
                      lanes.compute_dur, layer=layer, step=index,
                      group=step.group, macs=lanes.macs)
        return t + lanes.compute_dur

    # -- queries -------------------------------------------------------- #

    @property
    def end_time(self) -> float:
        return max((s.t1 for s in self.spans), default=0.0)

    def chips(self) -> list[int]:
        return sorted({s.chip for s in self.spans})

    def lanes_of(self, chip: int) -> set[str]:
        return {s.lane for s in self.spans if s.chip == chip}

    def layers(self) -> list[int]:
        return sorted({s.layer for s in self.spans if s.layer is not None})

    def select(self, *, layer: int | None = None, chip: int | None = None,
               lane: str | None = None) -> list[Span]:
        return [s for s in self.spans
                if (layer is None or s.layer == layer)
                and (chip is None or s.chip == chip)
                and (lane is None or s.lane == lane)]

    def span_sum(self, *, layer: int | None = None,
                 chip: int | None = None,
                 lane: str | None = None) -> float:
        return sum(s.dur for s in self.select(layer=layer, chip=chip,
                                              lane=lane))

    def element_sum(self, *, layer: int | None = None,
                    chip: int | None = None,
                    lane: str | None = None) -> int:
        return sum(s.elements for s in self.select(layer=layer, chip=chip,
                                                   lane=lane))

    def overlap_violations(self, tol: float = 1e-9) -> list[str]:
        """Spans on one (chip, lane) must never overlap — each lane is a
        serial resource.  Returns human-readable violations (empty ==
        invariant holds)."""
        out: list[str] = []
        by_lane: dict[tuple[int, str], list[Span]] = {}
        for s in self.spans:
            by_lane.setdefault((s.chip, s.lane), []).append(s)
        for (chip, lane), spans in sorted(by_lane.items()):
            spans = sorted(spans, key=lambda s: (s.t0, s.t1))
            for prev, cur in zip(spans, spans[1:]):
                if cur.t0 < prev.t1 - tol:
                    out.append(
                        f"{self.label}: chip{chip}/{lane}: "
                        f"{cur.name!r} starts at {cur.t0:g} before "
                        f"{prev.name!r} ends at {prev.t1:g}")
        return out

    def extend(self, spans: Iterable[Span]) -> None:
        self.spans.extend(spans)

    def __repr__(self) -> str:
        return (f"Timeline({self.label!r}, {len(self.spans)} spans, "
                f"{len(self.counters)} counters, end={self.end_time:g})")
