"""Step-by-step trace + visualisation (paper Sec 6 / Fig 9), on the
shared timeline-event model of :mod:`repro_torch.obs.events`.

:class:`StepTrace` is what the functional simulators *measure* per step
— lane-decomposed durations (write-back / DMA-in / compute, the Def-3
a3 -> a4/a5 -> a6 order) and DRAM element counts — the raw material the
``repro_torch.obs`` adapters turn into timelines and the drift report
reconciles against the plan's predictions.

The ASCII renderers consume timeline *spans* (``compute`` spans carry
the step's patch group, ``dma_in`` spans its I_slice bitmask), so they
render any span source — a strategy, a simulator run, a sliced multichip
shard — and degrade gracefully on *partial* schedules: output positions
no compute span claims render as ``"?"`` padded to the same cell width
as assigned ones.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import Step
from repro_torch.core.strategies import GroupedStrategy
from repro_torch.obs.events import Span, Timeline


@dataclasses.dataclass
class StepTrace:
    """One simulated step's measured lane breakdown."""

    index: int
    step: Step
    mem_elements: int
    duration: float
    load_duration: float = 0.0
    write_duration: float = 0.0
    compute_duration: float = 0.0
    read_elements: int = 0
    written_elements: int = 0
    retries: int = 0                 # injected DMA transients
    retry_duration: float = 0.0      # re-issued loads + exponential backoff
    retry_elements: int = 0          # elements re-read by the retries

    def describe(self, spec: ConvSpec) -> str:
        s = self.step
        retry = (f" + retry {self.retry_duration:g}x{self.retries}"
                 if self.retries else "")
        return (f"step {self.index:3d}: "
                f"free_inp={s.f_inp.bit_count():3d} "
                f"free_ker={s.f_ker.bit_count():2d} "
                f"write={s.w.bit_count():3d} "
                f"load_inp={s.i_slice.bit_count():3d} "
                f"load_ker={s.k_sub.bit_count():2d} "
                f"compute={len(s.group):3d}p "
                f"mem={self.mem_elements:5d} dur={self.duration:g} "
                f"(wb {self.write_duration:g} + dma {self.load_duration:g}"
                f" + acc {self.compute_duration:g}{retry})")


# --------------------------------------------------------------------- #
# Strategy -> timeline (rendering-grade; the obs adapters build the
# fully-attributed planning/simulation timelines)
# --------------------------------------------------------------------- #

def strategy_timeline(strategy, hw: HardwareModel | None = None, *,
                      chip: int = 0, layer: int | None = None,
                      label: str | None = None) -> Timeline:
    """Lower any strategy (S1 ``GroupedStrategy`` or S2) to a timeline
    via its Def-3 step sequence.  ``hw`` defaults to the unit cost model
    (t_l = t_w = t_acc = 1), which is all the renderers need."""
    hw = hw or HardwareModel(nbop_pe=1)
    tl = Timeline(label or getattr(strategy, "name", "strategy"))
    kernel_groups = getattr(strategy, "kernel_groups", None)
    t = 0.0
    for idx, s in enumerate(strategy.to_steps()):
        t = tl.add_step(s, strategy.spec, hw, chip=chip, layer=layer,
                        index=idx, t0=t, kernel_groups=kernel_groups)
    return tl


# --------------------------------------------------------------------- #
# ASCII renderers (paper Fig 9 analogues), span-driven
# --------------------------------------------------------------------- #

def render_spans_group_grid(spans: Iterable[Span], spec: ConvSpec, *,
                            title: str) -> str:
    """Each output position labelled by the step whose ``compute`` span
    claims it; positions no span claims render ``"?"`` at the same cell
    width (partial schedules — e.g. one chip's row band of a sliced
    layer — stay legible)."""
    compute = [s for s in spans if s.lane == "compute"]
    n_steps = max((0 if s.step is None else s.step for s in compute),
                  default=0) + 1
    cell = max(2, len(str(max(1, n_steps - 1))))
    grid = [["?" for _ in range(spec.w_out)] for _ in range(spec.h_out)]
    for s in compute:
        for pid in s.attrs.get("group", ()):
            i, j = spec.patch_pos(pid)
            grid[i][j] = str(s.step if s.step is not None else "?")
    lines = [title]
    for row in grid:
        lines.append(" ".join(v.rjust(cell) for v in row))
    return "\n".join(lines)


def render_spans_input_heatmap(spans: Iterable[Span], spec: ConvSpec, *,
                               title: str) -> str:
    """Input-pixel load counts accumulated from the ``dma_in`` spans'
    I_slice masks (reload pressure visualisation)."""
    loads: dict[int, int] = {}
    for s in spans:
        if s.lane != "dma_in":
            continue
        mask = s.attrs.get("i_slice", 0)
        while mask:
            low = mask & -mask
            j = low.bit_length() - 1
            loads[j] = loads.get(j, 0) + 1
            mask ^= low
    lines = [title]
    for h in range(spec.h_in):
        lines.append(" ".join(
            str(loads.get(spec.pixel_id(h, w), 0))
            for w in range(spec.w_in)))
    return "\n".join(lines)


def render_group_grid(strategy: GroupedStrategy) -> str:
    """ASCII analogue of the paper's Fig 9: each output position labelled
    by the step (group) that computes it."""
    tl = strategy_timeline(strategy)
    return render_spans_group_grid(
        tl.spans, strategy.spec,
        title=f"strategy={strategy.name} groups={strategy.n_steps} "
              f"(output grid, value = computing step)")


def render_input_heatmap(strategy: GroupedStrategy) -> str:
    """Input-pixel load counts (reload pressure visualisation)."""
    tl = strategy_timeline(strategy)
    return render_spans_input_heatmap(
        tl.spans, strategy.spec,
        title=f"input load counts (H_in x W_in), strategy={strategy.name}")
