"""The offloading formalism (paper Sec 2.2, Defs 1-3).

An n-step computation ``S = (s_1 .. s_n)`` where each step

    s_i = (F_inp, F_ker, W, I_slice, K_sub)

is executed as the action sequence a1..a6:

    a1  Mt_inp = M_{i-1}.inp \\ F_inp        (free input parts)
    a2  Mt_ker = M_{i-1}.ker \\ F_ker        (free kernel parts)
    a3  Mt_out = M_{i-1}.out \\ W            (write results back to DRAM)
    a4  M_i.inp = Mt_inp | I_slice           (load input slice)
    a5  M_i.ker = Mt_ker | K_sub             (load kernel subset)
    a6  M_i.out = Mt_out | Out_i             (compute, result stays on-chip)

All sets are int bitmasks (see conv_spec):
  * input pixels   — spatial pixel ids over the H_in x W_in grid,
  * kernels        — kernel ids 0..N-1,
  * outputs        — output spatial positions == patch ids 0..|X|-1.

Durations follow Def 3 with the unit convention of cost_model.py.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel


@dataclasses.dataclass(frozen=True)
class MemoryState:
    """On-chip memory state M_i = [M_inp, M_ker, M_out] (bitmasks)."""

    inp: int = 0
    ker: int = 0
    out: int = 0

    @property
    def empty(self) -> bool:
        return self.inp == 0 and self.ker == 0 and self.out == 0

    def footprint_elements(self, spec: ConvSpec) -> int:
        """Tensor elements resident (channels expanded)."""
        return (self.inp.bit_count() * spec.c_in
                + self.ker.bit_count() * spec.c_in * spec.h_k * spec.w_k
                + self.out.bit_count() * spec.c_out)


@dataclasses.dataclass(frozen=True)
class Step:
    """One step s_i = (F_inp, F_ker, W, I_slice, K_sub) + its computation.

    ``out`` is Out_i — the output units computed by a6 (empty for a pure
    flush step).  ``group`` records the patch ids computed, for tracing.
    ``kernel_group`` is None for S1-family steps (Property 1: all kernels
    resident, all output channels computed); an S2-family step (paper
    Sec 9 future work, implemented in core/strategies_s2.py) names the
    kernel subset it consumes, and ``out`` ids are then
    (patch, kernel-group) units rather than patches.
    """

    f_inp: int = 0
    f_ker: int = 0
    w: int = 0
    i_slice: int = 0
    k_sub: int = 0
    out: int = 0
    group: tuple[int, ...] = ()
    kernel_group: tuple[int, ...] | None = None

    @property
    def computes(self) -> bool:
        return self.out != 0


class StepError(ValueError):
    """A step violates the semantics or an assumption of Sec 2.3."""


def apply_step(m: MemoryState, s: Step) -> MemoryState:
    """Execute actions a1..a6 of Def 2, with validity checks."""
    if s.f_inp & ~m.inp:
        raise StepError("a1: freeing input pixels not in on-chip memory")
    if s.f_ker & ~m.ker:
        raise StepError("a2: freeing kernels not in on-chip memory")
    if s.w & ~m.out:
        raise StepError("a3: writing back outputs not in on-chip memory")
    mt_inp = m.inp & ~s.f_inp
    mt_ker = m.ker & ~s.f_ker
    mt_out = m.out & ~s.w
    if s.i_slice & mt_inp:
        raise StepError("a4: re-loading pixels already resident (wasteful)")
    if s.k_sub & mt_ker:
        raise StepError("a5: re-loading kernels already resident")
    if s.out & mt_out:
        raise StepError("a6: recomputing outputs still resident")
    return MemoryState(inp=mt_inp | s.i_slice,
                       ker=mt_ker | s.k_sub,
                       out=mt_out | s.out)


def check_compute_feasible(s: Step, spec: ConvSpec, hw: HardwareModel,
                           mem_after_loads: MemoryState) -> None:
    """Assumptions of Sec 2.3 for a computing step.

    * compute fits the PE: MACs of the step <= nbop_pe;
    * loaded data is directly processed: every loaded pixel belongs to a
      patch of the step's group, every computed patch's pixels are resident.
    """
    if not s.computes:
        return
    n_ker = len(s.kernel_group) if s.kernel_group is not None \
        else spec.c_out
    macs = len(s.group) * spec.nb_op_value * n_ker
    if macs > hw.nbop_pe:
        raise StepError(
            f"step computes {macs} MACs > nbop_pe={hw.nbop_pe}")
    need = spec.group_mask(s.group)
    if s.i_slice & ~need:
        raise StepError("loaded pixels not consumed by this step's group")
    if need & ~mem_after_loads.inp:
        raise StepError("computing a patch whose pixels are not resident")
    if s.kernel_group is None:
        if mem_after_loads.ker.bit_count() != spec.n_kernels:
            # S1 (Property 1): all output channels -> all kernels resident.
            raise StepError("S1 compute requires all kernels resident")
        want_out = 0
        for pid in s.group:
            want_out |= 1 << pid
        if s.out != want_out:
            raise StepError("Out_i does not match the step's patch group")
    else:
        kmask = 0
        for kid in s.kernel_group:
            kmask |= 1 << kid
        if kmask & ~mem_after_loads.ker:
            raise StepError("S2 compute requires its kernel subset resident")


def step_duration(s: Step, spec: ConvSpec, hw: HardwareModel) -> float:
    """Def 3:  (|I_slice| + |K_sub|) * t_l + |W| * t_w + t_acc.

    I_slice and W are counted in spatial units (Example 2 convention);
    K_sub in kernel elements (a kernel is C_in*H_K*W_K elements).
    t_acc is charged only when the step computes (a terminal flush step
    performs no a6).
    """
    load = s.i_slice.bit_count() * hw.t_l
    load += s.k_sub.bit_count() * spec.c_in * spec.h_k * spec.w_k * hw.t_l
    write = s.w.bit_count() * hw.t_w
    return load + write + (hw.t_acc if s.computes else 0.0)


@dataclasses.dataclass
class RunResult:
    """Trace of executing an n-step computation."""

    states: list[MemoryState]
    durations: list[float]
    footprints: list[int]        # size_i^step of Def 3, in elements
    total_duration: float
    peak_footprint: int
    loads_per_pixel: dict[int, int]   # pixel id -> times loaded (reload bound)


def run_steps(steps: Sequence[Step], spec: ConvSpec, hw: HardwareModel,
              validate: bool = True) -> RunResult:
    """Execute the semantics over a full strategy; check global invariants:

    * memory empty after the last step, all outputs written back exactly once;
    * every patch computed exactly once;
    * reload bound (Sec 2.3): each pixel loaded at most ``nb_data_reload``
      times is *reported*, enforcement is the ILP's job.
    """
    m = MemoryState()
    states, durations, footprints = [], [], []
    loads: dict[int, int] = {}
    computed = 0
    written = 0
    for s in steps:
        # size_i^step (Def 3): footprint *during* the step, before frees of
        # the next step — union of carried data and newly loaded/computed.
        during = MemoryState(inp=(m.inp & ~s.f_inp) | s.i_slice | m.inp,
                             ker=(m.ker & ~s.f_ker) | s.k_sub | m.ker,
                             out=(m.out & ~s.w) | s.out | m.out)
        m_next = apply_step(m, s)
        if validate:
            check_compute_feasible(s, spec, hw, m_next)
        for j in spec.pixels_of_mask(s.i_slice):
            loads[j] = loads.get(j, 0) + 1
        if validate and (s.out & computed):
            raise StepError("a patch computed twice")
        computed |= s.out
        written |= s.w
        states.append(m_next)
        durations.append(step_duration(s, spec, hw))
        footprints.append(during.footprint_elements(spec))
        m = m_next
    if validate:
        full = (1 << spec.num_patches) - 1
        if computed != full:
            missing = full & ~computed
            raise StepError(
                f"strategy incomplete: {missing.bit_count()} patches never computed")
        if not m.empty:
            raise StepError("on-chip memory not empty after the last step")
        if written != full:
            raise StepError("not all outputs written back to DRAM")
    return RunResult(states=states, durations=durations,
                     footprints=footprints,
                     total_duration=sum(durations),
                     peak_footprint=max(footprints) if footprints else 0,
                     loads_per_pixel=loads)
