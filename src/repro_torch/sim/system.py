"""System orchestrator (paper Sec 6, Fig 10).

At each step the system 1) reads the current step from the strategy, 2) frees
the unnecessary elements in the on-chip memory, 3) writes the results to the
DRAM, 4) loads the necessary elements from DRAM to on-chip memory,
5) triggers the accelerator, 6) loops.  Alongside the functional execution it
re-runs the *formal* semantics (`repro_torch.core.formalism`) and asserts both
agree on the memory state at every step."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import MemoryState, Step, apply_step
from repro_torch.core.strategies import GroupedStrategy
from repro_torch.sim.accelerator import Accelerator
from repro_torch.sim.dram import Dram
from repro_torch.sim.functional import reference_conv
from repro_torch.sim.layer import ConvLayer
from repro_torch.sim.trace import StepTrace


class StateMismatchError(RuntimeError):
    """Formal step semantics (Def 2) disagreed with the functional memory
    model mid-run — always a simulator or strategy-lowering bug."""


@dataclasses.dataclass
class SimReport:
    output: np.ndarray
    correct: bool
    max_abs_err: float
    total_duration: float
    peak_footprint: int
    elements_read: int
    elements_written: int
    total_macs: int
    traces: list[StepTrace]
    retry_duration: float = 0.0   # injected DMA retries (fault injection):
    retry_elements: int = 0       # included in total_duration /
    #   elements_read; zero on every fault-free run

    def summary(self) -> str:
        return (f"steps={len(self.traces)} duration={self.total_duration:g} "
                f"peak_mem={self.peak_footprint} "
                f"dram_rd={self.elements_read} dram_wr={self.elements_written} "
                f"macs={self.total_macs} correct={self.correct} "
                f"(max_err={self.max_abs_err:.2e})")


class System:
    """Executes a strategy (user-defined or solver-produced) functionally."""

    def __init__(self, layer: ConvLayer, hw: HardwareModel):
        self.layer = layer
        self.hw = hw

    def run(self, strategy: GroupedStrategy | list[Step],
            check: bool = True,
            retry_at: "dict[int, int] | None" = None,
            backoff_base: float = 16.0) -> SimReport:
        """Execute the strategy step by step.

        ``retry_at`` injects transient DMA failures (fault injection):
        step index -> number of failed attempts before the load
        succeeds.  Each retry re-issues the step's DRAM reads (reads are
        idempotent — the fetched values are identical, so the output is
        unchanged) and waits ``backoff_base * 2**(attempt-1)`` cycles;
        the extra duration and re-read elements are recorded on the
        step's trace and in ``SimReport.retry_duration`` /
        ``retry_elements``, on top of the fault-free Def-3 ledger.
        """
        spec = self.layer.spec
        steps = (strategy.to_steps()
                 if isinstance(strategy, GroupedStrategy) else strategy)
        retry_at = retry_at or {}
        dram = Dram(self.layer)
        acc = Accelerator(spec, self.hw)
        formal = MemoryState()
        traces: list[StepTrace] = []
        total_duration = 0.0
        peak = 0
        for idx, s in enumerate(steps):
            read0, written0 = dram.elements_read, dram.elements_written
            # 2) free
            acc.mem.free_pixels(spec.pixels_of_mask(s.f_inp))
            acc.mem.free_kernels(spec.pixels_of_mask(s.f_ker))
            # 3) write back
            n_wb = 0
            for pid, vals in acc.mem.pop_outputs(
                    spec.pixels_of_mask(s.w)).items():
                dram.write_output(pid, vals)
                n_wb += 1
            # 4) load
            n_pix = n_ker = 0
            for j in spec.pixels_of_mask(s.i_slice):
                h, w = spec.pixel_pos(j)
                acc.mem.store_pixel(j, dram.read_pixel(h, w))
                n_pix += 1
            for k in spec.pixels_of_mask(s.k_sub):
                acc.mem.store_kernel(k, dram.read_kernel(k))
                n_ker += 1
            peak = max(peak, acc.mem.used)
            acc.mem.check_capacity()
            # 5) compute
            if s.computes:
                acc.compute(s.group)
                peak = max(peak, acc.mem.used)
                acc.mem.check_capacity()
            # formal semantics must agree with the functional memory state
            formal = apply_step(formal, s)
            if set(spec.pixels_of_mask(formal.inp)) != set(acc.mem.pixels):
                raise StateMismatchError(f"step {idx}: input state mismatch")
            if set(spec.pixels_of_mask(formal.ker)) != set(acc.mem.kernels):
                raise StateMismatchError(f"step {idx}: kernel state mismatch")
            if set(spec.pixels_of_mask(formal.out)) != set(acc.mem.outputs):
                raise StateMismatchError(f"step {idx}: output state mismatch")
            # measured lane breakdown (Def-3 a3 -> a4/a5 -> a6), counted
            # from what the system actually did — NOT recomputed from the
            # plan, so the obs drift report compares independent numbers
            kelem = spec.c_in * spec.h_k * spec.w_k
            write_dur = n_wb * self.hw.t_w
            load_dur = (n_pix + n_ker * kelem) * self.hw.t_l
            acc_dur = self.hw.t_acc if s.computes else 0.0
            # injected transient DMA failures: re-issue this step's reads
            # (idempotent — values discarded, the resident copies stand)
            # and pay exponential backoff per failed attempt
            n_retries = retry_at.get(idx, 0)
            retry_dur = 0.0
            retry_read0 = dram.elements_read
            for attempt in range(1, n_retries + 1):
                for j in spec.pixels_of_mask(s.i_slice):
                    h, w = spec.pixel_pos(j)
                    dram.read_pixel(h, w)
                for k in spec.pixels_of_mask(s.k_sub):
                    dram.read_kernel(k)
                retry_dur += load_dur + backoff_base * 2 ** (attempt - 1)
            retry_elems = dram.elements_read - retry_read0
            total_duration += write_dur + load_dur + acc_dur + retry_dur
            traces.append(StepTrace(
                index=idx, step=s, mem_elements=acc.mem.used,
                duration=write_dur + load_dur + acc_dur + retry_dur,
                load_duration=load_dur, write_duration=write_dur,
                compute_duration=acc_dur,
                read_elements=dram.elements_read - read0,
                written_elements=dram.elements_written - written0,
                retries=n_retries, retry_duration=retry_dur,
                retry_elements=retry_elems))

        max_err = 0.0
        ok = True
        if check:
            ref = reference_conv(self.layer)
            if np.any(np.isnan(dram.output)):
                ok = False
                max_err = float("nan")
            else:
                max_err = float(np.max(np.abs(dram.output - ref)))
                ok = bool(np.allclose(dram.output, ref, rtol=1e-4,
                                      atol=1e-4))
        return SimReport(
            output=dram.output, correct=ok, max_abs_err=max_err,
            total_duration=total_duration,
            peak_footprint=peak,
            elements_read=dram.elements_read,
            elements_written=dram.elements_written,
            total_macs=acc.total_macs,
            traces=traces,
            retry_duration=sum(t.retry_duration for t in traces),
            retry_elements=sum(t.retry_elements for t in traces))
