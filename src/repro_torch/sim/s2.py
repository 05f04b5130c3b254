"""Functional executor for S2 strategies (kernel-subset steps).

Outputs are per-(patch, kernel) scalars accumulated in a DRAM output
buffer; the final tensor must equal the reference convolution exactly —
the same functional-simulation contract as the S1 System, at the finer
granularity."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.strategies_s2 import S2Strategy
from repro_torch.sim.functional import reference_conv
from repro_torch.sim.layer import ConvLayer
from repro_torch.sim.trace import StepTrace


@dataclasses.dataclass
class S2Report:
    output: np.ndarray
    correct: bool
    max_abs_err: float
    total_duration: float
    peak_memory: int
    elements_read: int
    elements_written: int
    kernel_loads: int         # total kernel fetch events (reload pressure)
    total_macs: int = 0
    traces: list[StepTrace] = dataclasses.field(default_factory=list)
    #   measured per-step lane breakdown, aligned 1:1 with the
    #   strategy's to_steps() (schedule iterations + terminal flush)


def run_s2(layer: ConvLayer, hw: HardwareModel,
           strategy: S2Strategy) -> S2Report:
    spec = layer.spec
    if not (spec is strategy.spec or spec == strategy.spec):
        raise ValueError("strategy spec does not match layer spec")
    kelem = spec.c_in * spec.h_k * spec.w_k
    out = np.full((spec.c_out, spec.h_out, spec.w_out), np.nan, np.float32)
    written = np.zeros((spec.c_out, spec.h_out, spec.w_out), bool)

    pixels: dict[int, np.ndarray] = {}
    kernels: dict[int, np.ndarray] = {}
    pending: dict[tuple[int, int], float] = {}   # (pid, kid) -> value
    reads = writes = kernel_loads = total_macs = 0
    duration = 0.0
    peak = 0
    # formal step view of the same schedule, for the per-step trace
    # ledger (to_steps() is the Def-16 lowering the planner prices)
    steps = strategy.to_steps()
    traces: list[StepTrace] = []

    def write_back(cells):
        nonlocal writes
        for (pid, kid), val in cells.items():
            i, j = spec.patch_pos(pid)
            if written[kid, i, j]:
                raise RuntimeError(f"output {(pid, kid)} written twice")
            out[kid, i, j] = val
            written[kid, i, j] = True
            writes += 1

    for step_idx, (g, kg) in enumerate(strategy.schedule):
        kids = strategy.kernel_groups[kg]
        need_pix = set(spec.pixels_of_mask(spec.group_mask(g)))
        # a1/a2: eager frees
        for j in list(pixels):
            if j not in need_pix:
                del pixels[j]
        for kid in list(kernels):
            if kid not in kids:
                del kernels[kid]
        # a3: write back the previous step's cells
        write_back(pending)
        dur_w = len(pending) * hw.t_w
        n_cells_written = len(pending)
        pending = {}
        # a4/a5: loads
        n_pix_loads = 0
        for j in need_pix:
            if j not in pixels:
                h, w = spec.pixel_pos(j)
                pixels[j] = layer.input[:, h, w]
                reads += spec.c_in
                n_pix_loads += 1
        n_ker_loads = 0
        for kid in kids:
            if kid not in kernels:
                kernels[kid] = layer.kernels[kid]
                reads += kelem
                n_ker_loads += 1
                kernel_loads += 1
        # a6: compute the (patch x kernel-subset) cells
        macs = len(g) * spec.nb_op_value * len(kids)
        if macs > hw.nbop_pe:
            raise RuntimeError(f"PE overrun: {macs} > {hw.nbop_pe}")
        total_macs += macs
        for pid in g:
            h0, w0, h1, w1 = spec.patch_bbox(pid)
            patch = np.stack([pixels[spec.pixel_id(h, w)]
                              for h in range(h0, h1)
                              for w in range(w0, w1)], axis=1)
            patch = patch.reshape(spec.c_in, spec.h_k, spec.w_k)
            for kid in kids:
                pending[(pid, kid)] = float(
                    np.einsum("chw,chw->", kernels[kid], patch))
        used = (len(pixels) * spec.c_in + len(kernels) * kelem
                + len(pending))
        if hw.size_mem is not None and used > hw.size_mem:
            raise MemoryError(f"on-chip overflow: {used} > {hw.size_mem}")
        peak = max(peak, used)
        dur_l = (n_pix_loads + n_ker_loads * kelem) * hw.t_l
        duration += dur_l + dur_w + hw.t_acc
        traces.append(StepTrace(
            index=step_idx, step=steps[step_idx], mem_elements=used,
            duration=dur_l + dur_w + hw.t_acc,
            load_duration=dur_l, write_duration=dur_w,
            compute_duration=hw.t_acc,
            read_elements=n_pix_loads * spec.c_in + n_ker_loads * kelem,
            written_elements=n_cells_written))
    write_back(pending)
    flush_dur = len(pending) * hw.t_w
    duration += flush_dur
    traces.append(StepTrace(
        index=len(strategy.schedule), step=steps[-1], mem_elements=0,
        duration=flush_dur, write_duration=flush_dur,
        written_elements=len(pending)))

    ref = reference_conv(layer)
    ok = bool(written.all()) and bool(
        np.allclose(out, ref, rtol=1e-4, atol=1e-4))
    err = float(np.max(np.abs(out - ref))) if written.all() else float("nan")
    return S2Report(output=out, correct=ok, max_abs_err=err,
                    total_duration=duration, peak_memory=peak,
                    elements_read=reads, elements_written=writes,
                    kernel_loads=kernel_loads, total_macs=total_macs,
                    traces=traces)
