"""Offloading-schedule planner: the paper's formalism applied to the tiling
of the port's CUDA kernels.

The paper's strategy model — steps that (free, write-back, load
I_slice/K_sub, compute) against an on-chip memory of size ``size_MEM`` —
maps onto a CUDA kernel as:

    on-chip memory  = the shared memory one thread block can use
    a step          = one grid step (K2: one block; K1: one loop iteration)
    I_slice/K_sub   = device-memory -> shared-memory fetches
    delta (eq. 15)  = device-memory bytes moved / bandwidth + step overheads

For an operator the planner enumerates candidate strategies, prices each
with the paper's duration model under the card's data-sheet constants
(:class:`~repro_torch.core.cost_model.GpuChipModel`), and returns the
argmin.  Only the convolution is planned here so far; the matmul and
decode-attention planners come with their kernels.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import H100_SXM, GpuChipModel
from repro_torch.core.strategies import tiled as tiled_strategy


@dataclasses.dataclass(frozen=True)
class Plan:
    """A chosen offloading schedule for one operator instance."""

    kind: str
    tiles: dict
    order: str
    steps: int
    hbm_bytes: int              # sum of I_slice/K_sub/W over all steps
    flops: int
    smem_bytes: int             # shared memory one block of the kernel uses
    duration_additive: float    # paper Def 3: loads + writes + compute
    duration_overlapped: float  # max(mem, compute)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(1, self.hbm_bytes)


def conv_simple_smem_bytes(spec: ConvSpec, t_run: int,
                           dtype_bytes: int) -> int:
    """Shared memory one block of the simple conv kernel allocates: its
    ``(C_in, H_K, t_in)`` input window and nothing else (Λ is read through
    L2, the output goes from registers to device memory).  The same
    formula as ``conv2d_offload_smem_bytes`` in
    ``kernels/csrc/conv2d_offload.cu``."""
    t_in = (t_run - 1) * spec.s_w + spec.w_k
    return spec.c_in * spec.h_k * t_in * dtype_bytes


def plan_conv(spec: ConvSpec, dtype_bytes: int = 2,
              chip: GpuChipModel = H100_SXM,
              max_run: int = 64) -> Plan:
    """Pick the row-run length T for the simple conv kernel behind
    ``ops.conv2d``: each grid step computes a (1 x T) run of output
    columns for all C_out channels.  Cost = paper eq. 15 with halo-aware
    I_slice, evaluated exactly via the strategy bitmasks; feasibility =
    the kernel's own shared-memory allocation against one block's limit
    on the card."""
    budget = chip.smem_bytes_per_block
    flops = 2 * spec.macs_total
    best: Plan | None = None
    for t in range(1, min(max_run, spec.w_out) + 1):
        smem = conv_simple_smem_bytes(spec, t, dtype_bytes)
        if smem > budget:
            continue
        strat = tiled_strategy(spec, t, tile=(1, t))
        pixels = strat.pixels_loaded()
        hbm = (pixels * spec.c_in + spec.kernel_elements
               + spec.num_patches * spec.c_out) * dtype_bytes
        steps = strat.n_steps
        t_mem = hbm / chip.hbm_bw
        t_cmp = flops / chip.peak_flops
        cand = Plan(kind="conv2d", tiles={"t": t}, order="zigzag",
                    steps=steps, hbm_bytes=hbm, flops=flops, smem_bytes=smem,
                    duration_additive=t_mem + t_cmp,
                    duration_overlapped=max(t_mem, t_cmp))
        if best is None or (cand.duration_overlapped, cand.steps) < \
                (best.duration_overlapped, best.steps):
            best = cand
    if best is None:
        raise ValueError(
            "conv does not fit one block's shared memory at any run length")
    return best
