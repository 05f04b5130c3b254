"""Emit CUDA kernel invocations from solved offloading plans.

The bridge between the planning stack and the kernels:
:func:`emit_layer_kernel` maps an S1 :class:`~repro_torch.core.
network_planner.LayerPlan` onto :func:`~repro_torch.kernels.
conv2d_offload.conv2d_offload_planned` — grid, ``t_run`` and sweep order
are read off the solved strategy via :meth:`GroupedStrategy.as_grid`, so
the kernel's steps are, by construction, the plan's Def-3 steps in order.

``emit`` refuses anything it cannot map *exactly*:

* S2 plans (kernel-group swapping — no kernel implements swapping yet);
* strategies that are not a uniform grid sweep (tiled/hilbert groups);
* "row"-order sweeps whose windows overlap across rows: at a row turn
  the kernel would re-fetch the full window, charging more traffic than
  the plan's eager-free I_slice accounting.

The emitted kernel implements the layer's *gross* schedule (every input
pixel from device memory, every output written back); inter-layer reuse
savings are a schedule-level accounting on top and do not change the
kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.network_planner import (LayerPlan, NetworkPlan,
                                              plan_network)
from repro_torch.core.solver import SolveResult
from repro_torch.core.strategies import (
    GridMeta, GroupedStrategy, lower_bound, zigzag)
from repro_torch.kernels import KernelShapeError
from repro_torch.kernels.conv2d_offload import (conv2d_offload_planned,
                                                planned_smem_elements)


class KernelEmitError(ValueError):
    """The plan cannot be mapped onto an implemented kernel."""


def kernel_vmem_elements(spec: ConvSpec, t_run: int) -> int:
    """On-chip elements the emitted kernel actually occupies: what the one
    thread block of ``conv2d_offload_planned`` allocates in shared memory.

    That is the resident Λ, the window and the two delta buffers, and no
    output term: the CUDA kernel stages no output in shared memory (each
    thread stores its sums straight to device memory), unlike a kernel
    whose framework double-buffers its output blocks on chip.  The name is
    kept from the JAX package so that the counterpart is found by name.
    """
    return planned_smem_elements(spec.c_in, spec.c_out, spec.h_k, spec.w_k,
                                 spec.s_h, spec.s_w, t_run)


@dataclasses.dataclass(frozen=True)
class EmittedConv:
    """A LayerPlan compiled to a concrete kernel invocation."""

    spec: ConvSpec
    grid_meta: GridMeta
    layer_index: int
    vmem_elements: int

    @property
    def t_run(self) -> int:
        return self.grid_meta.t_run

    @property
    def order(self) -> str:
        return self.grid_meta.order

    def run(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Execute the plan: x (C_in, H_in, W_in), w (N, C_in, Hk, Wk).
        CUDA tensors go through the CUDA kernel, CPU tensors through its
        plain version."""
        spec = self.spec
        if tuple(x.shape) != (spec.c_in, spec.h_in, spec.w_in):
            raise KernelShapeError(
                f"layer {self.layer_index}: input {tuple(x.shape)} != plan "
                f"spec ({spec.c_in}, {spec.h_in}, {spec.w_in})")
        if tuple(w.shape) != (spec.c_out, spec.c_in, spec.h_k, spec.w_k):
            raise KernelShapeError(
                f"layer {self.layer_index}: kernels {tuple(w.shape)} != "
                f"plan spec ({spec.c_out}, {spec.c_in}, {spec.h_k}, "
                f"{spec.w_k})")
        return conv2d_offload_planned(
            x, w, t_run=self.t_run, s_h=spec.s_h, s_w=spec.s_w,
            order=self.order)


def emit_layer_kernel(lp: LayerPlan) -> EmittedConv:
    """Map an S1 LayerPlan onto ``conv2d_offload_planned``.

    Raises :class:`KernelEmitError` for plans no implemented kernel
    realises exactly (see module docstring).  The result's grid,
    ``t_run`` and order come from the solved strategy.
    """
    if lp.mode != "s1":
        raise KernelEmitError(
            f"layer {lp.index}: mode {lp.mode!r} (kernel-group swapping) "
            f"has no emitted kernel")
    strat = lp.strategy
    if not isinstance(strat, GroupedStrategy):
        raise KernelEmitError(
            f"layer {lp.index}: {type(strat).__name__} is not a grouped "
            f"S1 strategy")
    meta = strat.as_grid()
    if meta is None:
        raise KernelEmitError(
            f"layer {lp.index}: strategy {strat.name!r} is not a uniform "
            f"grid sweep — no kernel grid realises its group order")
    spec = lp.spec
    if meta.order == "row" and meta.w_out_tiles > 1 \
            and spec.h_k > spec.s_h:
        raise KernelEmitError(
            f"layer {lp.index}: row-order sweep with overlapping rows "
            f"(h_k={spec.h_k} > s_h={spec.s_h}) re-fetches the full "
            f"window at every row turn — kernel traffic would exceed "
            f"the plan's I_slice charge; solve with zigzag instead")
    return EmittedConv(spec=spec, grid_meta=meta, layer_index=lp.index,
                       vmem_elements=kernel_vmem_elements(spec,
                                                          meta.t_run))


# --------------------------------------------------------------------- #
# Emitable planning: restrict the solver to kernel-realisable strategies
# --------------------------------------------------------------------- #

def grid_solve(spec: ConvSpec, p: int, hw: HardwareModel, *,
               nb_data_reload: int = 2, time_limit: float = 10.0,
               polish_iters: int = 0, use_milp: bool = False,
               rng_seed: int = 0, polish_restarts: int = 0) -> SolveResult:
    """``plan_network`` solve_fn over *emitable* strategies only.

    Candidates are zigzag sweeps with every run length ``t`` dividing
    ``w_out`` and ``t <= p``; feasibility is the emitted kernel's actual
    shared-memory occupancy (:func:`kernel_vmem_elements`) against
    ``hw.size_mem``.  When Λ does not fit, nothing fits and the solve
    raises: the kernel never spills.  Polishing knobs are accepted (the
    shared solve_fn signature) and ignored — the candidate set is tiny
    and enumerated exactly.
    """
    del time_limit, polish_iters, use_milp, rng_seed, polish_restarts
    best: GroupedStrategy | None = None
    for t in range(1, min(p, spec.w_out) + 1):
        if spec.w_out % t:
            continue
        if hw.size_mem is not None and \
                kernel_vmem_elements(spec, t) > hw.size_mem:
            continue
        cand = zigzag(spec, t)
        if best is None or cand.objective(hw) < best.objective(hw):
            best = cand
    if best is None:
        raise ValueError(
            f"no emitable zigzag strategy fits size_mem={hw.size_mem} "
            f"for layer {spec.c_in}x{spec.h_in}x{spec.w_in}"
            f"->{spec.c_out}")
    obj = best.objective(hw)
    return SolveResult(
        strategy=best, objective=obj,
        lower_bound=lower_bound(spec, best.max_group_size(), hw),
        seed_objective=obj, milp_status="skipped", milp_objective=None,
        polish_objective=obj,
        reload_ok=best.max_reloads() <= nb_data_reload)


def plan_emitable_network(specs, hw: HardwareModel, *, name: str,
                          **kwargs) -> NetworkPlan:
    """``plan_network`` restricted to plans every layer of which
    ``emit_layer_kernel`` accepts.  Inter-layer reuse is disabled: the
    emitted kernels implement gross layer schedules."""
    return plan_network(specs, hw, name=name, allow_reuse=False,
                        solve_fn=grid_solve, **kwargs)
