"""Cluster simulation: execute every shard of a ``MultiChipPlan`` through
the existing single-chip machinery and reconcile the plan's accounting.

Each layer materialises ONE shared :class:`ConvLayer` and every shard's
sub-problem is carved out of it — a row band's halo-extended input window
(full kernel set), a kernel subset (full input), or a hybrid band x
kernel-group cell (both slicings at once, the 2-D torus grid) — then run
unchanged through the Sec-6 ``System`` (S1 strategies) or
``sim.s2.run_s2`` (kernel-group swapping).  The shard outputs are
stitched back into the full output tensor and compared against the full
layer's reference convolution, so band offsets, halo extents, and kernel
ranges are validated end to end, not just each shard in isolation.  The
reconciliation discipline matches ``sim.network``:

  * ``correct`` — every shard's functional run passes AND the stitched
    per-layer outputs equal the full reference convolution with no gaps;
  * ``accounting_exact`` — every shard's measured Def-3 duration equals
    the plan's ``gross_duration`` for that shard plus its analytic
    ``pad_saved`` (``same_pad`` edge bands skip padding-row first loads
    the functional simulator still performs), every layer's
    ``compute_duration`` equals the max over its shards, the plan's
    per-layer ICI charges equal an independent re-pricing of the chosen
    mode sequence (``core.multichip.ici_schedule`` — topology-priced
    collectives), and the total recomposes from the *measured* shard
    durations under each stage's own discipline — ``max(compute, ICI)``
    when the layer's ``overlap`` flag is set (the planner proved the
    exchange WAR-free), ``compute + ICI`` otherwise;
  * ``peak_within_budget`` — every shard's *measured* peak stays within
    the per-chip ``size_mem``;
  * ICI transfers themselves are analytic (the bottleneck-link element
    counts are exact integers by construction; there is no functional
    payload to move between simulated chips), exactly as the inter-layer
    reuse savings are analytic in ``sim.network``.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

from repro_torch.core.multichip import MultiChipPlan, ShardPlan, ici_schedule
from repro_torch.core.strategies_s2 import S2Strategy
from repro_torch.sim.functional import reference_conv
from repro_torch.sim.layer import ConvLayer
from repro_torch.sim.s2 import S2Report, run_s2
from repro_torch.sim.system import SimReport, System

LayerReport = Union[SimReport, S2Report]


def carve_shard(full: ConvLayer, shard: ShardPlan) -> ConvLayer:
    """The shard's sub-problem sliced out of the shared layer data: a
    row band's halo-extended window, a kernel subset, or both at once
    (hybrid grid cells)."""
    spec = full.spec
    if shard.out_rows is None and shard.kernel_range is None:
        return full                                # replicate
    inp = full.input
    kernels = full.kernels
    if shard.out_rows is not None:                 # row band window
        r0, _ = shard.out_rows
        h0 = r0 * spec.s_h
        inp = inp[:, h0:h0 + shard.spec.h_in, :]
    if shard.kernel_range is not None:             # kernel subset
        k0, k1 = shard.kernel_range
        kernels = kernels[k0:k1]
    return ConvLayer(spec=shard.spec, input=inp.copy(),
                     kernels=kernels.copy())


def run_shard(full: ConvLayer, shard: ShardPlan, hw, *, check: bool = True,
              retry_at: "dict[int, int] | None" = None,
              backoff_base: float = 16.0) -> LayerReport:
    """Carve ``shard``'s sub-problem out of the shared ``full`` layer and
    execute it through the single-chip machinery — the one execution path
    shared by :func:`simulate_multichip` and the fault-injection engine
    (``repro_torch.resil.engine``), so a faulted re-execution of a shard is the same computation, bit for
    bit, as its fault-free run.

    ``retry_at`` injects transient DMA failures into S1 runs (see
    ``System.run``).  S2 shards take no functional injection — a re-read
    is idempotent either way, so the engine prices their retries
    analytically and only the duration ledger differs.
    """
    layer = carve_shard(full, shard)
    if isinstance(shard.strategy, S2Strategy):
        return run_s2(layer, hw, shard.strategy)
    return System(layer, hw).run(shard.strategy, check=check,
                                 retry_at=retry_at,
                                 backoff_base=backoff_base)


@dataclasses.dataclass
class MultiChipSimReport:
    plan: MultiChipPlan
    shard_reports: list[list[LayerReport]]   # [layer][shard]
    stitched_ok: list[bool]       # per layer: shards reassemble the output
    sim_compute_duration: float   # sum over layers of max-over-chips
    modeled_total_duration: float
    elements_read: int            # HBM traffic summed over all chips
    elements_written: int
    total_macs: int

    @property
    def correct(self) -> bool:
        return all(self.stitched_ok) and all(
            r.correct for reps in self.shard_reports for r in reps)

    @property
    def accounting_exact(self) -> bool:
        """Per-shard sim == plan gross + pad_saved (edge bands' skipped
        padding-row loads are analytic), per-layer compute == max shard,
        the plan's ICI charges match an independent re-pricing, and the
        total recomposes from *measured* shard durations under each
        stage's own discipline (``max(compute, ICI)`` when the layer's
        ``overlap`` flag is set, ``compute + ICI`` otherwise — the
        planner serialises halo exchanges it could not prove WAR-free,
        so the flags can differ across layers of one plan)."""
        total = self.plan.final_gather_duration
        for reps, lp in zip(self.shard_reports, self.plan.layers):
            for r, shard in zip(reps, lp.shards):
                if abs(r.total_duration - shard.pad_saved
                       - shard.gross_duration) > 1e-9:
                    return False
            compute = max(r.total_duration - s.pad_saved
                          for r, s in zip(reps, lp.shards))
            if abs(compute - lp.compute_duration) > 1e-9:
                return False
            if lp.overlap:
                total += max(compute, lp.ici_duration) - lp.savings
            else:
                total += compute + lp.ici_duration - lp.savings
        if abs(total - self.plan.total_duration) > 1e-6:
            return False
        per_layer, final = ici_schedule(
            [lp.spec for lp in self.plan.layers],
            [lp.mode for lp in self.plan.layers],
            [lp.active_chips for lp in self.plan.layers],
            self.plan.cluster)
        if final != self.plan.final_gather_elements:
            return False
        return all(e == lp.ici_elements
                   for e, lp in zip(per_layer, self.plan.layers))

    @property
    def peak_within_budget(self) -> bool:
        """Every shard's measured peak must respect the per-chip budget."""
        cap = self.plan.cluster.chip.size_mem
        if cap is None:
            return True
        return all(
            (r.peak_memory if isinstance(r, S2Report) else r.peak_footprint)
            <= cap for reps in self.shard_reports for r in reps)

    def summary(self) -> str:
        return (f"multichip sim: {self.plan.name} "
                f"chips={self.plan.cluster.n_chips} "
                f"layers={len(self.shard_reports)} correct={self.correct} "
                f"accounting_exact={self.accounting_exact} "
                f"peak_within_budget={self.peak_within_budget} "
                f"sim_compute={self.sim_compute_duration:g} "
                f"modeled_total={self.modeled_total_duration:g} "
                f"dram_rd={self.elements_read} dram_wr={self.elements_written}")


def simulate_multichip(plan: MultiChipPlan, seed: int = 0,
                       check: bool = True) -> MultiChipSimReport:
    """Run every shard of every layer functionally — against ONE shared
    layer instance per layer — stitch the shard outputs, and cross-check
    the cluster duration model (see the module note for the discipline)."""
    hw = plan.cluster.chip
    shard_reports: list[list[LayerReport]] = []
    stitched_ok: list[bool] = []
    for lp in plan.layers:
        full = ConvLayer.random(lp.spec, seed=seed + lp.index)
        ref = reference_conv(full)
        assembled = np.full_like(ref, np.nan)
        reps: list[LayerReport] = []
        for shard in lp.shards:
            rep = run_shard(full, shard, hw, check=check)
            reps.append(rep)
            rows = slice(None) if shard.out_rows is None else \
                slice(*shard.out_rows)
            kers = slice(None) if shard.kernel_range is None else \
                slice(*shard.kernel_range)
            assembled[kers, rows, :] = rep.output
        stitched_ok.append(
            not np.any(np.isnan(assembled)) and bool(
                np.allclose(assembled, ref, rtol=1e-4, atol=1e-4)))
        shard_reports.append(reps)
    return MultiChipSimReport(
        plan=plan,
        shard_reports=shard_reports,
        stitched_ok=stitched_ok,
        sim_compute_duration=sum(max(r.total_duration for r in reps)
                                 for reps in shard_reports),
        modeled_total_duration=plan.total_duration,
        elements_read=sum(r.elements_read
                          for reps in shard_reports for r in reps),
        elements_written=sum(r.elements_written
                             for reps in shard_reports for r in reps),
        total_macs=sum(r.total_macs
                       for reps in shard_reports for r in reps))
