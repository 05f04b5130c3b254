"""Whole-network functional simulation (Sec 6 extended to layer sequences).

Executes every layer of a ``NetworkPlan`` through the matching functional
simulator — the Sec-6 ``System`` for S1 strategies, ``sim.s2.run_s2`` for
S2 kernel-group-swapping strategies — with real values convolved, outputs
checked against the reference convolution, and the measured Def-3
durations reconciled with the plan's accounting.  Layers are materialised
independently (the pooling/stride adapters between network layers are
outside the paper's formalism), so the simulator validates the *per-layer*
schedules exactly and the inter-layer reuse terms analytically:

    sum(sim layer durations) == plan.gross_duration      (exact)
    plan.total_duration = gross - sum(reuse savings)     (by construction)
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.core.network_planner import NetworkPlan
from repro_torch.core.strategies_s2 import S2Strategy
from repro_torch.sim.layer import ConvLayer
from repro_torch.sim.s2 import S2Report, run_s2
from repro_torch.sim.system import SimReport, System

LayerReport = Union[SimReport, S2Report]


@dataclasses.dataclass
class NetworkSimReport:
    plan: NetworkPlan
    layer_reports: list[LayerReport]
    sim_gross_duration: float     # measured, no inter-layer reuse
    modeled_total_duration: float  # plan's prediction, with reuse
    elements_read: int
    elements_written: int
    total_macs: int

    @property
    def correct(self) -> bool:
        return all(r.correct for r in self.layer_reports)

    @property
    def accounting_exact(self) -> bool:
        """Plan gross duration must equal the simulator's, per layer."""
        return all(
            abs(r.total_duration - lp.gross_duration) < 1e-9
            for r, lp in zip(self.layer_reports, self.plan.layers))

    @property
    def peak_within_budget(self) -> bool:
        """Every layer's measured peak must respect ``hw.size_mem``."""
        cap = self.plan.hw.size_mem
        if cap is None:
            return True
        return all(
            (r.peak_memory if isinstance(r, S2Report) else r.peak_footprint)
            <= cap for r in self.layer_reports)

    def summary(self) -> str:
        return (f"network sim: {self.plan.name} "
                f"layers={len(self.layer_reports)} correct={self.correct} "
                f"accounting_exact={self.accounting_exact} "
                f"sim_gross={self.sim_gross_duration:g} "
                f"modeled_total={self.modeled_total_duration:g} "
                f"dram_rd={self.elements_read} dram_wr={self.elements_written}")


def simulate_network(plan: NetworkPlan, seed: int = 0,
                     check: bool = True) -> NetworkSimReport:
    """Run every planned layer strategy functionally and cross-check the
    plan's duration model against the simulator.  S2 layers (the tight
    memory fallback) run through the kernel-swapping executor."""
    reports: list[LayerReport] = []
    for lp in plan.layers:
        layer = ConvLayer.random(lp.spec, seed=seed + lp.index)
        if isinstance(lp.strategy, S2Strategy):
            reports.append(run_s2(layer, plan.hw, lp.strategy))
        else:
            reports.append(System(layer, plan.hw).run(lp.strategy,
                                                      check=check))
    return NetworkSimReport(
        plan=plan,
        layer_reports=reports,
        sim_gross_duration=sum(r.total_duration for r in reports),
        modeled_total_duration=plan.total_duration,
        elements_read=sum(r.elements_read for r in reports),
        elements_written=sum(r.elements_written for r in reports),
        total_macs=sum(r.total_macs for r in reports))
