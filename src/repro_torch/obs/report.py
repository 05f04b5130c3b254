"""Predicted-vs-simulated-vs-kernel drift report.

``python -m repro_torch.obs.report --network tight4 --topology torus2x2``
plans the network (single-chip or on a cluster), executes the plan in
the functional simulator, statically traces the planned conv kernel,
builds the three timelines on the shared event model, exports them as
one Chrome-trace/Perfetto JSON, and reconciles them per (layer, chip,
lane) — attributing any divergence to the first divergent step.

The paper's claim is *predictable* offloading: on a reconciled plan the
max |predicted − simulated| element drift is exactly 0 (DRAM traffic is
integral) and the duration drift is 0 within float tolerance.  The exit
code folds that in — nonzero drift, a schema-invalid trace, or a lane
missing from a chip all fail the run — which is what ``chip_smoke.py``'s
stack phase checks on the card's host.

Load the written trace in https://ui.perfetto.dev (or
``chrome://tracing``): one process per (source, chip), one thread per
lane, 1 ts == 1 Def-3 cycle.

Drift semantics:

* ``predicted`` vs ``simulated`` — same step sequence, durations and
  element counts measured independently by the simulator; reconciles
  per step on every lane.
* ``kernel`` vs its own emitable plan (``kernels.emit`` at kerncheck's
  2x-Λ budget — kernels only exist for emitable plans) — ``dma_in``
  reconciles per step; ``write_back`` reconciles per layer (the kernel
  writes each output block during its own step, the plan's a3 drains
  it at the next step); ``compute`` reconciles per layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Sequence

from repro_torch.analysis import kerncheck
from repro_torch.configs.clusters import make_cluster
from repro_torch.configs.networks import NETWORKS
from repro_torch.core.cost_model import HardwareModel, Topology
from repro_torch.core.multichip import plan_multichip_network
from repro_torch.core.network_planner import plan_network
from repro_torch.obs import adapters
from repro_torch.obs.chrome import (to_chrome_trace, validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.events import LANES, Timeline
from repro_torch.sim.multichip import simulate_multichip
from repro_torch.sim.network import simulate_network

_TOL = 1e-9
_ONCHIP_LANES = ("dma_in", "compute", "write_back")


@dataclasses.dataclass(frozen=True)
class DriftRow:
    """One (layer, chip, lane) reconciliation line."""

    layer: int
    chip: int
    lane: str
    predicted_dur: float
    observed_dur: float
    predicted_elements: int
    observed_elements: int
    first_divergent_step: int | None = None

    @property
    def drift_cycles(self) -> float:
        return abs(self.predicted_dur - self.observed_dur)

    @property
    def drift_elements(self) -> int:
        return abs(self.predicted_elements - self.observed_elements)

    @property
    def clean(self) -> bool:
        """This lane's totals reconcile.  ``first_divergent_step`` is
        shared (layer, chip) context, judged by :attr:`ObsReport.ok` —
        it can be set while an individual lane's sums still match (and
        catches compensating per-step drift that cancels in the sums)."""
        return self.drift_elements == 0 and self.drift_cycles <= _TOL


def _first_divergent_step(pred: Timeline, obs: Timeline, *, layer: int,
                          chip: int) -> int | None:
    """First step index where any lane's span disagrees on duration
    (beyond tolerance) or on element count."""
    table: dict[tuple[int, str], list[float]] = {}
    for src, tl in enumerate((pred, obs)):
        for s in tl.select(layer=layer, chip=chip):
            if s.step is None:
                continue
            row = table.setdefault((s.step, s.lane), [0.0, 0, 0.0, 0])
            row[2 * src] += s.dur
            row[2 * src + 1] += s.elements
    for (step, _lane), (pd, pe, od, oe) in sorted(table.items()):
        if pe != oe or abs(pd - od) > _TOL:
            return step
    return None


def drift_rows(pred: Timeline, obs: Timeline,
               lanes: Sequence[str] = LANES,
               per_step: bool = True) -> list[DriftRow]:
    """Reconcile two timelines per (layer, chip, lane)."""
    rows = []
    keys = sorted({(s.layer, s.chip) for s in pred.spans + obs.spans
                   if s.layer is not None})
    for layer, chip in keys:
        div = _first_divergent_step(pred, obs, layer=layer, chip=chip) \
            if per_step else None
        for lane in lanes:
            sel = dict(layer=layer, chip=chip, lane=lane)
            rows.append(DriftRow(
                layer=layer, chip=chip, lane=lane,
                predicted_dur=pred.span_sum(**sel),
                observed_dur=obs.span_sum(**sel),
                predicted_elements=pred.element_sum(**sel),
                observed_elements=obs.element_sum(**sel),
                first_divergent_step=div))
    return rows


def fault_attribution_rows(pred: Timeline, faulted: Timeline
                           ) -> list[DriftRow]:
    """Degraded-run drift attribution (``repro_torch.resil``): reconcile
    the fault-free *predicted* timeline against a faulted run per (layer,
    chip, lane).  The ``fault``/``recovery`` lanes are zero on the
    predicted side by construction, so their observed totals *are* the
    overhead the fault model added — wasted attempts, heartbeat
    detection, DMA retries, re-planning, restaging — while drift on the
    other lanes shows where the degraded plan executes differently
    (e.g. a survivor absorbing a dead chip's rows).  Per-step divergence
    is not judged: a faulted run legitimately diverges at the first
    fault, and the point of this table is to say by how much and why.
    """
    return drift_rows(pred, faulted, per_step=False)


def fault_overhead_by_lane(rows: "Sequence[DriftRow]"
                           ) -> dict[str, float]:
    """Sum each lane's |observed - predicted| duration drift — the
    attribution table's bottom line, pinned by ``faultsim``."""
    out: dict[str, float] = {}
    for r in rows:
        out[r.lane] = out.get(r.lane, 0.0) + (
            r.observed_dur - r.predicted_dur)
    return out


def kernel_drift_rows(plan_tl: Timeline, kern_tl: Timeline
                      ) -> list[DriftRow]:
    """Kernel-vs-plan reconciliation: per-step on ``dma_in``, per-layer
    on ``compute``/``write_back`` (one-step write skew, module note)."""
    rows = []
    layers = sorted({s.layer for s in kern_tl.spans if s.layer is not None})
    for layer in layers:
        div = None
        pred_dma = {s.step: s for s in plan_tl.select(layer=layer, chip=0,
                                                      lane="dma_in")}
        for s in sorted(kern_tl.select(layer=layer, chip=0, lane="dma_in"),
                        key=lambda s: s.step or 0):
            p = pred_dma.get(s.step)
            if p is None or p.elements != s.elements:
                div = s.step
                break
        for lane in _ONCHIP_LANES:
            sel = dict(layer=layer, chip=0, lane=lane)
            rows.append(DriftRow(
                layer=layer, chip=0, lane=lane,
                predicted_dur=plan_tl.span_sum(**sel),
                observed_dur=kern_tl.span_sum(**sel),
                predicted_elements=plan_tl.element_sum(**sel),
                observed_elements=kern_tl.element_sum(**sel),
                first_divergent_step=div if lane == "dma_in" else None))
    return rows


@dataclasses.dataclass
class ObsReport:
    """Everything one report run established."""

    network: str
    topology: str | None
    n_chips: int
    size_mem: int | None
    timelines: list[Timeline]
    rows: list[DriftRow]            # predicted vs simulated
    kernel_rows: list[DriftRow]     # emitable plan vs kernel trace
    trace: dict
    trace_errors: list[str]
    lanes_ok: bool
    overlap_errors: list[str]
    sim_correct: bool
    accounting_exact: bool

    @property
    def max_drift_elements(self) -> int:
        return max((r.drift_elements
                    for r in self.rows + self.kernel_rows), default=0)

    @property
    def max_drift_cycles(self) -> float:
        return max((r.drift_cycles
                    for r in self.rows + self.kernel_rows), default=0.0)

    @property
    def trace_valid(self) -> bool:
        return not self.trace_errors and self.lanes_ok \
            and not self.overlap_errors

    @property
    def ok(self) -> bool:
        return self.trace_valid and self.sim_correct \
            and self.accounting_exact and self.max_drift_elements == 0 \
            and self.max_drift_cycles <= _TOL \
            and all(r.first_divergent_step is None
                    for r in self.rows + self.kernel_rows)

    def render(self) -> str:
        where = f"{self.network}" + (
            f"@{self.topology} ({self.n_chips} chips)" if self.topology
            else " (single chip)")
        lines = [f"obs drift report: {where}  size_mem={self.size_mem}"]
        layers = sorted({r.layer for r in self.rows})
        for layer in layers:
            lrs = [r for r in self.rows if r.layer == layer]
            worst = max(lrs, key=lambda r: (r.drift_elements,
                                            r.drift_cycles))
            pred_cycles = sum(r.predicted_dur for r in lrs)
            sim_cycles = sum(r.observed_dur for r in lrs)
            status = "ok" if all(r.clean for r in lrs) else (
                f"DRIFT chip{worst.chip}/{worst.lane}"
                f" {worst.predicted_elements}->{worst.observed_elements}el"
                + (f" @step {worst.first_divergent_step}"
                   if worst.first_divergent_step is not None else ""))
            lines.append(
                f"  L{layer}: predicted {pred_cycles:g} cy, "
                f"simulated {sim_cycles:g} cy, "
                f"|drift| {max(r.drift_cycles for r in lrs):g} cy / "
                f"{max(r.drift_elements for r in lrs)} el  [{status}]")
        if self.kernel_rows:
            klayers = sorted({r.layer for r in self.kernel_rows})
            bad = [r for r in self.kernel_rows if not r.clean]
            lines.append(
                f"  kernel trace: {len(klayers)} layers vs emitable plan "
                f"— {'ok' if not bad else f'{len(bad)} lane(s) drift'}")
        lines.append(
            f"  trace: {len(self.trace['traceEvents'])} events, "
            f"{'valid' if not self.trace_errors else 'INVALID'}; "
            f"lanes {'complete' if self.lanes_ok else 'MISSING'}; "
            f"sim correct={self.sim_correct} "
            f"accounting_exact={self.accounting_exact}")
        lines.append(
            f"  max drift: {self.max_drift_elements} elements / "
            f"{self.max_drift_cycles:g} cycles -> "
            f"{'RECONCILED' if self.ok else 'FAIL'}")
        return "\n".join(lines)


def _check_lanes(pred: Timeline, n_chips: int) -> bool:
    """Every chip must carry every lane it is supposed to: the three
    on-chip lanes always, ``ici`` too when the plan moved any inter-chip
    traffic at all (a cluster plan with zero ICI everywhere is possible
    and has nothing to show on that lane)."""
    want = set(_ONCHIP_LANES)
    if any(s.lane == "ici" for s in pred.spans):
        want.add("ici")
    return set(pred.chips()) == set(range(n_chips)) and all(
        want <= pred.lanes_of(chip) for chip in range(n_chips))


def default_size_mem(network: str, multichip: bool) -> int | None:
    """The benchmark conventions: multichip runs use the tight budget of
    the chip sweep (half the largest kernel set Λ); single-chip runs use
    the paper's unconstrained Sec-7.1 setting."""
    if not multichip:
        return None
    return max(s.kernel_elements for s in NETWORKS[network]) // 2


def build_report(network: str, *, topology: str | None = None,
                 n_chips: int | None = None,
                 size_mem: int | None = None,
                 nbop_pe: int = 10 ** 9,
                 iters: int = 1500, restarts: int = 2, rng_seed: int = 0,
                 overlap: bool = True,
                 include_kernel: bool = True) -> ObsReport:
    """Plan, simulate, trace and reconcile one network (module note)."""
    specs = NETWORKS[network]
    if topology is not None:
        if n_chips is None:
            topo = Topology.parse(topology)
            n_chips = topo.dims[0] * topo.dims[1] \
                if topo.kind == "torus" else 4
        if size_mem is None:
            size_mem = default_size_mem(network, multichip=True)
        cluster = make_cluster(n_chips, nbop_pe=nbop_pe,
                               size_mem=size_mem, topology=topology)
        plan = plan_multichip_network(
            specs, cluster, name=network, polish_iters=iters,
            polish_restarts=restarts, rng_seed=rng_seed,
            include_single_chip_baseline=False, overlap=overlap,
            balance_rows=overlap)
        sim = simulate_multichip(plan, seed=rng_seed)
        pred = adapters.multichip_predicted_timeline(plan)
        obs_tl = adapters.multichip_simulated_timeline(sim)
    else:
        n_chips = 1
        hw = HardwareModel(nbop_pe=nbop_pe, size_mem=size_mem)
        plan = plan_network(specs, hw, name=network, polish_iters=iters,
                            polish_restarts=restarts, rng_seed=rng_seed)
        sim = simulate_network(plan, seed=rng_seed)
        pred = adapters.network_predicted_timeline(plan)
        obs_tl = adapters.network_simulated_timeline(sim)

    rows = drift_rows(pred, obs_tl)
    timelines = [pred, obs_tl]

    kernel_rows: list[DriftRow] = []
    if include_kernel:
        from repro_torch.kernels.emit import plan_emitable_network
        eplan = plan_emitable_network(
            list(specs), kerncheck.network_budget(specs), name=network)
        kern_tl = adapters.kernel_timeline(eplan)
        plan_tl = adapters.network_predicted_timeline(
            eplan, label="kernel-plan")
        kernel_rows = kernel_drift_rows(plan_tl, kern_tl)
        timelines.append(kern_tl)

    trace = to_chrome_trace(timelines)
    overlap_errors = [v for tl in timelines
                      for v in tl.overlap_violations()]
    return ObsReport(
        network=network, topology=topology, n_chips=n_chips,
        size_mem=size_mem, timelines=timelines, rows=rows,
        kernel_rows=kernel_rows, trace=trace,
        trace_errors=validate_chrome_trace(trace),
        lanes_ok=_check_lanes(pred, n_chips),
        overlap_errors=overlap_errors,
        sim_correct=sim.correct,
        accounting_exact=sim.accounting_exact)


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Predicted-vs-simulated-vs-kernel offload timeline "
                    "drift report (Chrome-trace/Perfetto export).")
    ap.add_argument("--network", required=True, choices=sorted(NETWORKS))
    ap.add_argument("--topology", default=None,
                    help="plan on a cluster: 'ring', 'biring' or "
                         "'torusRxC' (omit for single-chip)")
    ap.add_argument("--n-chips", type=int, default=None,
                    help="cluster size (default: the torus grid, or 4)")
    ap.add_argument("--size-mem", type=int, default=None,
                    help="on-chip budget (default: half the largest Λ "
                         "for cluster runs — the chip-sweep convention — "
                         "or unconstrained for single-chip)")
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--restarts", type=int, default=2)
    ap.add_argument("--rng-seed", type=int, default=0)
    ap.add_argument("--serialized", action="store_true",
                    help="plan with the serialised (overlap=False) "
                         "accounting instead of overlap + balanced bands")
    ap.add_argument("--no-kernel", action="store_true",
                    help="skip the kernel-trace timeline")
    ap.add_argument("--out", default=None,
                    help="trace output path (default: chiprun_out/"
                         "obs_trace_<network>[_<topology>].json)")
    ap.add_argument("--json", action="store_true",
                    help="print the drift rows as JSON instead of text")
    args = ap.parse_args(argv)

    report = build_report(
        args.network, topology=args.topology, n_chips=args.n_chips,
        size_mem=args.size_mem, iters=args.iters,
        restarts=args.restarts, rng_seed=args.rng_seed,
        overlap=not args.serialized, include_kernel=not args.no_kernel)

    out = args.out
    if out is None:
        suffix = f"_{args.topology}" if args.topology else ""
        out = f"chiprun_out/obs_trace_{args.network}{suffix}.json"
    import os
    out_dir = os.path.dirname(out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    write_chrome_trace(report.trace, out)

    if args.json:
        import json
        print(json.dumps({
            "network": report.network, "topology": report.topology,
            "n_chips": report.n_chips, "size_mem": report.size_mem,
            "trace_valid": report.trace_valid,
            "max_drift_elements": report.max_drift_elements,
            "max_drift_cycles": report.max_drift_cycles,
            "rows": [dataclasses.asdict(r) for r in report.rows],
            "kernel_rows": [dataclasses.asdict(r)
                            for r in report.kernel_rows],
        }, indent=1))
    else:
        print(report.render())
    print(f"trace -> {out}  (load in https://ui.perfetto.dev)")
    for err in report.trace_errors[:10] + report.overlap_errors[:10]:
        print(f"  [trace] {err}", file=sys.stderr)
    return 0 if report.ok else 1


if __name__ == "__main__":                      # pragma: no cover
    sys.exit(main())
