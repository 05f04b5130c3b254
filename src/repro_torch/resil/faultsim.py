"""Fault-injection CLI: ``python -m repro_torch.resil.faultsim``.

Plans a registered network on a cluster, runs it under a seeded fault
schedule (``repro_torch.resil.engine``), and checks every
recovery-correctness invariant the subsystem claims:

* **exactly-once** — every committed output element has write count 1;
* **exact recovery** — every stitched layer output equals the fault-free
  reference convolution under the simulator's stitching discipline;
* **accounting** — each shard's measured duration reconciles as
  ``gross + pad_saved + retries``;
* **verified re-plans** — the fault-free plan *and* every degraded
  re-plan pass ``repro_torch.analysis.verifier`` (faultsim always
  verifies);
* **determinism** — the engine runs the schedule twice and the two
  bit-for-bit fingerprints (committed bytes + ledger) must agree;
* **valid trace** — the exported Perfetto timeline (fault-free predicted
  vs faulted, with ``fault``/``recovery`` lanes) passes the Chrome-trace
  schema validator.

The exit code folds all of the above in: any finding is nonzero, which
is what ``chip_smoke.py``'s stack phase consumes.  ``--inject-corruption
L`` is the negative path — it corrupts one committed element and
double-counts one write after layer ``L``, and the run must *fail*
(used by the tests to prove the checks have teeth).
``no_free_lunch`` (degraded duration never beats the baseline) is a
pricing property reported in the summary, not an exit criterion.

Scenarios (all placements drawn from ``random.Random(seed)``):

=================  ====================================================
``chip-death``     one chip dies mid-stage; detect, re-plan on the
                   surviving topology, restage, retry.
``link-degrade``   every ICI link 2x slower from a random stage on.
``vmem-shrink``    per-chip budget shrinks to 75% from a random stage.
``dma-transient``  one step's DMA loads fail twice before succeeding.
``mixed``          chip-death + link-degrade + dma-transient (default).
``random``         ``FaultSchedule.random`` with ``--events`` draws.
=================  ====================================================
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
from typing import Sequence

from repro_torch.configs.clusters import make_cluster
from repro_torch.configs.networks import NETWORKS
from repro_torch.core.cost_model import Topology
from repro_torch.obs.adapters import (faulted_timeline,
                                      multichip_predicted_timeline)
from repro_torch.obs.chrome import (to_chrome_trace, validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.report import (default_size_mem, fault_attribution_rows,
                                    fault_overhead_by_lane)
from repro_torch.resil.engine import FaultSimReport, run_faulted
from repro_torch.resil.faults import (ChipDeath, DmaTransient, FaultSchedule,
                                      LinkDegrade, VmemShrink)

SCENARIOS = ("mixed", "chip-death", "link-degrade", "vmem-shrink",
             "dma-transient", "random")


def build_schedule(scenario: str, seed: int, *, n_layers: int,
                   n_chips: int, n_events: int = 3) -> FaultSchedule:
    """Deterministic schedule for a named scenario (module note)."""
    if scenario == "random":
        return FaultSchedule.random(seed, n_layers=n_layers,
                                    n_chips=n_chips, n_events=n_events)
    rng = random.Random(seed)
    events: list = []
    if scenario in ("chip-death", "mixed"):
        events.append(ChipDeath(layer=rng.randrange(n_layers),
                                chip=rng.randrange(n_chips)))
    if scenario in ("link-degrade", "mixed"):
        events.append(LinkDegrade(layer=rng.randrange(n_layers),
                                  factor=2.0))
    if scenario == "vmem-shrink":
        events.append(VmemShrink(layer=rng.randrange(n_layers),
                                 factor=0.75))
    if scenario in ("dma-transient", "mixed"):
        events.append(DmaTransient(layer=rng.randrange(n_layers),
                                   chip=rng.randrange(n_chips),
                                   step=rng.randrange(4), retries=2))
    return FaultSchedule(seed=seed, events=tuple(events))


def run_checked(network: str, schedule: FaultSchedule, *,
                topology: str = "torus2x2", n_chips: int | None = None,
                size_mem: int | None = None, seed: int = 0,
                iters: int = 300, restarts: int = 1, rng_seed: int = 0,
                inject_corruption: int | None = None,
                ) -> "tuple[FaultSimReport, list[str]]":
    """Run the schedule twice (determinism check) with verification on;
    returns the first run's report plus every finding."""
    specs = NETWORKS[network]
    if n_chips is None:
        topo = Topology.parse(topology)
        n_chips = topo.dims[0] * topo.dims[1] if topo.kind == "torus" \
            else 4
    if size_mem is None:
        size_mem = default_size_mem(network, multichip=True)
    cluster = make_cluster(n_chips, size_mem=size_mem, topology=topology)
    kwargs = dict(name=network, seed=seed, verify=True,
                  polish_iters=iters, polish_restarts=restarts,
                  rng_seed=rng_seed, inject_corruption=inject_corruption)
    report = run_faulted(specs, cluster, schedule, **kwargs)
    twin = run_faulted(specs, cluster, schedule, **kwargs)
    findings = list(report.findings)
    if report.fingerprint != twin.fingerprint:
        findings.append(
            f"nondeterministic: fingerprint {report.fingerprint[:16]} "
            f"!= twin {twin.fingerprint[:16]}")
    return report, findings


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.resil.faultsim",
        description="Deterministic fault injection with layer-granular "
                    "recovery: exactly-once outputs, verified degraded "
                    "re-plans, Perfetto fault/recovery trace.")
    ap.add_argument("--network", required=True, choices=sorted(NETWORKS))
    ap.add_argument("--topology", default="torus2x2",
                    help="'ring', 'biring' or 'torusRxC' (default "
                         "torus2x2)")
    ap.add_argument("--n-chips", type=int, default=None,
                    help="cluster size (default: the torus grid, or 4)")
    ap.add_argument("--size-mem", type=int, default=None,
                    help="on-chip budget (default: half the largest Λ — "
                         "the chip-sweep convention)")
    ap.add_argument("--seed", type=int, default=0,
                    help="fault-schedule seed (also the sim data seed)")
    ap.add_argument("--scenario", default="mixed", choices=SCENARIOS)
    ap.add_argument("--events", type=int, default=3,
                    help="draws for --scenario random")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--restarts", type=int, default=1)
    ap.add_argument("--rng-seed", type=int, default=0,
                    help="planner polish seed")
    ap.add_argument("--inject-corruption", type=int, default=None,
                    metavar="LAYER",
                    help="negative path: corrupt layer LAYER's committed "
                         "output — the run must FAIL")
    ap.add_argument("--out", default=None,
                    help="Perfetto trace path (default: chiprun_out/"
                         "faultsim_<network>_<topology>.json)")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON instead of text")
    args = ap.parse_args(argv)

    specs = NETWORKS[args.network]
    topo = Topology.parse(args.topology)
    n_chips = args.n_chips if args.n_chips is not None else (
        topo.dims[0] * topo.dims[1] if topo.kind == "torus" else 4)
    schedule = build_schedule(args.scenario, args.seed,
                              n_layers=len(specs), n_chips=n_chips,
                              n_events=args.events)

    report, findings = run_checked(
        args.network, schedule, topology=args.topology, n_chips=n_chips,
        size_mem=args.size_mem, seed=args.seed, iters=args.iters,
        restarts=args.restarts, rng_seed=args.rng_seed,
        inject_corruption=args.inject_corruption)

    pred = multichip_predicted_timeline(report.plans[0],
                                        label="fault-free-predicted")
    faulted = faulted_timeline(report)
    trace = to_chrome_trace([pred, faulted])
    findings.extend(f"trace: {e}" for e in validate_chrome_trace(trace))
    out = args.out or (f"chiprun_out/faultsim_{args.network}"
                       f"_{args.topology}.json")
    out_dir = os.path.dirname(out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    write_chrome_trace(trace, out)

    rows = fault_attribution_rows(pred, faulted)
    overhead = fault_overhead_by_lane(rows)
    ok = report.ok and not findings

    if args.json:
        print(json.dumps({
            "network": args.network, "topology": args.topology,
            "n_chips": n_chips, "scenario": args.scenario,
            "seed": args.seed,
            "schedule": schedule.describe(),
            "ok": ok, "recovery_exact": report.recovery_exact,
            "exactly_once": report.write_counts_ok,
            "accounting_ok": report.accounting_ok,
            "no_free_lunch": report.no_free_lunch,
            "degraded_slowdown": report.degraded_slowdown,
            "baseline_duration": report.baseline_duration,
            "faulted_duration": report.faulted_duration,
            "wasted_cycles": report.wasted_cycles,
            "recovery_cycles": report.recovery_cycles,
            "retry_cycles": report.retry_cycles,
            "recomputed_elements": report.recomputed_elements,
            "replans": len(report.recoveries),
            "skipped_events": report.skipped_events,
            "fingerprint": report.fingerprint,
            "overhead_by_lane": overhead,
            "findings": findings,
        }, indent=1))
    else:
        print(report.summary())
        for rec in report.recoveries:
            print(f"  recovery L{rec.layer} [{rec.kind}]: re-plan "
                  f"{rec.replan_cycles:g} cy + restage "
                  f"{rec.restage_cycles:g} cy ({rec.restage_elements} "
                  f"el) -> {rec.n_chips} chips {rec.new_topology} "
                  f"verified={rec.verified}")
        for ev in report.skipped_events:
            print(f"  skipped: {ev}")
        lanes = ", ".join(f"{lane} {d:+g}"
                          for lane, d in sorted(overhead.items()) if d)
        print(f"  overhead by lane (faulted - predicted cycles): "
              f"{lanes or 'none'}")
        print(f"  determinism: twin fingerprint match = "
              f"{not any('nondeterministic' in f for f in findings)}")
        print(f"  trace -> {out}  (load in https://ui.perfetto.dev)")
        for f in findings:
            print(f"  FINDING: {f}", file=sys.stderr)
        print(f"  faultsim: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":                      # pragma: no cover
    sys.exit(main())
