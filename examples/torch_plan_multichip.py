"""Demo: plan a conv network on a multi-chip ICI ring, print the cluster
schedule, validate every shard functionally through the Sec-6 / S2
simulators — and show the replicate→shard crossover: as the per-chip
budget shrinks (kernel sets stop fitting) or the chip count grows, layers
flip from the single-chip replicate path to row/channel sharding, paying
ICI for halo exchanges, input broadcasts, and resharding.

The port's counterpart of ``examples/plan_multichip.py``, on ``repro_torch``
(host only): the same arguments, and the same output line for line.

    PYTHONPATH=src python examples/torch_plan_multichip.py [network] \
        [--chips 4] [--size-mem N] [--ici-factor 4] \
        [--topology ring|biring|torusRxC]
    PYTHONPATH=src python examples/torch_plan_multichip.py tight4 --crossover \
        --topology torus2x2
"""
import argparse

from repro_torch.configs.clusters import ICI_FACTOR, make_cluster
from repro_torch.core.cost_model import Topology
from repro_torch.configs.networks import NETWORKS
from repro_torch.configs.tight import budget_points
from repro_torch.core.multichip import plan_multichip_network
from repro_torch.core.network_planner import InfeasibleNetworkError
from repro_torch.sim import simulate_multichip

FAST = dict(polish_iters=2000, polish_restarts=2)


def run_once(name: str, n_chips: int, size_mem: int | None,
             nbop_pe: int, ici_factor: float, topology: str = "ring",
             overlap: bool = False, balance_rows: bool = False) -> None:
    cluster = make_cluster(n_chips, nbop_pe=nbop_pe, size_mem=size_mem,
                           ici_factor=ici_factor, topology=topology)
    plan = plan_multichip_network(NETWORKS[name], cluster, name=name,
                                  overlap=overlap,
                                  balance_rows=balance_rows, **FAST)
    print(plan.report())
    print()
    rep = simulate_multichip(plan)
    print(rep.summary())
    assert rep.correct, "functional check failed"
    assert rep.accounting_exact, "duration model disagrees with simulator"
    assert rep.peak_within_budget, "a shard's footprint exceeds size_mem"
    print("functional + accounting + per-chip memory checks passed")


def crossover(name: str, nbop_pe: int, ici_factor: float,
              topology: str = "ring",
              overlap: bool = False, balance_rows: bool = False) -> None:
    """Budgets shrink top-to-bottom, chips grow left-to-right: watch the
    mode string flip from all-replicate to row (W) / channel (K) shards
    exactly where sharding buys back S1 feasibility."""
    Topology.parse(topology)        # reject typos before the sweep —
    # inside the loop only dims-vs-chip-count mismatches may pass as n/a
    specs = NETWORKS[name]
    budgets = budget_points(specs, fractions=(4.0, 2.0, 1.0, 0.5, 0.25))
    print(f"{name}: replicate→shard crossover "
          f"(largest Λ = {max(s.kernel_elements for s in specs)} elements, "
          f"t_ici = {ici_factor:g} * t_l, topology = {topology})")
    for size_mem in sorted(budgets, reverse=True):
        cells = []
        for n_chips in (1, 2, 4, 8):
            # one chip has no links: every wiring shares the ring
            # baseline column (same rule as the benchmark sweep)
            topo = "ring" if n_chips == 1 else topology
            try:
                cluster = make_cluster(n_chips, nbop_pe=nbop_pe,
                                       size_mem=size_mem,
                                       ici_factor=ici_factor,
                                       topology=topo)
            except ValueError:           # torus dims don't tile n_chips
                cells.append(f"n{n_chips}: n/a")
                continue
            try:
                plan = plan_multichip_network(
                    specs, cluster, name=name, polish_iters=800,
                    polish_restarts=1, include_single_chip_baseline=False,
                    overlap=overlap, balance_rows=balance_rows)
            except InfeasibleNetworkError:
                cells.append(f"n{n_chips}: infeasible")
                continue
            cells.append(f"n{n_chips}:[{plan.mode_string}] "
                         f"{plan.total_duration:g}")
        print(f"  mem={size_mem:>8}:  " + "   ".join(cells))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("network", nargs="?", default="tight4",
                    choices=sorted(NETWORKS))
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--size-mem", type=int, default=None,
                    help="per-chip on-chip budget in elements (default: "
                         "half the largest kernel set — the sharding "
                         "regime)")
    ap.add_argument("--nbop-pe", type=int, default=10 ** 9)
    ap.add_argument("--ici-factor", type=float, default=ICI_FACTOR,
                    help="t_ici as a multiple of t_l")
    ap.add_argument("--topology", default="ring",
                    help="ICI wiring: ring (unidirectional, default), "
                         "biring, or torusRxC (bidirectional links; "
                         "enables hybrid row x channel sharding)")
    ap.add_argument("--crossover", action="store_true",
                    help="sweep (budget x chip count) and show the mode "
                         "string at each point")
    ap.add_argument("--overlap", action="store_true",
                    help="price double-buffered halo exchange: per-layer "
                         "duration max(compute, ICI) instead of the sum")
    ap.add_argument("--balance-rows", action="store_true",
                    help="size row bands by solved per-chip duration "
                         "instead of raw row counts")
    args = ap.parse_args()

    if args.crossover:
        crossover(args.network, args.nbop_pe, args.ici_factor,
                  topology=args.topology, overlap=args.overlap,
                  balance_rows=args.balance_rows)
        return
    size_mem = args.size_mem
    if size_mem is None:
        specs = NETWORKS[args.network]
        size_mem = max(s.kernel_elements for s in specs) // 2
    run_once(args.network, args.chips, size_mem, args.nbop_pe,
             args.ici_factor, topology=args.topology,
             overlap=args.overlap, balance_rows=args.balance_rows)


if __name__ == "__main__":
    main()
