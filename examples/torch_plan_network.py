"""Demo: plan a whole conv network, print the schedule, validate it
functionally with the Sec-6 / S2 simulators — and show the S1→S2
crossover: shrinking the on-chip budget forces layers out of the paper's
all-kernels-resident S1 regime into S2 kernel-group swapping.

The port's counterpart of ``examples/plan_network.py``, on ``repro_torch``
(host only): the same arguments, and the same output line for line.

    PYTHONPATH=src python examples/torch_plan_network.py [network] \
        [--size-mem N]
    PYTHONPATH=src python examples/torch_plan_network.py tight4 --crossover
"""
import argparse

from repro_torch.configs.networks import NETWORKS
from repro_torch.configs.tight import budget_points
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.network_planner import (InfeasibleNetworkError,
                                              plan_network)
from repro_torch.sim import simulate_network

FAST = dict(polish_iters=4000, polish_restarts=4)


def run_once(name: str, hw: HardwareModel) -> None:
    plan = plan_network(NETWORKS[name], hw, name=name, **FAST)
    print(plan.report())
    print()
    rep = simulate_network(plan)
    print(rep.summary())
    assert rep.correct, "functional check failed"
    assert rep.accounting_exact, "duration model disagrees with simulator"
    assert rep.peak_within_budget, "simulated footprint exceeds size_mem"
    print("functional + accounting + memory checks passed")


def crossover(name: str, nbop_pe: int) -> None:
    """Sweep budgets from above the largest kernel set to far below it and
    print which layers flip from S1 to S2 at each point."""
    specs = NETWORKS[name]
    budgets = budget_points(specs, fractions=(4.0, 2.0, 1.0, 0.5, 0.25,
                                              0.125))
    print(f"{name}: S1→S2 crossover "
          f"(largest Λ = {max(s.kernel_elements for s in specs)} elements)")
    for size_mem in sorted(budgets, reverse=True):
        hw = HardwareModel(nbop_pe=nbop_pe, size_mem=size_mem)
        try:
            plan = plan_network(specs, hw, name=name,
                                polish_iters=800, polish_restarts=1)
        except InfeasibleNetworkError:
            print(f"  mem={size_mem:>8}: infeasible (below any S2 window)")
            continue
        modes = " ".join(lp.mode.upper() for lp in plan.layers)
        print(f"  mem={size_mem:>8}: [{modes}]  "
              f"plan {plan.total_duration:g} vs greedy "
              f"{plan.baseline_duration:g} "
              f"(gain {plan.gain_vs_baseline:.1%}, "
              f"peak {plan.peak_footprint})")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("network", nargs="?", default="lenet5",
                    choices=sorted(NETWORKS))
    ap.add_argument("--size-mem", type=int, default=None,
                    help="on-chip budget in elements (default: "
                         "unconstrained)")
    ap.add_argument("--nbop-pe", type=int, default=10 ** 9)
    ap.add_argument("--crossover", action="store_true",
                    help="sweep budgets and show the S1→S2 flip per layer")
    args = ap.parse_args()

    if args.crossover:
        crossover(args.network, args.nbop_pe)
        return
    hw = HardwareModel(nbop_pe=args.nbop_pe, size_mem=args.size_mem)
    run_once(args.network, hw)


if __name__ == "__main__":
    main()
