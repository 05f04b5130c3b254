"""Quickstart: the paper's pipeline end to end on one conv layer.

1. Describe a convolution + accelerator (paper Sec 2).
2. Build the heuristic strategies (Row-by-Row, ZigZag — Sec 7.2) and the
   grouped S1 strategy (Sec 4.2).
3. Optimise with the ILP+polish solver (Sec 5).
4. Execute the winner functionally in the simulator (Sec 6) and check it
   computes the exact convolution.

The port's counterpart of ``examples/quickstart.py``, on ``repro_torch``
(host only): the same arguments, and the same output line for line.

    PYTHONPATH=src python examples/torch_quickstart.py
"""
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.strategies import (nb_patches_max_s1, row_by_row,
                                   s1_baseline, tiled, zigzag)
from repro_torch.core import solver
from repro_torch.sim import ConvLayer, System
from repro_torch.sim.trace import render_group_grid


def main() -> None:
    # the paper's Example 1 layer: 2x5x5 input, two 2x3x3 kernels
    spec = ConvSpec(c_in=2, h_in=5, w_in=5, n_kernels=2, h_k=3, w_k=3)
    hw = HardwareModel(nbop_pe=120, size_mem=4096)
    p = nb_patches_max_s1(spec, hw)
    print(f"patches={spec.num_patches} nb_patches_max_S1={p}")

    for strat in (s1_baseline(spec), row_by_row(spec, p), zigzag(spec, p),
                  tiled(spec, p)):
        print(f"{strat.name:12s} delta={strat.objective(hw):6.1f} "
              f"steps={strat.n_steps} reloads<= {strat.max_reloads()}")

    res = solver.solve(spec, p=p, hw=hw, time_limit=10, polish_iters=5000)
    print(f"solver       delta={res.objective:6.1f} "
          f"(seed {res.seed_objective}, "
          f"LB {res.lower_bound}, milp={res.milp_status}, "
          f"gain {res.gain_vs_seed*100:.1f}%)")
    print(render_group_grid(res.strategy))

    report = System(ConvLayer.random(spec), hw).run(res.strategy)
    print("simulator:", report.summary())
    assert report.correct


if __name__ == "__main__":
    main()
