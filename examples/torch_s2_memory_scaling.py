"""S2 strategies (the paper's Sec-9 future work): keep running as the
on-chip memory shrinks BELOW what S1 fundamentally needs (all kernels +
one patch), by swapping kernel subsets through the accelerator.

The port's counterpart of ``examples/s2_memory_scaling.py``, on ``repro_torch``
(host only): the same arguments, and the same output line for line.

    PYTHONPATH=src python examples/torch_s2_memory_scaling.py
"""
from repro_torch.configs.lenet5 import LENET5_L2
from repro_torch.core import strategies_s2 as s2
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.strategies import zigzag
from repro_torch.sim import ConvLayer
from repro_torch.sim.s2 import run_s2


def main() -> None:
    spec = LENET5_L2
    layer = ConvLayer.random(spec)
    s1 = zigzag(spec, 8)
    s1_min = (spec.kernel_elements + s1.peak_input_footprint() * spec.c_in
              + 8 * spec.c_out * 2)
    print(f"LeNet-5 L2: {spec.n_kernels} kernels "
          f"({spec.kernel_elements} elements); S1 needs >= ~{s1_min} on-chip")
    print(f"{'budget':>8s} {'S1?':>4s} {'best S2':>22s} {'duration':>9s} "
          f"{'peak':>6s} {'correct':>7s}")
    for frac in (2.0, 1.0, 0.5, 0.25):
        budget = int(s1_min * frac)
        hw = HardwareModel(nbop_pe=10 ** 9, size_mem=budget)
        res = s2.best_s2(spec, hw)
        rep = run_s2(layer, hw, res.strategy)
        print(f"{budget:8d} {'yes' if res.feasible_s1 else 'NO':>4s} "
              f"{res.strategy.name:>22s} {res.objective:9.0f} "
              f"{res.peak_memory:6d} {str(rep.correct):>7s}")
    print("\nS1 is infeasible below the kernel set size; S2 trades duration "
          "for residency\n(weight-stationary vs input-stationary order chosen "
          "per instance by best_s2).")


if __name__ == "__main__":
    main()
