"""Optimise offloading strategies for the paper's LeNet-5 / ResNet8 conv
layers and for the H100 kernel planner (the beyond-paper bridge).

The port's counterpart of ``examples/optimize_offload.py``, on
``repro_torch`` (host only). The paper workloads print the reference's
lines; the bridge plans the port's CUDA kernels under the H100's model
(``H100_SXM``: one block's shared memory, 3.35 TB/s, 989 TFLOP/s) where
the reference plans its Pallas kernels under ``TPU_V5E``.

    PYTHONPATH=src python examples/torch_optimize_offload.py
"""
from repro_torch.configs.lenet5 import LENET5_L1, LENET5_L2
from repro_torch.configs.resnet8 import RESNET8_L1, RESNET8_L2, RESNET8_L3
from repro_torch.core import planner, solver
from repro_torch.core.cost_model import H100_SXM, HardwareModel


def main() -> None:
    hw = HardwareModel(nbop_pe=10**9)
    print("== paper workloads: solver vs best heuristic (eq. 15 duration) ==")
    for name, spec in [("lenet5_l1", LENET5_L1), ("lenet5_l2", LENET5_L2),
                       ("resnet8_l1", RESNET8_L1), ("resnet8_l2", RESNET8_L2),
                       ("resnet8_l3", RESNET8_L3)]:
        p = 8
        res = solver.solve(spec, p=p, hw=hw, use_milp=False, polish_iters=6000)
        print(f"{name:11s} p={p} seed={res.seed_objective:7.0f} "
              f"solver={res.objective:7.0f} (-{res.gain_vs_seed*100:4.1f}%) "
              f"LB={res.lower_bound:7.0f}")

    print("\n== H100 planner: same formalism choosing CUDA kernel "
          "schedules ==")
    for m, n, k in [(4096, 4096, 4096), (8192, 1024, 8192), (512, 512, 65536)]:
        pl = planner.plan_matmul(m, n, k, chip=H100_SXM)
        print(f"matmul {m}x{n}x{k}: tiles={pl.tiles} order={pl.order} "
              f"AI={pl.arithmetic_intensity:.0f} "
              f"t={pl.duration_overlapped*1e3:.3f}ms")
    for s in (32768, 524288):
        pl = planner.plan_decode_attention(s, 128, 8, chip=H100_SXM)
        print(f"decode S={s}: bkv={pl.tiles['bkv']} steps={pl.steps} "
              f"t={pl.duration_overlapped*1e6:.0f}us (memory-bound)")


if __name__ == "__main__":
    main()
