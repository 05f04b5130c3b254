"""The offloading formalism, the conv strategies, the ILP with its solver,
the network planner, and the tile-schedule planner that carries the same
cost model into the CUDA kernels."""
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import (H100_SXM, ClusterModel,
                                         GpuChipModel, HardwareModel)
from repro_torch.core.formalism import MemoryState, Step, StepError, run_steps
from repro_torch.core.strategies import (GroupedStrategy, best_heuristic,
                                         hilbert, row_by_row, s1_baseline,
                                         tiled, zigzag)

__all__ = [
    "ConvSpec", "HardwareModel", "GpuChipModel", "H100_SXM", "ClusterModel",
    "MemoryState", "Step", "StepError", "run_steps",
    "GroupedStrategy", "best_heuristic", "hilbert", "row_by_row",
    "s1_baseline", "tiled", "zigzag",
]
