"""Registry of conv-network workloads for the network-level planner."""
from repro_torch.configs import lenet5, resnet8, tight

NETWORKS = {
    "lenet5": lenet5.LAYERS,
    "resnet8": resnet8.LAYERS,
    "tight4": tight.LAYERS,
    "tight2": tight.LAYERS_SMALL,
}
