"""The paper's own conv workloads: LeNet-5 layers (Sec 7.2)."""
from repro_torch.core.conv_spec import ConvSpec

# first conv layer of LeNet-5: 1x32x32 input (padded 28x28), six 5x5 kernels
LENET5_L1 = ConvSpec(c_in=1, h_in=32, w_in=32, n_kernels=6, h_k=5, w_k=5)
# second conv layer: 6x14x14 -> sixteen 5x5 kernels
LENET5_L2 = ConvSpec(c_in=6, h_in=14, w_in=14, n_kernels=16, h_k=5, w_k=5)

# the conv backbone in execution order (pooling between layers happens
# on-chip and is free in the planning model — see core.network_planner)
LAYERS = (LENET5_L1, LENET5_L2)
