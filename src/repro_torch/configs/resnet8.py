"""The paper's ResNet8 conv layers (Sec 7.2): 3x3 kernels, stride 1."""
from repro_torch.core.conv_spec import ConvSpec

RESNET8_L1 = ConvSpec(c_in=3, h_in=34, w_in=34, n_kernels=16, h_k=3, w_k=3)
RESNET8_L2 = ConvSpec(c_in=16, h_in=18, w_in=18, n_kernels=32, h_k=3, w_k=3)
RESNET8_L3 = ConvSpec(c_in=32, h_in=10, w_in=10, n_kernels=64, h_k=3, w_k=3)

# Channel-consistent CIFAR-style backbone: stem then three residual blocks
# of two 3x3 convs each; every c_in equals the previous layer's c_out
# (spatial dims already padded, stride-2 downsampling between blocks
# happens on-chip).  Block 1 repeats one shape — the repeated-layer
# pattern the network planner's solve cache exists for.
RESNET8_STEM = RESNET8_L1                                  # 3  -> 16
RESNET8_B1 = ConvSpec(c_in=16, h_in=34, w_in=34, n_kernels=16,
                      h_k=3, w_k=3)                        # 16 -> 16 (x2)
RESNET8_B2A = RESNET8_L2                                   # 16 -> 32
RESNET8_B2B = ConvSpec(c_in=32, h_in=18, w_in=18, n_kernels=32,
                       h_k=3, w_k=3)                       # 32 -> 32
RESNET8_B3A = RESNET8_L3                                   # 32 -> 64
RESNET8_B3B = ConvSpec(c_in=64, h_in=10, w_in=10, n_kernels=64,
                       h_k=3, w_k=3)                       # 64 -> 64
LAYERS = (RESNET8_STEM, RESNET8_B1, RESNET8_B1,
          RESNET8_B2A, RESNET8_B2B, RESNET8_B3A, RESNET8_B3B)
