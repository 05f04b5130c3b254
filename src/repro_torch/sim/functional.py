"""Reference convolution oracles for the functional simulation check."""
from __future__ import annotations

import numpy as np

from repro_torch.sim.layer import ConvLayer


def reference_conv(layer: ConvLayer) -> np.ndarray:
    """Direct cross-correlation (Def 8's output equation), numpy."""
    s = layer.spec
    out = np.zeros((s.c_out, s.h_out, s.w_out), dtype=np.float32)
    for i in range(s.h_out):
        for j in range(s.w_out):
            win = layer.input[:, i * s.s_h:i * s.s_h + s.h_k,
                              j * s.s_w:j * s.s_w + s.w_k]
            out[:, i, j] = np.einsum("nchw,chw->n", layer.kernels, win)
    return out


def reference_conv_torch(layer: ConvLayer) -> np.ndarray:
    """Independent oracle: ``torch.nn.functional.conv2d`` on the CPU in
    float32 (used by the test suite)."""
    import torch
    import torch.nn.functional as F

    s = layer.spec
    out = F.conv2d(torch.from_numpy(layer.input)[None],
                   torch.from_numpy(layer.kernels), stride=(s.s_h, s.s_w))
    return out[0].numpy()
