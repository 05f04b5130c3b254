"""Plain-PyTorch oracles for the kernels of this package.

Used by the tests and by ``chip_smoke.py`` only: nothing on the main path
calls them."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, s_h: int = 1, s_w: int = 1
           ) -> torch.Tensor:
    """(C_in, H_in, W_in) x (N, C_in, Hk, Wk) -> (N, H_out, W_out).

    Computed in float32 and cast back to ``x.dtype``.  On a CUDA tensor a
    float32 convolution goes through cuDNN, which by default rounds its
    inputs to TF32 (about three decimal digits): the oracle switches that
    off for its own call and restores the caller's setting."""
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(x[None].float(), w.float(), stride=(s_h, s_w))
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    return out[0].to(x.dtype)
