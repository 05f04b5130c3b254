"""Plain-PyTorch oracles for the kernels of this package.

Used by the tests and by ``chip_smoke.py`` only: nothing on the main path
calls them.  On a CUDA tensor the products are held to full float32
(TF32 off for the oracle's own call)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import full_f32_matmul


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


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, n) -> (m, n), computed in float32 (TF32 off for its
    own call) and cast back to ``a.dtype``."""
    with full_f32_matmul():
        return (a.float() @ b.float()).to(a.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int | None = None) -> torch.Tensor:
    """Single-position attention: q (G, D), k/v (S, D) -> (G, D).

    ``length`` masks positions >= length (padded KV cache) with ``-inf``,
    as the reference oracle does, so ``length == 0`` gives NaN here; the
    kernels mask with ``-1e30`` and give the mean of ``v`` instead."""
    with full_f32_matmul():
        scores = q.float() @ k.float().t()
        scores = scores / torch.sqrt(torch.tensor(float(q.shape[-1])))
        if length is not None:
            pos = torch.arange(k.shape[0], device=k.device)
            scores = scores.masked_fill(pos[None, :] >= length, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        return (p @ v.float()).to(q.dtype)
