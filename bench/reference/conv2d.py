"""The convolution of the conv cells: ``torch.nn.functional.conv2d`` in
float32 with TF32 off, on an input already padded (no padding here).

:func:`conv2d_tf32` is the control: the same convolution with its inputs
rounded to TF32 (10 mantissa bits, to nearest, ties to even) and the
products summed in float32, as the tensor cores compute a float32
convolution when TF32 is allowed.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_f32():
    """TF32 off for matrix products and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def conv2d(x: torch.Tensor, w: torch.Tensor, s_h: int = 1, s_w: int = 1
           ) -> torch.Tensor:
    """x (n, C_in, H_in, W_in), w (N, C_in, H_K, W_K) -> (n, N, H_out,
    W_out) float32."""
    with full_f32():
        return F.conv2d(x.float(), w.float(), stride=(s_h, s_w))


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32's 10 mantissa bits."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def conv2d_tf32(x: torch.Tensor, w: torch.Tensor, s_h: int = 1,
                s_w: int = 1) -> torch.Tensor:
    return conv2d(round_tf32(x), round_tf32(w), s_h, s_w)
