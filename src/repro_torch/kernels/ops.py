"""Public wrappers around the kernels.

Each wrapper pads to kernel-friendly shapes, consults ``core.planner`` for
the offloading schedule when the caller does not pin one, dispatches to
the kernel's wrapper (which launches the CUDA kernel for CUDA tensors and
runs the plain version for CPU tensors), and unpads.  ``ref.py`` holds the
oracles.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core import planner
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.kernels import conv2d_offload as _conv


@functools.lru_cache(maxsize=256)
def _planned_t_run(spec: ConvSpec, dtype_bytes: int) -> int:
    """The planner's run length for a layer; cached, because the plan is
    a pure function of the shape and planning costs more than a launch."""
    return planner.plan_conv(spec, dtype_bytes=dtype_bytes).tiles["t"]


def conv2d(x: torch.Tensor, w: torch.Tensor, *, t_run: int | None = None,
           s_h: int = 1, s_w: int = 1, order: str = "zigzag"
           ) -> torch.Tensor:
    """S1 convolution through the simple kernel; ``t_run=None`` asks the
    planner.  x (C_in, H_in, W_in), w (N, C_in, H_K, W_K) ->
    (N, H_out, W_out)."""
    c_in, h_in, w_in = x.shape
    n, _, h_k, w_k = w.shape
    w_out = (w_in - w_k) // s_w + 1
    if t_run is None:
        spec = ConvSpec(c_in, h_in, w_in, n, h_k, w_k, s_h, s_w)
        t_run = _planned_t_run(spec, x.element_size())
    # pad W_in so W_out divides by t_run (extra columns discarded after)
    pad_cols = ((-w_out) % t_run) * s_w if t_run > 0 else 0
    if pad_cols:
        x = F.pad(x, (0, pad_cols))
    out = _conv.conv2d_offload(x, w, t_run=t_run, s_h=s_h, s_w=s_w,
                               order=order)
    return out[:, :, :w_out]
