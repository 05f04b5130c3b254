"""The Mamba-2 recurrent update of one decode step on an NVIDIA H100:
wrapper and plain PyTorch version of the CUDA kernel in
``csrc/ssd_update.cu``.

For every batch row and head the update decays the layer's state
``h`` (B, H, P, N) float32, adds ``dt x B^T`` and reads the new state out
through C, in one pass: the state is read once and written once, in
place.  Head ``h`` of H reads group ``h // (H / G)`` of B and C.  The
conv's output row ``xbc`` (B, H * P + 2 * G * N) holds x, then B, then C;
``dt_raw`` (B, H) is the projection's dt before its bias and softplus.
``y`` (B, H * P) comes back in ``xbc``'s dtype, before the gate.

The JAX package has no kernel here: it writes the step in ``jnp``.  The
plain version :func:`ssd_update_plain` is ``models/ssm.py``'s recurrence,
operation for operation, and returns the new state instead of writing
it.  :func:`ssd_update` looks at where its tensors lie: for CUDA tensors it
checks what the kernel takes (:func:`_geometry`), then launches the kernel
or raises, and never gives way to the plain version; for CPU tensors it
runs the plain version, at any shape and dtype that version computes, and
copies the new state into ``h``.  Each launch counts as
``ssd_update_kernel`` in ``obs.counters``; the plain version never counts.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import KernelShapeError
from repro_torch.kernels import _build

# The state widths N the kernel is compiled for (N / 4 lanes share a row).
STATE_WIDTHS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCH = _build.Launcher(
    "ssd_update", "ssd_update_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2
    + [ctypes.c_void_p], "ssd_update_kernel")


def _geometry(xbc, dt_raw, dt_bias, a_log, d_skip, h, groups: int
              ) -> tuple[int, int, int, int]:
    """Check that the kernel takes these tensors, else raise
    ``KernelShapeError``; return (b, heads, p, n)."""
    if h.dim() != 4 or h.dtype != torch.float32 or not h.is_contiguous():
        raise KernelShapeError(
            f"want the state h (B, H, P, N) float32 and contiguous, got "
            f"{h.dtype} {tuple(h.shape)} with strides {h.stride()}")
    b, heads, p, n = h.shape
    if n not in STATE_WIDTHS:
        raise KernelShapeError(
            f"the kernel takes a state width N of {STATE_WIDTHS}, got {n}")
    if groups < 1 or heads % groups:
        raise KernelShapeError(f"{groups} groups do not divide {heads} heads")
    if xbc.shape != (b, heads * p + 2 * groups * n) or \
            dt_raw.shape != (b, heads):
        raise KernelShapeError(
            f"want xbc ({b}, {heads * p + 2 * groups * n}) and dt_raw "
            f"({b}, {heads}), got {tuple(xbc.shape)} and "
            f"{tuple(dt_raw.shape)}")
    if xbc.dtype not in _DTYPE_CODES or dt_raw.dtype != xbc.dtype:
        raise KernelShapeError(
            f"xbc and dt_raw must be float32 or bfloat16 alike, got "
            f"{xbc.dtype} and {dt_raw.dtype}")
    if xbc.stride(-1) != 1 or dt_raw.stride(-1) != 1:
        raise KernelShapeError("xbc's and dt_raw's last dims must be "
                               "contiguous")
    for name, t in (("dt_bias", dt_bias), ("a_log", a_log),
                    ("d_skip", d_skip)):
        if t.shape != (heads,) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise KernelShapeError(
                f"{name} must be contiguous float32 of shape ({heads},), got "
                f"{t.dtype} {tuple(t.shape)}")
    devices = {t.device for t in (xbc, dt_raw, dt_bias, a_log, d_skip, h)}
    if len(devices) != 1:
        raise KernelShapeError(f"tensors on several devices: {devices}")
    if h.device.type != "cuda":
        raise KernelShapeError(f"the kernel runs on CUDA, not {h.device}")
    if h.data_ptr() % 16:
        raise KernelShapeError("the state must start on 16 bytes")
    return b, heads, p, n


def ssd_update_plain(xbc, dt_raw, dt_bias, a_log, d_skip, h, *,
                     groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: returns (y (B, H * P) in
    ``xbc``'s dtype, the new state (B, H, P, N) float32) and leaves ``h``
    as it is.  ``models/ssm.py``'s recurrence, operation for operation."""
    b = xbc.shape[0]
    hl, pdim, n = h.shape[1], h.shape[2], h.shape[3]
    g = groups
    hg = hl // g                                            # heads a group
    xf = xbc[:, :hl * pdim].reshape(b, g, hg, pdim).float()
    bm = xbc[:, hl * pdim:hl * pdim + g * n].reshape(b, g, n).float()
    cm = xbc[:, hl * pdim + g * n:].reshape(b, g, n).float()
    dt = F.softplus(dt_raw.float() + dt_bias.float()[None])
    a = -torch.exp(a_log.float())
    dec = torch.exp(dt * a[None])                           # (B,H)

    hstate = h * dec[..., None, None] + torch.einsum(
        "bgh,bghp,bgn->bghpn", dt.view(b, g, hg), xf, bm
    ).reshape(b, hl, pdim, n)
    y = torch.einsum("bgn,bghpn->bghp", cm,
                     hstate.view(b, g, hg, pdim, n)).reshape(b, hl, pdim)
    y = y + xf.reshape(b, hl, pdim) * d_skip.float()[None, :, None]
    return y.reshape(b, hl * pdim).to(xbc.dtype), hstate


def ssd_update(xbc: torch.Tensor, dt_raw: torch.Tensor,
               dt_bias: torch.Tensor, a_log: torch.Tensor,
               d_skip: torch.Tensor, h: torch.Tensor, *,
               groups: int) -> torch.Tensor:
    """One recurrent update; writes the new state into ``h`` in place and
    returns ``y`` (B, H * P) in ``xbc``'s dtype.

    Args, as the kernel takes them (CUDA tensors):
      xbc: (B, H * P + 2 * G * N), float32 or bfloat16, the last dim
        contiguous (any batch stride): x, then B, then C.
      dt_raw: (B, H) of ``xbc``'s dtype, the last dim contiguous.
      dt_bias, a_log, d_skip: (H,) float32.
      h: (B, H, P, N) float32, contiguous, starting on 16 bytes, N one of
        :data:`STATE_WIDTHS`.
      groups: G, which divides H.

    CUDA tensors: launches the kernel on the current stream, without
    synchronising (counted as ``ssd_update_kernel``), or raises
    ``KernelShapeError``.  CPU tensors: :func:`ssd_update_plain`, its state
    copied into ``h``, with none of the kernel's limits.
    """
    if h.device.type == "cpu":
        y, hstate = ssd_update_plain(xbc, dt_raw, dt_bias, a_log, d_skip, h,
                                     groups=groups)
        h.copy_(hstate)
        return y
    b, heads, p, n = _geometry(xbc, dt_raw, dt_bias, a_log, d_skip, h,
                               groups)
    y = torch.empty((b, heads * p), dtype=xbc.dtype, device=h.device)
    _LAUNCH(h.device, h.data_ptr(), xbc.data_ptr(), dt_raw.data_ptr(),
            dt_bias.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
            y.data_ptr(), _DTYPE_CODES[xbc.dtype], b, heads, p, n, groups,
            xbc.stride(0), dt_raw.stride(0))
    return y
