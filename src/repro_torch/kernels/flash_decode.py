"""Decode attention as an S1 offloading schedule on an NVIDIA H100:
wrapper, plain PyTorch version and launch counter of the CUDA kernel
``csrc/flash_decode.cu``.

One decoded token attends to a long KV cache.  In the paper's terms: the
query block of one KV head's G grouped query heads is the *kernel set* Λ,
loaded once and resident; the KV cache is the input, cut into disjoint
``bkv``-row *patch groups* (stride == block size, so no halo); each step
loads one K and one V block (I_slice, action a4), computes (a6) with an
online-softmax accumulator held on chip, and the output block is written
once at the end (W at the last step).  ``core.planner.plan_decode_attention``
chooses ``bkv`` under one block's shared memory.

Layout, batched as ``ops.decode_attention`` takes it: q ``(B, H_q, D)``,
k/v ``(B, S, H_kv, D)`` (the cache's own layout, read through strides),
lengths ``(B,)`` int32; query head ``h`` belongs to KV head ``h // G``.
Positions ``>= lengths[b]`` are masked to ``-1e30`` before the softmax, as
the TPU kernel does: a length of 0 gives the plain mean of ``v`` over the
``S`` rows, where the ``-inf`` oracle gives NaN.

The wrapper looks at where its tensors lie.  For CUDA tensors it launches
the kernel, one thread block per ``(b, kv_head)``, or raises; it never gives
way to the plain version.  For CPU tensors it runs
:func:`decode_attention_plain`, which walks the KV blocks in order with the
same online softmax.  Each launch adds one to ``LAUNCHES["flash_decode"]``,
and nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.planner import decode_smem_bytes
from repro_torch.kernels import KernelShapeError
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_offload import SMEM_LIMIT_BYTES

_NEG_INF = -1e30

# Kernel launches so far.  The wrapper adds one where it launches the CUDA
# kernel and nowhere else; the plain version never counts.
LAUNCHES = {"flash_decode": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_specs(g: int, d: int, s: int, bkv: int) -> tuple[int]:
    """The grid of one ``(b, kv_head)``'s walk: ``(S / bkv,)`` KV blocks,
    in order.  q and the output block are resident for the whole walk;
    K and V stream one disjoint ``bkv`` block per step."""
    if g <= 0 or d <= 0 or s <= 0 or bkv <= 0 or s % bkv:
        raise KernelShapeError(
            f"KV length {s} must be a positive multiple of bkv={bkv} "
            f"(ops.decode_attention pads)")
    return (s // bkv,)


def _geometry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lengths: torch.Tensor, bkv: int) -> tuple[int, int, int, int]:
    """Validate what the kernel takes; return (b, h_kv, g, d)."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise KernelShapeError(
            f"want q (B, H_q, D) and k, v (B, S, H_kv, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)} and {tuple(v.shape)}")
    b, h_q, d = q.shape
    b2, s, h_kv, d2 = k.shape
    if b != b2 or d != d2:
        raise KernelShapeError(
            f"q {tuple(q.shape)} and cache {tuple(k.shape)} disagree on "
            f"batch or head dim")
    if h_kv <= 0 or h_q % h_kv:
        raise KernelShapeError(
            f"GQA needs h_q={h_q} divisible by h_kv={h_kv}")
    if q.dtype not in _DTYPE_CODES or k.dtype not in _DTYPE_CODES \
            or v.dtype != k.dtype:
        raise KernelShapeError(
            f"q and the cache must be float32 or bfloat16 (k and v alike), "
            f"got {q.dtype}, {k.dtype} and {v.dtype}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise KernelShapeError(
            f"lengths must be int32 of shape ({b},), got "
            f"{lengths.dtype} {tuple(lengths.shape)}")
    devices = {q.device, k.device, v.device, lengths.device}
    if len(devices) != 1:
        raise KernelShapeError(f"tensors on several devices: {devices}")
    if q.device.type not in ("cuda", "cpu"):
        raise KernelShapeError(f"unsupported device {q.device}")
    decode_specs(h_q // h_kv, d, s, bkv)
    return b, h_kv, h_q // h_kv, d


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           bkv: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_attention`: batch and KV heads
    as tensor dimensions, a Python loop over the ``S / bkv`` KV blocks in
    order carrying ``m``, ``l`` and ``acc`` in float32, exactly the TPU
    kernel's update; ``acc / l`` cast to ``q.dtype`` once at the end."""
    b, h_kv, g, d = _geometry(q, k, v, lengths, bkv)
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, h_kv, g, d).float()
    m = torch.full((b, h_kv, g, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, h_kv, g, 1), device=q.device)
    acc = torch.zeros((b, h_kv, g, d), device=q.device)
    limit = lengths.to(torch.int64).view(b, 1, 1, 1)
    for step in range(decode_specs(g, d, k.shape[1], bkv)[0]):
        rows = slice(step * bkv, (step + 1) * bkv)
        kb = k[:, rows].permute(0, 2, 1, 3).float()       # (B, H_kv, bkv, D)
        vb = v[:, rows].permute(0, 2, 1, 3).float()
        s = (qg @ kb.transpose(-1, -2)) * scale           # (B, H_kv, G, bkv)
        pos = step * bkv + torch.arange(bkv, device=q.device)
        s = torch.where(pos < limit, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vb
        m = m_new
    return (acc / l).to(q.dtype).reshape(q.shape)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, bkv: int) -> torch.Tensor:
    """Batched GQA decode attention over a cache of ``S % bkv == 0`` rows.

    Args:
      q: ``(B, H_q, D)``, contiguous.
      k, v: ``(B, S, H_kv, D)``, any strides with ``D`` contiguous (a
        layer's slice of a stacked cache is read in place).
      lengths: ``(B,)`` int32, valid cache rows per sequence.
      bkv: KV rows per step (``ops.decode_attention`` plans and pads).

    Returns ``(B, H_q, D)`` of ``q.dtype``.  CUDA tensors: launches the
    kernel on the current stream, without synchronising.  CPU tensors:
    :func:`decode_attention_plain`.
    """
    b, h_kv, g, d = _geometry(q, k, v, lengths, bkv)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, bkv=bkv)
    smem = decode_smem_bytes(g, d, bkv, k.element_size())
    if smem > SMEM_LIMIT_BYTES:
        raise KernelShapeError(
            f"a KV block of {bkv} rows needs {smem} bytes of shared memory, "
            f"one block has {SMEM_LIMIT_BYTES}; take a smaller bkv")
    if not q.is_contiguous() or not lengths.is_contiguous() \
            or k.stride(-1) != 1 or k.stride() != v.stride():
        raise KernelShapeError(
            "q and lengths must be contiguous, and k and v share strides "
            "with the head dim contiguous")
    out = torch.empty_like(q)
    launch = _build.bind(
        "flash_decode", "flash_decode_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 5 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lengths.data_ptr(), out.data_ptr(),
                      _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], b,
                      k.shape[1], h_kv, g, d, bkv, q.stride(0), q.stride(1),
                      k.stride(0), k.stride(1), k.stride(2), 1.0 / (d ** 0.5),
                      torch.cuda.current_stream().cuda_stream)
    _build.check("flash_decode", code, "flash_decode launch")
    LAUNCHES["flash_decode"] += 1
    return out
