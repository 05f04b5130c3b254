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
from repro_torch.kernels import KernelShapeError
from repro_torch.kernels import block_matmul as _bm
from repro_torch.kernels import conv2d_offload as _conv
from repro_torch.kernels import flash_decode as _fd


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero rows appended along ``axis`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


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


@functools.lru_cache(maxsize=256)
def _planned_matmul(m: int, n: int, k: int, dtype_bytes: int
                    ) -> tuple[int, int, int, str, tuple[int, int]]:
    """The planner's (bm, bn, bk, order, K3 cluster) for a product;
    cached."""
    p = planner.plan_matmul(m, n, k, dtype_bytes=dtype_bytes)
    return p.tiles["bm"], p.tiles["bn"], p.tiles["bk"], p.order, p.cluster


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int | None = None,
           bn: int | None = None, bk: int | None = None,
           order: str | None = None) -> torch.Tensor:
    """Planner-scheduled block GeMM: a (m, k) @ b (k, n) -> (m, n).  What
    the caller leaves as None comes from the plan, each tile clamped to
    the next power of two of its dim, and to no less than 16, the block
    GeMM kernel's grain; A and B are padded with zeros to multiples of
    the tiles and the result cut back.  K3 runs on the plan's cluster
    when the tiles and order are the plan's, else on one block a
    cluster."""
    if a.dim() != 2 or b.dim() != 2:
        raise KernelShapeError(
            f"want A (m, k) and B (k, n), got {tuple(a.shape)} and "
            f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    cluster = (1, 1)
    if bm is None or bn is None or bk is None or order is None:
        planned = _planned_matmul(m, n, k, a.element_size())
        p_bm, p_bn, p_bk, p_order, p_cluster = planned
        bm = bm or min(p_bm, 1 << (max(m, 16) - 1).bit_length())
        bn = bn or min(p_bn, 1 << (max(n, 16) - 1).bit_length())
        bk = bk or min(p_bk, 1 << (max(k, 16) - 1).bit_length())
        order = order or p_order
        if (bm, bn, bk, order) == planned[:4]:
            cluster = p_cluster
    a = _pad_to(_pad_to(a, 0, bm), 1, bk).contiguous()
    b = _pad_to(_pad_to(b, 0, bk), 1, bn).contiguous()
    out = _bm.block_matmul(a, b, bm=bm, bn=bn, bk=bk, order=order,
                           cluster=cluster)
    return out[:m, :n]


@functools.lru_cache(maxsize=256)
def _planned_split(s: int, d: int, g: int, heads: int, dtype_bytes: int
                   ) -> tuple[int, int]:
    """The planner's (bkv, splits) for ``heads`` = batch x KV heads
    caches of ``s`` rows; cached."""
    p = planner.plan_decode_split(s, d, g, heads, dtype_bytes)
    return p.tiles["bkv"], p.tiles["splits"]


def decode_cache_rows(s: int, d: int, g: int, heads: int,
                      dtype_bytes: int = 2) -> int:
    """The rows to give a cache of ``s`` valid rows (``heads`` = batch x
    KV heads, ``g`` query rows per KV head) so that
    :func:`decode_attention` reads it in place: the least multiple of the
    planner's ``splits * bkv`` at or above ``s`` whose own plan divides it
    (a longer cache may plan other splits)."""
    rows = s
    while True:
        bkv, splits = _planned_split(rows, d, g, heads, dtype_bytes)
        if rows % (bkv * splits) == 0:
            return rows
        rows += (-rows) % (bkv * splits)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor | None = None, *,
                     bkv: int | None = None, scale: float | None = None
                     ) -> torch.Tensor:
    """Batched GQA decode attention over a (padded) KV cache.

    q: (B, H_q, D); k/v: (B, S, H_kv, D); lengths: (B,) int32 valid cache
    lengths on q's device (None: all S rows).  Returns (B, H_q, D).

    Batch, KV heads and the ``splits`` ranges of each cache go to the
    kernels' grid; the cache is read in its own layout.  ``bkv=None`` asks
    the planner for ``bkv`` and ``splits`` together
    (``planner.plan_decode_split``); a pinned ``bkv`` walks each cache in
    one range.  When ``splits * bkv`` does not divide S, k and v are
    padded with zero rows up to a multiple of it, which the lengths mask
    hides (for a length of 0 the result is then the mean of ``v`` over the
    padded rows); otherwise nothing is copied.  ``scale`` multiplies the
    scores (None: ``D ** -0.5``), an argument of the kernel.
    """
    if q.dim() != 3 or k.dim() != 4:
        raise KernelShapeError(
            f"want q (B, H_q, D) and k, v (B, S, H_kv, D), got "
            f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h_q, d = q.shape
    s, h_kv = k.shape[1], k.shape[2]
    if h_kv <= 0 or h_q % h_kv != 0:
        raise KernelShapeError(
            f"GQA needs h_q={h_q} divisible by h_kv={h_kv}")
    splits = 1
    if bkv is None:
        bkv, splits = _planned_split(s, d, h_q // h_kv, b * h_kv,
                                     k.element_size())
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    k = _pad_to(k, 1, bkv * splits)
    v = _pad_to(v, 1, bkv * splits)
    return _fd.decode_attention(q, k, v, lengths, bkv=bkv, splits=splits,
                                scale=scale)


def decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, *, rows: int | None = None
                    ) -> torch.Tensor:
    """The split kernel's partials ``(B, H_kv, splits, G, D + 2)`` f32 of
    one shard of a cache whose sequence is split over devices, for
    :func:`decode_combine` once every shard's partials are gathered along
    dim 2.

    q, k, v and ``lengths`` as :func:`decode_attention` takes them, the
    lengths counted from this shard's first row (0 where the shard lies
    wholly past them: its partials then get no weight in the combine).
    ``rows`` (at least S): the rows to plan for; every shard plans for
    the largest shard's rows and pads its own to the plan's multiple, so
    that all shards give the same splits.
    """
    b, h_q, d = q.shape
    s, h_kv = k.shape[1], k.shape[2]
    if h_kv <= 0 or h_q % h_kv != 0:
        raise KernelShapeError(
            f"GQA needs h_q={h_q} divisible by h_kv={h_kv}")
    rows = max(rows or s, s)
    bkv, splits = _planned_split(rows, d, h_q // h_kv, b * h_kv,
                                 k.element_size())
    walk = rows + (-rows) % (bkv * splits)
    if walk > s:
        widths = [0, 0] * (k.dim() - 2) + [0, walk - s]
        k, v = F.pad(k, widths), F.pad(v, widths)
    return _fd.decode_partials(q, k, v, lengths, bkv=bkv, splits=splits)


def decode_combine(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Partials ``(B, H_kv, splits, G, D + 2)`` f32 into the attention
    ``(B, H_kv * G, D)`` of ``dtype``: the combine kernel on the card."""
    return _fd.decode_combine(part.contiguous(), dtype)
