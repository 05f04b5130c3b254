"""Decode attention as an S1 offloading schedule on an NVIDIA H100:
wrappers and plain PyTorch versions of the CUDA kernel pair in
``csrc/flash_decode.cu``.

One decoded token attends to a long KV cache.  In the paper's terms: the
query block of one KV head's G grouped query heads is the *kernel set* Λ,
loaded once and resident; the KV cache is the input, cut into disjoint
``bkv``-row *patch groups* (stride == block size, so no halo); each step
loads one K and one V block (I_slice, action a4), computes (a6) with an
online-softmax accumulator held on chip, and the output block is written
once at the end (W at the last step).

On the card the walk over a cache is cut into ``splits`` contiguous ranges
of ``S / splits`` rows (a multiple of ``bkv``), one thread block each: the
split kernel walks its range and writes a partial ``(acc, m, l)`` in f32 to
a workspace ``(B, H_kv, splits, G, D + 2)``, and the combine kernel
rescales the partials by ``exp(m_s - max m)``, sums them and writes
``acc / l``.  With one split the split kernel writes ``acc / l`` itself and
no combine runs.  ``core.planner.plan_decode_split`` chooses ``splits``
(``bkv``, the padding grain of a range, is 16 rows on the card); each block
streams its range in tiles through the ring ``core.planner.decode_ring``
sizes from the shape alone.

Layout, batched as ``ops.decode_attention`` takes it: q ``(B, H_q, D)``,
k/v ``(B, S, H_kv, D)`` (the cache's own layout, read through strides),
lengths ``(B,)`` int32; query head ``h`` belongs to KV head ``h // G``.
Positions ``>= lengths[b]`` are masked to ``-1e30`` before the softmax, as
the TPU kernel does: a length of 0 gives the plain mean of ``v`` over the
``S`` rows, where the ``-inf`` oracle gives NaN.

The wrappers look at where their tensors lie.  For CUDA tensors they launch
the kernels or raise; they never give way to the plain versions.  For CPU
tensors they run the plain versions: :func:`decode_partials_plain` (the
split kernel's: each range walked in order with the TPU kernel's online
softmax) and :func:`decode_combine_plain` (the combine's), composed by
:func:`decode_attention_plain`.  In ``obs.counters``, ``flash_decode``
counts launches of the split kernel (one per call of
:func:`decode_attention` or :func:`decode_partials`, whatever the splits)
and ``flash_decode_combine`` launches of the combine; the plain versions
never count.  A split launch whose scores run on the tensor cores (a bf16
q and cache, ``core.planner.decode_mma``) counts under ``flash_decode_mma``
too.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import planner
from repro_torch.kernels import KernelShapeError
from repro_torch.kernels import _build
from repro_torch.obs import counters

_NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SPLIT = _build.Launcher(
    "flash_decode", "flash_decode_split_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_longlong] * 5
    + [ctypes.c_float, ctypes.c_void_p], "flash_decode")
_COMBINE = _build.Launcher(
    "flash_decode", "flash_decode_combine_launch",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2
    + [ctypes.c_void_p], "flash_decode_combine")
# A lane of the split kernel holds 16 bytes of a row, and at most a warp
# shares one row (csrc/flash_decode.cu, flash_decode_shape_ok).
MAX_ROW_VECTORS = 32


def _scale(d: int, scale: float | None) -> float:
    """The scores' factor: ``scale``, or ``D ** -0.5`` when None."""
    return 1.0 / (d ** 0.5) if scale is None else scale


def decode_specs(g: int, d: int, s: int, bkv: int, splits: int = 1
                 ) -> tuple[int, int]:
    """The grid of one ``(b, kv_head)``: ``(splits, S / (splits * bkv))``,
    contiguous ranges of the cache each walked in ``bkv``-row blocks, in
    order.  q is resident for the whole walk; K and V stream one disjoint
    ``bkv`` block per step."""
    if g <= 0 or d <= 0 or s <= 0 or bkv <= 0 or splits <= 0 \
            or s % (bkv * splits):
        raise KernelShapeError(
            f"KV length {s} must be a positive multiple of bkv={bkv} "
            f"times splits={splits} (ops.decode_attention pads)")
    return splits, s // (bkv * splits)


def _geometry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lengths: torch.Tensor, bkv: int, splits: int
              ) -> tuple[int, int, int, int]:
    """Validate what the kernels take; return (b, h_kv, g, d)."""
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
    decode_specs(h_q // h_kv, d, s, bkv, splits)
    return b, h_kv, h_q // h_kv, d


def decode_partials_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lengths: torch.Tensor, *,
                          bkv: int, splits: int,
                          scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the split kernel: the workspace
    ``(B, H_kv, splits, G, D + 2)`` f32 of ``(acc, m, l)`` per range.

    Each range of ``S / splits`` rows is walked in ``bkv`` blocks in order,
    carrying ``m``, ``l`` and ``acc`` in f32 with the TPU kernel's update
    (the ranges are a tensor dimension).  A range that lies wholly past a
    length ``>= 1`` holds ``(0, -1e30, 0)``, as the kernel writes for it
    without reading its rows."""
    b, h_kv, g, d = _geometry(q, k, v, lengths, bkv, splits)
    _, steps = decode_specs(g, d, k.shape[1], bkv, splits)
    rng = k.shape[1] // splits
    scale = _scale(d, scale)
    qg = q.reshape(b, 1, h_kv, g, d).float()
    shape = (b, splits, h_kv, g, 1)
    m = torch.full(shape, _NEG_INF, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros((b, splits, h_kv, g, d), device=q.device)
    limit = lengths.to(torch.int64).view(b, 1, 1, 1, 1)
    start = (torch.arange(splits, device=q.device) * rng).view(splits, 1, 1, 1)
    ks = k.reshape(b, splits, rng, h_kv, d)
    vs = v.reshape(b, splits, rng, h_kv, d)
    for step in range(steps):
        rows = slice(step * bkv, (step + 1) * bkv)
        kb = ks[:, :, rows].permute(0, 1, 3, 2, 4).float()  # (B,sp,Hkv,bkv,D)
        vb = vs[:, :, rows].permute(0, 1, 3, 2, 4).float()
        sc = (qg @ kb.transpose(-1, -2)) * scale           # (B,sp,Hkv,G,bkv)
        pos = start + step * bkv + torch.arange(bkv, device=q.device)
        sc = torch.where(pos < limit, sc, torch.full_like(sc, _NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vb
        m = m_new
    past = ((limit >= 1) & (start >= limit)).view(b, splits, 1, 1, 1)
    m = torch.where(past, torch.full_like(m, _NEG_INF), m)
    l = torch.where(past, torch.zeros_like(l), l)
    acc = torch.where(past, torch.zeros_like(acc), acc)
    part = torch.cat([acc, m, l], dim=-1)                  # (B,sp,Hkv,G,D+2)
    return part.permute(0, 2, 1, 3, 4).contiguous()


def decode_combine_plain(part: torch.Tensor, dtype: torch.dtype
                         ) -> torch.Tensor:
    """Plain PyTorch version of the combine kernel: from the workspace
    ``(B, H_kv, splits, G, D + 2)`` to ``(B, H_kv * G, D)`` of ``dtype``,
    ``sum_s w_s acc_s / sum_s w_s l_s`` with ``w_s = exp(m_s - max m)``."""
    b, h_kv, _, g, d2 = part.shape
    acc, m, l = part[..., :-2], part[..., -2:-1], part[..., -1:]
    w = torch.exp(m - m.amax(dim=2, keepdim=True))
    out = (w * acc).sum(dim=2) / (w * l).sum(dim=2)
    return out.to(dtype).reshape(b, h_kv * g, d2 - 2)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           bkv: int, splits: int = 1,
                           scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_attention`, the kernel pair:
    :func:`decode_partials_plain` then :func:`decode_combine_plain`.  With
    one split it is the TPU kernel's walk over the ``S / bkv`` blocks in
    order, ``acc / l`` cast to ``q.dtype`` once at the end."""
    part = decode_partials_plain(q, k, v, lengths, bkv=bkv, splits=splits,
                                 scale=scale)
    return decode_combine_plain(part, q.dtype)


@functools.lru_cache(maxsize=256)
def ring(g: int, d: int, kv_bytes: int) -> tuple[int, int, int]:
    """The split kernel's ``(tile, stages, warps)`` at this shape
    (``core.planner.decode_ring``); cached."""
    r = planner.decode_ring(g, d, kv_bytes)
    return r["tile"], r["stages"], r["warps"]


def uses_mma(q_dtype: torch.dtype, kv_dtype: torch.dtype, g: int,
             d: int) -> bool:
    """Whether a split launch at this shape scores on the tensor cores: a
    bf16 q against a bf16 cache where ``core.planner.decode_mma`` holds
    and the ring's tile is a multiple of the MMA's 8 rows."""
    kv_bytes = torch.finfo(kv_dtype).bits // 8
    return q_dtype == torch.bfloat16 and planner.decode_mma(g, d, kv_bytes) \
        and ring(g, d, kv_bytes)[0] % 8 == 0


def occupancy(q_dtype: torch.dtype, kv_dtype: torch.dtype, g: int,
              d: int) -> dict[str, int]:
    """The split kernel's instance at this shape and its ring, on the
    current card: ``blocks`` resident an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), ``regs`` and
    ``local_bytes`` (spills) a thread."""
    kv_bytes = torch.finfo(kv_dtype).bits // 8
    fn = _build.bind("flash_decode", "flash_decode_occupancy",
                     [ctypes.c_int] * 8 + [ctypes.c_void_p])
    out = (ctypes.c_int * 3)()
    code = fn(_DTYPE_CODES[q_dtype], _DTYPE_CODES[kv_dtype], g, d,
              *ring(g, d, kv_bytes), int(uses_mma(q_dtype, kv_dtype, g, d)),
              out)
    if code:
        raise RuntimeError(f"flash_decode_occupancy: CUDA error {code}")
    return {"blocks": out[0], "regs": out[1], "local_bytes": out[2]}


def _check_for_the_kernels(q, k, v, lengths, g, d, bkv) -> None:
    """What the CUDA kernels take beyond :func:`_geometry`; raises."""
    vec = 16 // k.element_size()
    if d % vec or d > MAX_ROW_VECTORS * vec:
        raise KernelShapeError(
            f"the kernel takes a head dim that is a multiple of {vec} (16 "
            f"bytes of {k.dtype}) up to {MAX_ROW_VECTORS * vec}, got D={d}")
    if bkv % 16:
        raise KernelShapeError(f"the kernel takes bkv in multiples of 16, "
                               f"got {bkv}")
    if not q.is_contiguous() or not lengths.is_contiguous() \
            or k.stride(-1) != 1 or k.stride() != v.stride():
        raise KernelShapeError(
            "q and lengths must be contiguous, and k and v share strides "
            "with the head dim contiguous")
    if any(t.data_ptr() % 16 for t in (k, v)) or \
            any(st * k.element_size() % 16 for st in k.stride()[:3]):
        raise KernelShapeError(
            "the cache's rows must start on 16 bytes (data pointers and "
            "batch, position and head strides)")


def decode_combine(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Combine the workspace ``(B, H_kv, splits, G, D + 2)`` f32 into
    ``(B, H_kv * G, D)`` of ``dtype``.  CUDA tensors: launches the combine
    kernel (counted as ``flash_decode_combine``); CPU tensors:
    :func:`decode_combine_plain`."""
    if part.dim() != 5 or part.dtype != torch.float32 \
            or not part.is_contiguous() or dtype not in _DTYPE_CODES:
        raise KernelShapeError(
            f"want a contiguous float32 workspace (B, H_kv, splits, G, "
            f"D + 2) and an output dtype of {list(_DTYPE_CODES)}, got "
            f"{part.dtype} {tuple(part.shape)} and {dtype}")
    if part.device.type == "cpu":
        return decode_combine_plain(part, dtype)
    b, h_kv, splits, g, d2 = part.shape
    out = torch.empty((b, h_kv * g, d2 - 2), dtype=dtype, device=part.device)
    _COMBINE(part.device, part.data_ptr(), out.data_ptr(),
             _DTYPE_CODES[dtype], b, h_kv, g, d2 - 2, splits, out.stride(0),
             out.stride(1))
    return out


def _launch_split(q, k, v, lengths, out, part, *, bkv: int,
                  splits: int, scale: float | None = None) -> None:
    """The split kernel on the current stream: ``acc / l`` into ``out``
    (``part`` None, one split), or every split's partial into ``part``."""
    b, h_kv, g, d = _geometry(q, k, v, lengths, bkv, splits)
    _check_for_the_kernels(q, k, v, lengths, g, d, bkv)
    tile, stages, warps = ring(g, d, k.element_size())
    mma = uses_mma(q.dtype, k.dtype, g, d)
    _SPLIT(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           lengths.data_ptr(), None if out is None else out.data_ptr(),
           None if part is None else part.data_ptr(), _DTYPE_CODES[q.dtype],
           _DTYPE_CODES[k.dtype], b, k.shape[1], h_kv, g, d, bkv, splits,
           tile, stages, warps, int(mma), q.stride(0), q.stride(1),
           k.stride(0), k.stride(1), k.stride(2), _scale(d, scale))
    if mma:
        counters.count("flash_decode_mma")


def _workspace(q, k, splits: int) -> torch.Tensor:
    b, h_q, d = q.shape
    h_kv = k.shape[2]
    return torch.empty((b, h_kv, splits, h_q // h_kv, d + 2),
                       dtype=torch.float32, device=q.device)


def decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, *, bkv: int,
                    splits: int = 1) -> torch.Tensor:
    """The split kernel alone: the workspace ``(B, H_kv, splits, G,
    D + 2)`` f32 of every range's partial ``(acc, m, l)``, also for one
    split, for :func:`decode_combine` to finish, possibly beside other
    caches' partials along the splits dim (a cache whose sequence is
    split over devices: each device's rows, their partials gathered).
    Takes what :func:`decode_attention` takes.  CUDA tensors: launches
    the split kernel (counted as ``flash_decode``); CPU
    tensors: :func:`decode_partials_plain`."""
    _geometry(q, k, v, lengths, bkv, splits)
    if q.device.type == "cpu":
        return decode_partials_plain(q, k, v, lengths, bkv=bkv,
                                     splits=splits)
    part = _workspace(q, k, splits)
    _launch_split(q, k, v, lengths, None, part, bkv=bkv, splits=splits)
    return part


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, bkv: int,
                     splits: int = 1, scale: float | None = None
                     ) -> torch.Tensor:
    """Batched GQA decode attention over a cache of
    ``S % (splits * bkv) == 0`` rows.

    Args:
      q: ``(B, H_q, D)``, contiguous.
      k, v: ``(B, S, H_kv, D)``, any strides with ``D`` contiguous and rows
        on 16 bytes (a layer's slice of a stacked cache is read in place).
      lengths: ``(B,)`` int32, valid cache rows per sequence.
      bkv: KV rows per step (``ops.decode_attention`` plans and pads).
      splits: blocks that share one ``(b, kv_head)``'s cache.
      scale: the scores' factor (None: ``D ** -0.5``).

    Returns ``(B, H_q, D)`` of ``q.dtype``.  CUDA tensors: launches the
    split kernel, and with ``splits > 1`` the combine, on the current
    stream, without synchronising.  CPU tensors:
    :func:`decode_attention_plain`.
    """
    _geometry(q, k, v, lengths, bkv, splits)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, bkv=bkv,
                                      splits=splits, scale=scale)
    if splits == 1:     # one split writes acc / l itself
        out = torch.empty_like(q)
        _launch_split(q, k, v, lengths, out, None, bkv=bkv, splits=1,
                      scale=scale)
        return out
    part = _workspace(q, k, splits)
    _launch_split(q, k, v, lengths, None, part, bkv=bkv, splits=splits,
                  scale=scale)
    return decode_combine(part, q.dtype)
