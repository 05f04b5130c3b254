"""S1 convolution offloading (paper Sec 4) on an NVIDIA H100: wrappers,
plain PyTorch versions and launch counters of the two CUDA kernels.

Strategy S1 mapped to the card's memory hierarchy:

  * **K_sub / kernel residency** — all kernels Λ, laid out
    ``(C_in*H_K*W_K, N)``, are fetched once and serve the whole sweep
    ("loaded during the first step and never freed until the last step",
    Def 16).
  * **I_slice** — the input lives in device memory (the paper's DRAM);
    each grid step fetches its patch-group window, or only the part of it
    that is new, into shared memory — action a4.
  * **patch groups** — one step computes a row-run of T output columns for
    *all* C_out channels (Property 1).  Grid order is zigzag (paper Sec
    7.2) or row-by-row.
  * **W / write-back** — the step's (C_out, 1, T) output block goes to
    device memory when the step ends — action a3.

Two kernels share the geometry helpers below:

* :func:`conv2d_offload` (``csrc/conv2d_offload.cu``) — the simple kernel
  behind ``ops.conv2d``: one thread block per grid step, each fetching its
  *full* ``(C_in, H_K, t_in)`` window and waiting on it.  Correct, but it
  re-fetches the ``w_k - s_w`` columns (and, across rows, the
  ``h_k - s_h`` rows) shared with the previous step — traffic the plan's
  Def-3 ``I_slice`` accounting does *not* charge.
* :func:`conv2d_offload_planned` (``csrc/conv2d_offload_planned.cu``) —
  the plan-shaped kernel ``kernels.emit`` maps ``LayerPlan``s onto: one
  thread block walks the plan's ordered sweep, the window stays resident
  in shared memory and each step fetches only its **I_slice delta** (new
  columns within a row, new rows at a zigzag row turn), prefetched one
  step ahead into a separate delta buffer.

Each wrapper looks at where its tensors lie.  For CUDA tensors it launches
the hand-written kernel, or raises; it never gives way to the plain
version.  For CPU tensors it runs the plain PyTorch version beside it,
which does step by step what the kernel does, with tensor slicing for the
fetches and ``patches.float() @ lam.float()`` for the product.  Each
launch of a kernel adds one to its module-level counter
(``LAUNCHES``), and nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import KernelShapeError
from repro_torch.kernels import _build

# Step cases of the planned kernel.
CASE_FULL = "full"          # fetch the whole window (first step / no overlap)
CASE_ROW = "row-delta"      # zigzag row turn: fetch the s_h new rows
CASE_COL = "col-delta"      # within-row move: fetch the t_run*s_w new cols

# Dynamic shared memory one thread block can ask for on sm_90.
SMEM_LIMIT_BYTES = 232_448

# Kernel launches so far, by kernel.  A wrapper adds one where it launches
# its CUDA kernel and nowhere else; the plain versions never count.
LAUNCHES = {"conv2d_offload": 0, "conv2d_offload_planned": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------- #
# Shared grid geometry: plain integer arithmetic.  The CUDA sources
# evaluate the same formulas (csrc/conv_common.cuh); this module stays the
# single source of the step structure.
# --------------------------------------------------------------------- #

def t_in_cols(t_run: int, s_w: int, w_k: int) -> int:
    """Input columns covered by a ``t_run``-patch row-run."""
    return (t_run - 1) * s_w + w_k


def eff_tile(i: int, jt: int, w_out_tiles: int, zigzag: bool) -> int:
    """Physical column-tile index of grid step ``(i, jt)``: zigzag
    reverses odd rows."""
    if not zigzag:
        return jt
    return jt + (i % 2) * (w_out_tiles - 1 - 2 * jt)


def moving_right(i: int, zigzag: bool) -> bool:
    """Whether within-row steps of row ``i`` advance left-to-right."""
    if not zigzag:
        return True
    return i % 2 == 0


def grid_sequence(h_out: int, w_out_tiles: int) -> list[tuple[int, int]]:
    """The sweep's sequential step order: last axis fastest."""
    return [(i, jt) for i in range(h_out) for jt in range(w_out_tiles)]


def step_case(i: int, jt: int, *, t_run: int, s_h: int, s_w: int,
              h_k: int, w_k: int, w_out_tiles: int, order: str) -> str:
    """Which I_slice the planned kernel fetches at grid step ``(i, jt)``.

    The first step and any step whose window is disjoint from its
    predecessor's fetch the full window; a zigzag row turn (same column
    window, one stride down) fetches only the new rows; a within-row move
    fetches only the new columns.  Row order with more than one column
    tile jumps back to the row's left edge at each turn — a (mostly)
    disjoint window, fetched in full."""
    zig = order == "zigzag"
    if i == 0 and jt == 0:
        return CASE_FULL
    if jt == 0:                                   # row turn
        if (zig or w_out_tiles == 1) and h_k > s_h:
            return CASE_ROW
        return CASE_FULL
    if t_in_cols(t_run, s_w, w_k) > t_run * s_w:  # windows share columns
        return CASE_COL
    return CASE_FULL


def step_fetch_box(i: int, jt: int, *, t_run: int, s_h: int, s_w: int,
                   h_k: int, w_k: int, w_out_tiles: int, order: str
                   ) -> tuple[str, int, int, int, int]:
    """``(case, h0, h1, w0, w1)``: the half-open input box (all channels)
    that grid step ``(i, jt)`` of the planned kernel fetches."""
    zig = order == "zigzag"
    case = step_case(i, jt, t_run=t_run, s_h=s_h, s_w=s_w, h_k=h_k,
                     w_k=w_k, w_out_tiles=w_out_tiles, order=order)
    t_in = t_in_cols(t_run, s_w, w_k)
    nw = t_run * s_w
    h0 = i * s_h
    w0 = eff_tile(i, jt, w_out_tiles, zig) * nw
    if case == CASE_ROW:
        return case, h0 + h_k - s_h, h0 + h_k, w0, w0 + t_in
    if case == CASE_COL:
        off = (t_in - nw) * int(moving_right(i, zig))
        return case, h0, h0 + h_k, w0 + off, w0 + off + nw
    return case, h0, h0 + h_k, w0, w0 + t_in


def _conv_geometry(x: torch.Tensor, w: torch.Tensor, t_run: int,
                   s_h: int, s_w: int) -> tuple[int, int, int, int, int]:
    """Validate shapes; return (n, h_k, w_k, h_out, w_out_tiles)."""
    c_in, h_in, w_in = x.shape
    n, c_in2, h_k, w_k = w.shape
    if c_in != c_in2:
        raise KernelShapeError(
            f"input has {c_in} channels but kernels expect {c_in2}")
    h_out = (h_in - h_k) // s_h + 1
    w_out = (w_in - w_k) // s_w + 1
    if h_out <= 0 or w_out <= 0:
        raise KernelShapeError(
            f"kernel {h_k}x{w_k} does not fit input {h_in}x{w_in}")
    if t_run <= 0 or w_out % t_run != 0:
        raise KernelShapeError(
            f"t_run={t_run} must divide w_out={w_out} "
            f"(ops.conv2d pads/chooses for you)")
    return n, h_k, w_k, h_out, w_out // t_run


def planned_smem_elements(c_in: int, n: int, h_k: int, w_k: int,
                          s_h: int, s_w: int, t_run: int) -> int:
    """Shared-memory elements the planned kernel's one block allocates: Λ,
    the resident window, the column-delta buffer and the row-delta buffer
    (``max(1, min(s_h, h_k))`` rows).  No output is staged in shared
    memory.  ``conv2d_offload_planned_smem_elements`` in the CUDA source
    is the same formula."""
    t_in = t_in_cols(t_run, s_w, w_k)
    nw = t_run * s_w
    lam = c_in * h_k * w_k * n
    win = c_in * h_k * t_in
    col = c_in * h_k * nw
    row = c_in * max(1, min(s_h, h_k)) * t_in
    return lam + win + col + row


def _check_tensors(x: torch.Tensor, w: torch.Tensor, order: str) -> None:
    """What both kernels take: a 3-D input and 4-D kernels of one dtype
    (float32 or bfloat16) on one device, contiguous, a known order."""
    if order not in ("zigzag", "row"):
        raise KernelShapeError(f"unknown grid order {order!r}")
    if x.dim() != 3 or w.dim() != 4:
        raise KernelShapeError(
            f"want x (C_in, H_in, W_in) and w (N, C_in, H_K, W_K), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODES:
        raise KernelShapeError(
            f"x and w must both be float32 or both bfloat16, got "
            f"{x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise KernelShapeError(
            f"x is on {x.device} but w is on {w.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise KernelShapeError(f"unsupported device {x.device}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise KernelShapeError("x and w must be contiguous")


def _lambda_matrix(w: torch.Tensor) -> torch.Tensor:
    """Λ as the kernels read it: ``(C_in*H_K*W_K, N)``, contiguous."""
    return w.reshape(w.shape[0], -1).t().contiguous()


def _patches(win: torch.Tensor, t_run: int, s_w: int, w_k: int
             ) -> torch.Tensor:
    """im2col of a ``(C_in, H_K, t_in)`` window: ``(T, C_in*H_K*W_K)``."""
    return torch.stack([win[:, :, t * s_w:t * s_w + w_k].reshape(-1)
                        for t in range(t_run)], dim=0)


def _step_product(win: torch.Tensor, lam: torch.Tensor, out: torch.Tensor,
                  i: int, tile: int, t_run: int, s_w: int, w_k: int) -> None:
    """One step's product in f32, cast at the store, written as the
    ``(N, 1, T)`` block of row ``i``, column tile ``tile``."""
    prod = _patches(win, t_run, s_w, w_k).float() @ lam.float()   # (T, N)
    out[:, i, tile * t_run:(tile + 1) * t_run] = prod.t().to(out.dtype)


# --------------------------------------------------------------------- #
# Simple kernel: full window every step
# --------------------------------------------------------------------- #

def conv2d_offload_plain(x: torch.Tensor, w: torch.Tensor, *, t_run: int,
                         s_h: int = 1, s_w: int = 1, order: str = "zigzag"
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv2d_offload`: a Python loop over
    the grid, each step slicing its full window out of ``x``."""
    _check_tensors(x, w, order)
    n, h_k, w_k, h_out, tiles = _conv_geometry(x, w, t_run, s_h, s_w)
    t_in = t_in_cols(t_run, s_w, w_k)
    lam = _lambda_matrix(w)
    out = torch.empty((n, h_out, tiles * t_run), dtype=x.dtype,
                      device=x.device)
    for i, jt_raw in grid_sequence(h_out, tiles):
        jt = eff_tile(i, jt_raw, tiles, order == "zigzag")
        h0, w0 = i * s_h, jt * t_run * s_w
        win = x[:, h0:h0 + h_k, w0:w0 + t_in]
        _step_product(win, lam, out, i, jt, t_run, s_w, w_k)
    return out


def conv2d_offload(x: torch.Tensor, w: torch.Tensor, *, t_run: int,
                   s_h: int = 1, s_w: int = 1, order: str = "zigzag"
                   ) -> torch.Tensor:
    """S1 convolution, full window fetched at every step.

    Args:
      x: input (C_in, H_in, W_in) — already padded (paper Remark 2).
      w: kernels (N, C_in, H_K, W_K).
      t_run: patches per step (row-run length); ``W_out % t_run == 0``
        (``ops.conv2d`` pads/chooses for you).
      order: "zigzag" (paper Sec 7.2) or "row" grid sweep.

    It re-fetches the window overlap of neighbouring steps, so its traffic
    is *not* the plan's Def-3 ``I_slice`` accounting; see
    :func:`conv2d_offload_planned` for the kernel whose traffic is.

    CUDA tensors: launches the kernel on the current stream, without
    synchronising.  CPU tensors: :func:`conv2d_offload_plain`.
    """
    _check_tensors(x, w, order)
    if x.device.type == "cpu":
        return conv2d_offload_plain(x, w, t_run=t_run, s_h=s_h, s_w=s_w,
                                    order=order)
    n, h_k, w_k, h_out, tiles = _conv_geometry(x, w, t_run, s_h, s_w)
    c_in, h_in, w_in = x.shape
    smem = c_in * h_k * t_in_cols(t_run, s_w, w_k) * x.element_size()
    if smem > SMEM_LIMIT_BYTES:
        raise KernelShapeError(
            f"window of {smem} bytes exceeds one block's shared memory "
            f"({SMEM_LIMIT_BYTES} bytes); choose a smaller t_run")
    lam = _lambda_matrix(w)
    out = torch.empty((n, h_out, tiles * t_run), dtype=x.dtype,
                      device=x.device)
    launch = _build.bind(
        "conv2d_offload", "conv2d_offload_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        code = launch(x.data_ptr(), lam.data_ptr(), out.data_ptr(),
                      _DTYPE_CODES[x.dtype], c_in, h_in, w_in, n, h_k, w_k,
                      s_h, s_w, t_run, h_out, tiles, int(order == "zigzag"),
                      torch.cuda.current_stream().cuda_stream)
    _build.check("conv2d_offload", code, "conv2d_offload launch")
    LAUNCHES["conv2d_offload"] += 1
    return out


# --------------------------------------------------------------------- #
# Planned kernel: resident window + prefetched I_slice deltas
# --------------------------------------------------------------------- #

def conv2d_offload_planned_plain(x: torch.Tensor, w: torch.Tensor, *,
                                 t_run: int, s_h: int = 1, s_w: int = 1,
                                 order: str = "zigzag",
                                 return_fetches: bool = False):
    """Plain PyTorch version of :func:`conv2d_offload_planned`.

    A Python loop over the grid that keeps a real ``(C_in, H_K, t_in)``
    window tensor and, at each step, slices out of ``x`` only the box
    :func:`step_fetch_box` names, splicing it into the window after the
    kept rows or columns were moved (the moves read the kept part as a
    value first, as the kernel reads it into registers).  With
    ``return_fetches`` it also returns the per-step
    ``(case, h0, h1, w0, w1)`` boxes it really sliced, so that a test can
    hold the fetch sequence against the plan's charged loads.
    """
    _check_tensors(x, w, order)
    n, h_k, w_k, h_out, tiles = _conv_geometry(x, w, t_run, s_h, s_w)
    zig = order == "zigzag"
    t_in = t_in_cols(t_run, s_w, w_k)
    nw = t_run * s_w
    ov_w = t_in - nw
    keep_rows = h_k - s_h
    lam = _lambda_matrix(w)
    out = torch.empty((n, h_out, tiles * t_run), dtype=x.dtype,
                      device=x.device)
    win = torch.zeros((x.shape[0], h_k, t_in), dtype=x.dtype,
                      device=x.device)
    fetches = []
    for i, jt_raw in grid_sequence(h_out, tiles):
        case, h0, h1, w0, w1 = step_fetch_box(
            i, jt_raw, t_run=t_run, s_h=s_h, s_w=s_w, h_k=h_k, w_k=w_k,
            w_out_tiles=tiles, order=order)
        fetched = x[:, h0:h1, w0:w1]
        fetches.append((case, h0, h1, w0, w1))
        if case == CASE_FULL:
            win[...] = fetched
        elif case == CASE_ROW:
            kept = win[:, s_h:, :].clone()
            win[:, :keep_rows, :] = kept
            win[:, keep_rows:, :] = fetched
        else:
            right = int(moving_right(i, zig))
            kept = win[:, :, nw * right:nw * right + ov_w].clone()
            win[:, :, nw * (1 - right):nw * (1 - right) + ov_w] = kept
            win[:, :, ov_w * right:ov_w * right + nw] = fetched
        _step_product(win, lam, out, i, eff_tile(i, jt_raw, tiles, zig),
                      t_run, s_w, w_k)
    if return_fetches:
        return out, fetches
    return out


def conv2d_offload_planned(x: torch.Tensor, w: torch.Tensor, *, t_run: int,
                           s_h: int = 1, s_w: int = 1, order: str = "zigzag"
                           ) -> torch.Tensor:
    """Plan-shaped S1 convolution: per-step fetch == plan I_slice.

    Same arguments and result as :func:`conv2d_offload`; the difference is
    the traffic contract — each grid step fetches exactly the pixels the
    corresponding ``GroupedStrategy`` step charges to ``t_l`` (the window
    overlap with the previous step stays resident in shared memory), and
    the fetch is issued one step ahead.  ``kernels.emit`` maps
    ``LayerPlan``s here.

    One thread block runs the whole ordered sweep, so one of the card's
    SMs works: the plan's sequence mapped faithfully.  Raises
    :class:`KernelShapeError` before the launch when Λ plus the window and
    delta buffers exceed one block's shared memory.

    CUDA tensors: launches the kernel on the current stream, without
    synchronising.  CPU tensors: :func:`conv2d_offload_planned_plain`.
    """
    _check_tensors(x, w, order)
    if x.device.type == "cpu":
        return conv2d_offload_planned_plain(x, w, t_run=t_run, s_h=s_h,
                                            s_w=s_w, order=order)
    n, h_k, w_k, h_out, tiles = _conv_geometry(x, w, t_run, s_h, s_w)
    c_in, h_in, w_in = x.shape
    smem = planned_smem_elements(c_in, n, h_k, w_k, s_h, s_w, t_run) \
        * x.element_size()
    if smem > SMEM_LIMIT_BYTES:
        raise KernelShapeError(
            f"kernel set, window and delta buffers need {smem} bytes of "
            f"shared memory, one block has {SMEM_LIMIT_BYTES}; plan the "
            f"layer with kernels.emit.grid_solve under that budget")
    zig = order == "zigzag"
    t_in = t_in_cols(t_run, s_w, w_k)
    row_delta = (zig or tiles == 1) and h_k > s_h
    col_delta = t_in > t_run * s_w
    lam = _lambda_matrix(w)
    out = torch.empty((n, h_out, tiles * t_run), dtype=x.dtype,
                      device=x.device)
    launch = _build.bind(
        "conv2d_offload_planned", "conv2d_offload_planned_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        code = launch(x.data_ptr(), lam.data_ptr(), out.data_ptr(),
                      _DTYPE_CODES[x.dtype], c_in, h_in, w_in, n, h_k, w_k,
                      s_h, s_w, t_run, h_out, tiles, int(zig),
                      int(row_delta), int(col_delta),
                      torch.cuda.current_stream().cuda_stream)
    _build.check("conv2d_offload_planned", code,
                 "conv2d_offload_planned launch")
    LAUNCHES["conv2d_offload_planned"] += 1
    return out
