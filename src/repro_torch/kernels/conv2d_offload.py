"""S1 convolution offloading (paper Sec 4) on an NVIDIA H100: wrappers,
plain PyTorch versions of the two CUDA kernels.

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
  *full* ``(C_in, H_K, t_in)`` window and waiting on it, then a
  register-tiled product whose reduction is split over groups of threads
  (``core.planner.conv_simple_k_groups``).  Correct, but it re-fetches the
  ``w_k - s_w`` columns (and, across rows, the ``h_k - s_h`` rows) shared
  with the previous step — traffic the plan's Def-3 ``I_slice``
  accounting does *not* charge.
* :func:`conv2d_offload_planned` (``csrc/conv2d_offload_planned.cu``) —
  the plan-shaped kernel ``kernels.emit`` maps ``LayerPlan``s onto: a
  thread-block cluster of ``cs_n x cs_t`` blocks
  (``core.planner.conv_cluster_shape``) walks the plan's ordered sweep,
  rank ``(g, u)`` keeping the kernel channels ``[g*N/cs_n, (g+1)*N/cs_n)``
  of Λ and writing output columns ``[u*T/cs_t, (u+1)*T/cs_t)`` of each
  step.  The window stays resident in each block's shared memory and each
  step fetches only its **I_slice delta** (new columns within a row, new
  rows at a zigzag row turn), once per cluster and ahead of the step: each
  rank fetches one share of the box (:func:`fetch_shares`) and pushes it
  (a bulk copy between shared memories) into a ring slot of every rank.

Each wrapper looks at where its tensors lie.  For CUDA tensors it launches
the hand-written kernel, or raises; it never gives way to the plain
version.  For CPU tensors it runs the plain PyTorch version beside it,
which does step by step what the kernel does, with tensor slicing for the
fetches and ``patches.float() @ lam.float()`` for the product.  Each
launch of a kernel adds one to its name in ``obs.counters``, and nothing
else does; the planned kernel also adds the elements it fetched from
device memory to :func:`fetched_counter`.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.planner import (CONV_RING_DEPTH, conv_cluster_shape,
                                      conv_simple_smem_bytes)
from repro_torch.kernels import KernelShapeError
from repro_torch.kernels import _build
from repro_torch.obs import spans

# Step cases of the planned kernel.
CASE_FULL = "full"          # fetch the whole window (first step / no overlap)
CASE_ROW = "row-delta"      # zigzag row turn: fetch the s_h new rows
CASE_COL = "col-delta"      # within-row move: fetch the t_run*s_w new cols

# Dynamic shared memory one thread block can ask for on sm_90.
SMEM_LIMIT_BYTES = 232_448

# Elements the planned kernel fetched from device memory, by device: one
# int64 on the card, to which every block of every launch adds its own
# fetches (its share of Λ and of each step's box) once, as it exits.  The
# plain version never counts.
FETCHED: dict[torch.device, torch.Tensor] = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIMPLE = _build.Launcher(
    "conv2d_offload", "conv2d_offload_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
    "conv2d_offload")


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


def fetch_shares(elements: int, cs: int) -> list[tuple[int, int]]:
    """Rank r's half-open share ``[r*e//cs, (r+1)*e//cs)`` of a box of
    ``elements`` elements flattened ``(C_in, rows, cols)``: disjoint, their
    union the box, sizes differing by at most one.  ``share_lo`` in the
    CUDA source is the same formula (cs is a power of two)."""
    return [(r * elements // cs, (r + 1) * elements // cs)
            for r in range(cs)]


# A rank's share of a step's box sits in every ring slot from a multiple
# of this many elements (16 bytes of bfloat16, 32 of float32), so that a
# bulk copy between shared memories, which moves whole 16 bytes from and to
# 16-byte boundaries, can push it.
SHARE_ALIGN = 8


def conv_k_split(ts: int, nr: int, k_total: int) -> int:
    """Warps of the planned kernel's bfloat16 product that split one output
    tile's k chunks: with ``tiles`` 16 x 8 tiles in a block's (ts x nr)
    part of a step and ``kc`` chunks of 16 in ``k_total = C_in*H_K*W_K``,
    1 when the tiles fill the 8 compute warps, else as many as the warps
    left per tile and the chunks allow.  ``k_split`` in the CUDA source is
    the same rule."""
    tiles = -(-ts // 16) * -(-nr // 8)
    if tiles >= 8:
        return 1
    return min(8 // tiles, -(-k_total // 16))


@dataclasses.dataclass(frozen=True)
class PlannedLayout:
    """One block's shared memory in the planned kernel's cluster, in
    elements, in the order it is carved: the block's columns of Λ, the
    window, ``pad`` (up to a multiple of ``SHARE_ALIGN``: the ring starts
    on 16 bytes), the ring (``depth`` slots, each ``cs`` shares of
    ``share`` elements) and the f32 partial tiles of the bfloat16 product
    (``parts``: ``conv_k_split`` of ``t_run/cs_t x N/cs_n`` each, two
    elements a value, none without a split; float32 allocates them too)."""

    cs_n: int
    cs_t: int
    share: int
    depth: int
    lam: int
    window: int
    pad: int
    parts: int

    @property
    def cs(self) -> int:
        return self.cs_n * self.cs_t

    @property
    def slot(self) -> int:
        return self.cs * self.share

    @property
    def ring(self) -> int:
        return self.depth * self.slot

    @property
    def total(self) -> int:
        return self.lam + self.window + self.pad + self.ring + self.parts


def planned_layout(c_in: int, n: int, h_k: int, w_k: int, s_h: int,
                   s_w: int, t_run: int, *, row_delta: bool | None = None,
                   cluster: tuple[int, int] | None = None) -> PlannedLayout:
    """:class:`PlannedLayout` of the planned kernel on a cluster of
    ``cluster = (cs_n, cs_t)`` blocks (by default
    ``conv_cluster_shape(n, t_run)``).  A ring slot holds the largest box
    a step after the first fetches, the larger of the column delta (or the
    window, when neighbouring windows share no column) and the row delta
    (``s_h`` rows, or the whole ``h_k`` when a row turn fetches the full
    window); ``row_delta`` is the kernel's flag, by default a zigzag
    sweep's (``h_k > s_h``).  ``planned_layout`` in the CUDA source is the
    same arithmetic."""
    cs_n, cs_t = cluster or conv_cluster_shape(n, t_run)
    cs = cs_n * cs_t
    if row_delta is None:
        row_delta = h_k > s_h
    t_in = t_in_cols(t_run, s_w, w_k)
    col = c_in * h_k * min(t_run * s_w, t_in)
    row = c_in * (s_h if row_delta else h_k) * t_in
    share = -(-max(col, row) // cs)
    ts, nr = t_run // cs_t, n // cs_n
    split = conv_k_split(ts, nr, c_in * h_k * w_k)
    lam = c_in * h_k * w_k * nr
    window = c_in * h_k * t_in
    return PlannedLayout(cs_n=cs_n, cs_t=cs_t,
                         share=-(-share // SHARE_ALIGN) * SHARE_ALIGN,
                         depth=CONV_RING_DEPTH, lam=lam, window=window,
                         pad=-(lam + window) % SHARE_ALIGN,
                         parts=2 * split * ts * nr if split > 1 else 0)


def planned_smem_elements(c_in: int, n: int, h_k: int, w_k: int,
                          s_h: int, s_w: int, t_run: int, *,
                          row_delta: bool | None = None) -> int:
    """Shared-memory elements one block of the planned kernel's cluster
    allocates (:func:`planned_layout`): its ``N / cs_n`` columns of Λ, the
    resident window, the ring of staging slots and the bfloat16 product's
    partial tiles.  No output is staged in shared memory.
    ``conv2d_offload_planned_smem_elements`` in the CUDA source is the
    same formula."""
    return planned_layout(c_in, n, h_k, w_k, s_h, s_w, t_run,
                          row_delta=row_delta).total


def fetched_counter(device: torch.device) -> torch.Tensor:
    """The planned kernel's fetch counter on ``device`` (see
    ``FETCHED``), made at first use; zero it with ``.zero_()``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counter = FETCHED.get(device)
    if counter is None:
        counter = FETCHED[device] = torch.zeros(1, dtype=torch.int64,
                                                device=device)
    return counter


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
    :func:`conv2d_offload_planned` for the kernel whose traffic is.  The
    kernel reads ``w`` in its own layout: nothing is transposed per call.

    CUDA tensors: launches the kernel on the current stream, without
    synchronising.  CPU tensors: :func:`conv2d_offload_plain`.
    """
    _check_tensors(x, w, order)
    if x.device.type == "cpu":
        return conv2d_offload_plain(x, w, t_run=t_run, s_h=s_h, s_w=s_w,
                                    order=order)
    n, h_k, w_k, h_out, tiles = _conv_geometry(x, w, t_run, s_h, s_w)
    c_in, h_in, w_in = x.shape
    smem = conv_simple_smem_bytes(
        ConvSpec(c_in, h_in, w_in, n, h_k, w_k, s_h, s_w), t_run,
        x.element_size())
    if smem > SMEM_LIMIT_BYTES:
        raise KernelShapeError(
            f"window and partial blocks of {smem} bytes exceed one block's "
            f"shared memory ({SMEM_LIMIT_BYTES} bytes); choose a smaller "
            f"t_run")
    out = torch.empty((n, h_out, tiles * t_run), dtype=x.dtype,
                      device=x.device)
    _SIMPLE(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], c_in, h_in, w_in, n, h_k, w_k, s_h, s_w,
            t_run, h_out, tiles, int(order == "zigzag"))
    return out


# --------------------------------------------------------------------- #
# Planned kernel: resident window + prefetched I_slice deltas
# --------------------------------------------------------------------- #

def conv2d_offload_planned_plain(x: torch.Tensor, w: torch.Tensor, *,
                                 t_run: int, s_h: int = 1, s_w: int = 1,
                                 order: str = "zigzag",
                                 return_fetches: bool = False,
                                 cluster: tuple[int, int] | None = None,
                                 ledger: list | None = None):
    """Plain PyTorch version of :func:`conv2d_offload_planned`.

    A Python loop over the grid that keeps a real ``(C_in, H_K, t_in)``
    window tensor, indexed as the kernel indexes it: input row ``h`` and
    column ``w`` live in slot ``(h % H_K, w % t_in)``, so a delta lands on
    the slots of the rows or columns it replaces and nothing kept moves.
    At each step it slices out of ``x`` only the box :func:`step_fetch_box`
    names, as the kernel's cluster fetches it: one :func:`fetch_shares`
    share per rank of ``cluster`` (by default
    ``conv_cluster_shape(N, t_run)``), whose union is the box, spliced into
    the window.  Then each rank ``(g, u)`` computes its output block:
    channels ``[g*N/cs_n, (g+1)*N/cs_n)``, columns ``[u*T/cs_t,
    (u+1)*T/cs_t)`` of the step, in f32, cast once at the store.

    With ``return_fetches`` it also returns the per-step
    ``(case, h0, h1, w0, w1)`` boxes it really sliced, so that a test can
    hold the fetch sequence against the plan's charged loads.  A
    ``ledger`` list receives, per step and rank, ``(step, rank, (lo, hi),
    (ch0, ch1), (col0, col1))``: the rank's share of the box and the
    channels and output columns it wrote.
    """
    _check_tensors(x, w, order)
    n, h_k, w_k, h_out, tiles = _conv_geometry(x, w, t_run, s_h, s_w)
    zig = order == "zigzag"
    t_in = t_in_cols(t_run, s_w, w_k)
    cs_n, cs_t = cluster or conv_cluster_shape(n, t_run)
    cs, nr, ts = cs_n * cs_t, n // cs_n, t_run // cs_t
    lam = _lambda_matrix(w)
    out = torch.empty((n, h_out, tiles * t_run), dtype=x.dtype,
                      device=x.device)
    win = torch.zeros((x.shape[0], h_k, t_in), dtype=x.dtype,
                      device=x.device)
    fetches = []
    for step, (i, jt_raw) in enumerate(grid_sequence(h_out, tiles)):
        case, h0, h1, w0, w1 = step_fetch_box(
            i, jt_raw, t_run=t_run, s_h=s_h, s_w=s_w, h_k=h_k, w_k=w_k,
            w_out_tiles=tiles, order=order)
        fetches.append((case, h0, h1, w0, w1))
        box = x[:, h0:h1, w0:w1].reshape(-1)
        shares = fetch_shares(box.numel(), cs)
        pushed = torch.cat([box[lo:hi] for lo, hi in shares])
        rows = torch.arange(h0, h1) % h_k
        cols = torch.arange(w0, w1) % t_in
        win[:, rows[:, None], cols[None, :]] = pushed.view(
            x.shape[0], h1 - h0, w1 - w0)
        tile = eff_tile(i, jt_raw, tiles, zig)
        wh = i * s_h
        ww = tile * t_run * s_w
        window = win[:, (torch.arange(wh, wh + h_k) % h_k)[:, None],
                     (torch.arange(ww, ww + t_in) % t_in)[None, :]]
        for rank in range(cs):
            g, u = divmod(rank, cs_t)
            c0 = u * ts * s_w
            part = window[:, :, c0:c0 + t_in_cols(ts, s_w, w_k)]
            prod = _patches(part, ts, s_w, w_k).float() \
                @ lam[:, g * nr:(g + 1) * nr].float()
            j0 = tile * t_run + u * ts
            out[g * nr:(g + 1) * nr, i, j0:j0 + ts] = prod.t().to(out.dtype)
            if ledger is not None:
                ledger.append((step, rank, shares[rank],
                               (g * nr, (g + 1) * nr), (j0, j0 + ts)))
    return (out, fetches) if return_fetches else out


def conv2d_offload_planned(x: torch.Tensor, w: torch.Tensor, *, t_run: int,
                           s_h: int = 1, s_w: int = 1, order: str = "zigzag"
                           ) -> torch.Tensor:
    """Plan-shaped S1 convolution: per-step fetch == plan I_slice.

    Same arguments and result as :func:`conv2d_offload`; the difference is
    the traffic contract — each grid step fetches exactly the pixels the
    corresponding ``GroupedStrategy`` step charges to ``t_l`` (the window
    overlap with the previous step stays resident in shared memory), and
    the fetch is issued ahead of the step.  ``kernels.emit`` maps
    ``LayerPlan``s here.

    One launch runs a thread-block cluster of ``cs_n x cs_t`` blocks
    (``core.planner.conv_cluster_shape(N, t_run)``) over the plan's one
    ordered sweep: rank ``(g, u)`` keeps kernel channels ``[g*N/cs_n,
    (g+1)*N/cs_n)`` of Λ (fetched once per cluster, a share by each rank
    of the group) and writes those channels' output columns ``[u*T/cs_t,
    (u+1)*T/cs_t)`` of each step.  Each step's box is fetched once per
    cluster, each rank fetching its :func:`fetch_shares` share and pushing
    it into the same ring slot of every rank.  Raises
    :class:`KernelShapeError` before the launch when a block's Λ columns,
    window, ring and partial tiles exceed one block's shared memory.
    Every block adds the elements it fetched from device memory to
    :func:`fetched_counter` of the tensors' device.

    CUDA tensors: launches the kernel on the current stream, without
    synchronising, through a :class:`PlannedLaunch` made for the call
    (``kernels.emit.EmittedConv.run`` keeps its records instead).  CPU
    tensors: :func:`conv2d_offload_planned_plain`.
    """
    _check_tensors(x, w, order)
    if x.device.type == "cpu":
        return conv2d_offload_planned_plain(x, w, t_run=t_run, s_h=s_h,
                                            s_w=s_w, order=order)
    return planned_launch(x, w, t_run=t_run, s_h=s_h, s_w=s_w,
                          order=order).run(x, w, _lambda_matrix)


# C signature of conv2d_offload_planned_launch
PLANNED_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 \
    + [ctypes.c_void_p]
_PLANNED = _build.Launcher("conv2d_offload_planned",
                           "conv2d_offload_planned_launch", PLANNED_ARGTYPES,
                           "conv2d_offload_planned")

# Λ of the planned kernel's CUDA calls through ``kernels.emit.
# EmittedConv.run``: made anew for the call, or its record's reused
# (:meth:`PlannedLaunch.lambda_of`).  The free functions never count.
LAMBDA = {"built": 0, "reused": 0}


def _planned_flags(h_k: int, w_k: int, s_h: int, s_w: int, t_run: int,
                   tiles: int, order: str) -> tuple[bool, bool]:
    """The planned kernel's ``(row_delta, col_delta)``: whether a row turn
    fetches only the new rows, and whether a move within a row fetches
    only the new columns (:func:`step_case`)."""
    row_delta = (order == "zigzag" or tiles == 1) and h_k > s_h
    col_delta = t_in_cols(t_run, s_w, w_k) > t_run * s_w
    return row_delta, col_delta


@dataclasses.dataclass(frozen=True, eq=False)
class PlannedLaunch:
    """What a plan fixes of the planned kernel's launch on one device in
    one dtype, derived once (:func:`planned_launch`): the geometry, the
    flags, one block's shared memory, the cluster, the output's shape,
    the launcher with the fetch counter it adds to, and ``ints``, the
    17 ints that ``PLANNED_ARGTYPES`` takes after the four pointers, in
    its order.  :meth:`run` launches it on a call's tensors.

    ``kept`` holds one Λ for :meth:`lambda_of`: the weight tensor it was
    made from (held, so that its address is not reused), that tensor's
    ``_version`` and data pointer then, and Λ."""

    n: int
    h_k: int
    w_k: int
    h_out: int
    tiles: int
    c_in: int
    h_in: int
    w_in: int
    row_delta: bool
    col_delta: bool
    smem_bytes: int
    cluster: tuple[int, int]
    device: torch.device
    dtype: torch.dtype
    out_shape: tuple[int, int, int]
    launch: _build.Launcher
    counter: torch.Tensor
    ints: tuple[int, ...]
    kept: list = dataclasses.field(default_factory=lambda: [None],
                                   repr=False)

    def lambda_of(self, w: torch.Tensor) -> torch.Tensor:
        """Λ of ``w`` (:func:`_lambda_matrix`): the kept one when ``w`` is
        the tensor it was made from, unchanged since (the same ``_version``
        and data pointer), else made anew and kept.  Counted in
        ``LAMBDA``.  An in-place edit of ``w`` or of a view of it bumps
        its version; one made through a tensor that shares its storage but
        not its version counter (``w.data``) is not seen."""
        kept = self.kept[0]
        if kept is not None and kept[0] is w and kept[1] == w._version \
                and kept[2] == w.data_ptr():
            LAMBDA["reused"] += 1
            return kept[3]
        lam = _lambda_matrix(w)
        self.kept[0] = (w, w._version, w.data_ptr(), lam)
        LAMBDA["built"] += 1
        return lam

    def run(self, x: torch.Tensor, w: torch.Tensor, lambda_of,
            span: int = 0) -> torch.Tensor:
        """Launch on ``x`` and ``lambda_of(w)`` into a fresh output through
        the record's launcher (the current stream of its device; raises if
        the launch function refuses).  ``span``, the end of an open
        ``conv.run`` call's last host span (0 when none is recorded),
        starts the child spans ``conv.lambda``, ``conv.alloc`` and
        ``conv.launch`` (the launcher's call: the device test, the stream,
        the C call, its code's check and the count)."""
        t = span
        lam = lambda_of(w)
        if t:
            t = spans.RECORDER.add(spans.CONV_LAMBDA, t)
        out = torch.empty(self.out_shape, dtype=self.dtype,
                          device=self.device)
        if t:
            t = spans.RECORDER.add(spans.CONV_ALLOC, t)
        self.launch(self.device, x.data_ptr(), lam.data_ptr(),
                    out.data_ptr(), self.counter.data_ptr(), *self.ints)
        if t:
            spans.RECORDER.add(spans.CONV_LAUNCH, t)
        return out


def planned_launch(x: torch.Tensor, w: torch.Tensor, *, t_run: int,
                   s_h: int, s_w: int, order: str,
                   cluster: tuple[int, int] | None = None,
                   counter: torch.Tensor | None = None, launch=None
                   ) -> PlannedLaunch:
    """The :class:`PlannedLaunch` of the planned kernel for the shapes,
    dtype and device of ``x`` and ``w`` (checked by
    :func:`_check_tensors` already) under a plan's ``t_run``, strides and
    order.  Raises :class:`KernelShapeError` when the shapes do not take
    the plan, or when one block of the cluster needs more shared memory
    than ``SMEM_LIMIT_BYTES``.  By default the cluster is
    ``conv_cluster_shape(N, t_run)``, the counter
    :func:`fetched_counter` of the tensors' device and the launch function
    the one built from ``csrc/``; a measurement or a test may give its own
    (``launch``, called with ``PLANNED_ARGTYPES``), which counts as the
    built one does."""
    n, h_k, w_k, h_out, tiles = _conv_geometry(x, w, t_run, s_h, s_w)
    c_in, h_in, w_in = x.shape
    row_delta, col_delta = _planned_flags(h_k, w_k, s_h, s_w, t_run, tiles,
                                          order)
    cs_n, cs_t = cluster or conv_cluster_shape(n, t_run)
    smem = planned_layout(c_in, n, h_k, w_k, s_h, s_w, t_run,
                          row_delta=row_delta, cluster=(cs_n, cs_t)
                          ).total * x.element_size()
    if smem > SMEM_LIMIT_BYTES:
        raise KernelShapeError(
            f"kernel-set share, window, ring and partial tiles need {smem} "
            f"bytes of shared memory per block, one block has "
            f"{SMEM_LIMIT_BYTES}; "
            f"plan the layer with kernels.emit.grid_solve under that "
            f"budget")
    return PlannedLaunch(
        n=n, h_k=h_k, w_k=w_k, h_out=h_out, tiles=tiles, c_in=c_in,
        h_in=h_in, w_in=w_in, row_delta=row_delta, col_delta=col_delta,
        smem_bytes=smem, cluster=(cs_n, cs_t), device=x.device,
        dtype=x.dtype, out_shape=(n, h_out, tiles * t_run),
        launch=_PLANNED if launch is None else _PLANNED.using(launch),
        counter=fetched_counter(x.device) if counter is None else counter,
        ints=(_DTYPE_CODES[x.dtype], c_in, h_in, w_in, n, h_k, w_k, s_h,
              s_w, t_run, h_out, tiles, int(order == "zigzag"),
              int(row_delta), int(col_delta), cs_n, cs_t))
