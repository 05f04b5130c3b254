"""Strategy-driven block GeMM (paper Sec 1.3 adaptation) on an NVIDIA H100:
wrapper and plain PyTorch version of the CUDA kernels in
``csrc/block_matmul.cu``.

The paper notes its formalism applies to GeMM-based accelerators with
"slightly adapted" strategies: tiles of A/B/C play the role of patches and
kernels, and the loop order decides which operand is revisited (kept on
chip) between consecutive steps.  ``core.planner.plan_matmul`` enumerates
tile shapes x loop orders under the paper's duration model, and these
kernels execute the chosen plan:

  * order "..k" (k innermost) — output-stationary, kernel
    ``block_matmul_osta`` (K3): the C tile is the resident set, A and B
    stream, the f32 sum stays on chip and C is written once;
  * order with k outside — kernel ``block_matmul_rmw`` (K4): the A (resp.
    B) tile is revisited across the inner sweep, and the C tile leaves the
    chip while partial, read-modified-written through an f32 buffer.

CUDA blocks run in no order, so the order is kept like this
(:func:`launch_plan`): the loops outside k go on the grid, and a block
walks the rest in the order's sequence; with k outermost there is one
launch per k tile, the middle loop on the grid.  K4 splits its innermost
loop over a cluster of ``core.planner.gemm_cluster_size`` blocks (at
most 8): rank r walks inner tiles r, r + cs, ..., rank 0 fetches the
resident tile and the peers copy it from rank 0's shared memory.  K3
runs in clusters of ``cluster`` = (cm, cn) blocks, each with its own C
tile (:func:`cluster_blocks`, ``core.planner.k3_raster``): the ranks on
one tile row share each A tile and those on one tile column each B tile,
every sharer fetching its share of each box by TMA multicast
(:func:`k3_sharers`).  Partial sums of one C tile thus come from
one block, or from successive launches, never from two blocks at once.
Every order sums each C value over its k tiles in k order, in f32, and
rounds once: all six orders give the same result, bit for bit.  A step's
tile product runs on one of three cores (:func:`core_of`): ``wgmma`` for
bfloat16 tiles of 64 or 128 rows and up to 256 columns (warpgroup
products fed by TMA into an ``mbarrier`` ring), ``mma.sync`` for the
other bfloat16 tiles, ``fma`` for float32.

Each wrapper looks at where its tensors lie.  For CUDA tensors it
launches the kernel, or raises; for CPU tensors it runs
:func:`block_matmul_plain`, which walks the same launches, blocks and
steps.  Each launch adds one to its kernel's name in ``obs.counters``,
and nothing else does; ``LAST_LAUNCH`` says how the last one was shaped.
"""
from __future__ import annotations

import ctypes
import itertools

import torch

from repro_torch.core.planner import (K3_RASTER_ROWS, MATMUL_MAX_BM,
                                      MATMUL_MAX_BN_SYNC, gemm_cluster_size,
                                      k3_cluster_ok, k3_grid_cluster,
                                      k3_raster, matmul_core, matmul_max_bn,
                                      matmul_smem_bytes)
from repro_torch.kernels import KernelShapeError
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_offload import SMEM_LIMIT_BYTES

# The last launch: kernel name, core (:func:`core_of`), cluster size, K3's
# cluster (ranks along m, n), the cluster's extent along the grid's x and
# y, and the grid (x, y) in blocks.
LAST_LAUNCH: dict = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_DIM_CODES = {"m": 0, "n": 1, "k": 2}
# K3 and K4 share one C launch function and count under their own names
_LAUNCH = {name: _build.Launcher(
    "block_matmul", "block_matmul_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 21 + [ctypes.c_void_p], name)
    for name in ("block_matmul_osta", "block_matmul_rmw")}


def matmul_grid(m: int, n: int, k: int, *, bm: int, bn: int, bk: int,
                order: str):
    """The sequential sweep of the plan: ``(grid, amap, bmap, cmap,
    axis)``, the grid's trip counts in ``order`` (outer to inner), the
    tile index maps of A ``(m, k)``, B ``(k, n)`` and C ``(m, n)`` on a
    step's grid indices, and each dim's grid position."""
    if sorted(order) != ["k", "m", "n"]:
        raise KernelShapeError(f"order {order!r} must permute 'mnk'")
    if min(m, n, k, bm, bn, bk) <= 0 or m % bm or n % bn or k % bk:
        raise KernelShapeError(
            f"tiles ({bm},{bn},{bk}) must divide dims ({m},{n},{k}) "
            f"(ops.matmul pads)")
    trip = {"m": m // bm, "n": n // bn, "k": k // bk}
    grid = tuple(trip[d] for d in order)
    axis = {d: i for i, d in enumerate(order)}

    def amap(*ids):
        return (ids[axis["m"]], ids[axis["k"]])

    def bmap(*ids):
        return (ids[axis["k"]], ids[axis["n"]])

    def cmap(*ids):
        return (ids[axis["m"]], ids[axis["n"]])

    return grid, amap, bmap, cmap, axis


def core_of(bm: int, bn: int, bk: int, dtype: torch.dtype) -> str:
    """The core a launch at these tiles runs on: ``"wgmma"`` for bfloat16
    tiles with ``bm % 64 == 0``, ``"mma.sync"`` for the other bfloat16
    tiles, ``"fma"`` for float32 (``core.planner.matmul_core``, the rule
    ``mm_core`` of ``csrc/block_matmul.cu``).  There is no fallback from
    one core to another: a launch that fails raises."""
    return matmul_core(bm, bn, bk, _DTYPE_BYTES[dtype])


def launch_plan(order: str, trips: dict[str, int]
                ) -> list[tuple[tuple[str, ...], int, int]]:
    """The kernel launches of one product, in stream order: for each,
    ``(grid_dims, k_lo, k_cnt)`` — the loop dims on the CUDA grid (outer
    first) and the k tiles the launch walks.  The loops outside k go on
    the grid; with k outermost, one launch per k tile with the middle
    loop on the grid (``core.planner.gemm_grid_blocks`` counts the blocks
    of each)."""
    pos_k = order.index("k")
    if pos_k == 0:
        return [((order[1],), kk, 1) for kk in range(trips["k"])]
    return [(tuple(order[:pos_k]), 0, trips["k"])]


def launch_grid(grid_dims: tuple[str, ...], trips: dict[str, int], cs: int
                ) -> tuple[int, int, dict[str, int]]:
    """The CUDA grid ``(x, y)`` of a launch over ``grid_dims`` and each
    dim's ``blockIdx`` axis (0 = x, 1 = y): the innermost grid dim on x,
    times the cluster's ``cs`` blocks, an outer one on y."""
    axes = {d: len(grid_dims) - 1 - i for i, d in enumerate(grid_dims)}
    grid_x = trips[grid_dims[-1]] * cs
    grid_y = trips[grid_dims[0]] if len(grid_dims) == 2 else 1
    return grid_x, grid_y, axes


def block_steps(order: str, lo: dict[str, int], cnt: dict[str, int],
                step: dict[str, int] | None = None):
    """The ``(m, n, k)`` tile steps one block walks, in the order's
    sequence, over ``lo[d] + i * step[d]`` for ``i < cnt[d]`` (step 1
    where not given) for each dim."""
    step = step or {}
    for ids in itertools.product(*(range(lo[d], lo[d] + cnt[d] * step.get(
            d, 1), step.get(d, 1)) for d in order)):
        at = dict(zip(order, ids))
        yield at["m"], at["n"], at["k"]


def cluster_blocks(order: str, trips: dict[str, int], grid_dims, cs: int,
                   cluster: tuple[int, int] = (1, 1)):
    """The blocks of one launch, each as ``(rank, lo, cnt, step)`` for
    :func:`block_steps` (k left to the launch), cluster by cluster in
    launch order.  K3: one C tile a block, its ``cm x cn`` cluster's
    ranks in ``%cluster_ctarank`` order (x fastest), the clusters laid
    over the tiles by ``core.planner.k3_raster``.  K4: one block per grid
    index and rank of its cluster, rank r taking inner tiles r, r + cs,
    ..."""
    if order[2] == "k":
        yield from _k3_blocks(order, trips, cluster)
        return
    inner = order[2]
    for block in itertools.product(*(range(trips[d]) for d in grid_dims)):
        fixed = dict(zip(grid_dims, block))
        for rank in range(cs):
            lo = {d: fixed.get(d, 0) for d in "mn"}
            cnt = {d: 1 if d in fixed else trips[d] for d in "mn"}
            step = {}
            if cs > 1:
                lo[inner], step[inner] = rank, cs
                cnt[inner] = -(-(trips[inner] - rank) // cs)
            yield rank, lo, cnt, step


def _k3_blocks(order: str, trips: dict[str, int], cluster: tuple[int, int]):
    cx, cy = k3_grid_cluster(order, cluster)
    outer, inner = order[0], order[1]
    ncx, ncy = trips[inner] // cx, trips[outer] // cy
    for lin in range(ncx * ncy):
        x, y = k3_raster(lin, ncx, ncy, K3_RASTER_ROWS // cy)
        for rank in range(cx * cy):
            at = {inner: x * cx + rank % cx, outer: y * cy + rank // cx}
            yield rank, dict(at), {"m": 1, "n": 1}, {}


def k3_sharers(order: str, cluster: tuple[int, int], rank: int
               ) -> dict[str, list[int]]:
    """The ranks of a K3 cluster that share ``rank``'s A tile (its tile
    row) and B tile (its tile column), in the order their producers'
    shares of a box's rows go: ``{"a": [...], "b": [...]}``."""
    cx, cy = k3_grid_cluster(order, cluster)
    ix, iy = rank % cx, rank // cx
    along_x = [iy * cx + q for q in range(cx)]
    along_y = [ix + q * cx for q in range(cy)]
    m_on_y = order[0] == "m"
    return {"a": along_x if m_on_y else along_y,
            "b": along_y if m_on_y else along_x}


def _check(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int,
           order: str) -> dict[str, int]:
    """What both versions take; returns the trip counts by dim."""
    if a.dim() != 2 or b.dim() != 2:
        raise KernelShapeError(
            f"want A (m, k) and B (k, n), got {tuple(a.shape)} and "
            f"{tuple(b.shape)}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise KernelShapeError(f"A has k={k} but B has k={k2}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise KernelShapeError(
            f"A and B must both be float32 or both bfloat16, got {a.dtype} "
            f"and {b.dtype}")
    if a.device != b.device:
        raise KernelShapeError(f"A is on {a.device} but B is on {b.device}")
    if a.device.type not in ("cuda", "cpu"):
        raise KernelShapeError(f"unsupported device {a.device}")
    grid, *_ = matmul_grid(m, n, k, bm=bm, bn=bn, bk=bk, order=order)
    return dict(zip(order, grid))


def kernel_limits(bm: int, bn: int, bk: int, dtype_bytes: int,
                  *tensors: torch.Tensor, rmw: bool = False) -> None:
    """Raise unless the CUDA kernel (K3, or K4 with ``rmw``) takes these
    tiles and tensors: bm at most 128 and bn at most 128, or 256 on the
    wgmma core (the accumulators a warp or warpgroup holds), every tile a
    multiple of 16 (tensor-core fragments, 16-byte copies), the core's
    shared memory (``matmul_smem_bytes``) within one block's, and each
    tensor starting on 16 bytes (a view with an offset may not; it is
    refused, not copied)."""
    if bm > MATMUL_MAX_BM or bn > matmul_max_bn(bm, dtype_bytes):
        raise KernelShapeError(
            f"the block GeMM kernel takes bm, bn <= {MATMUL_MAX_BN_SYNC} "
            f"(bn <= {matmul_max_bn(64, 2)} on the wgmma core), got "
            f"bm={bm} bn={bn}")
    if bm % 16 or bn % 16 or bk % 16:
        raise KernelShapeError(
            f"the block GeMM kernel takes tiles that are multiples of 16, "
            f"got bm={bm} bn={bn} bk={bk}")
    smem = matmul_smem_bytes(bm, bn, bk, dtype_bytes, rmw)
    if smem > SMEM_LIMIT_BYTES:
        core = matmul_core(bm, bn, bk, dtype_bytes)
        raise KernelShapeError(
            f"the {core} core's tiles ({bm},{bn},{bk}) need {smem} bytes of "
            f"shared memory, one block has {SMEM_LIMIT_BYTES}; take a "
            f"smaller bk")
    for t in tensors:
        if t.data_ptr() % 16:
            raise KernelShapeError(
                f"the block GeMM kernel copies 16 bytes at a time, so each "
                f"tensor must start on 16 bytes; this one starts at "
                f"{t.data_ptr() % 16} bytes past (a view with an offset?)")


def _check_cluster(bm: int, bn: int, bk: int, order: str,
                   trips: dict[str, int], cluster: tuple[int, int],
                   dtype_bytes: int) -> None:
    if cluster != (1, 1) and order[2] != "k":
        raise KernelShapeError(
            f"only K3 (k innermost) takes an m x n cluster, got {cluster} "
            f"for order {order!r}")
    if not k3_cluster_ok(bm, bn, bk, trips["m"], trips["n"], *cluster,
                         dtype_bytes):
        raise KernelShapeError(
            f"K3 does not take a {cluster[0]} x {cluster[1]} cluster at "
            f"tiles ({bm},{bn},{bk}) over {trips['m']} x {trips['n']} C "
            f"tiles (core.planner.k3_cluster_ok)")


def block_matmul_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                       bn: int = 128, bk: int = 128, order: str = "mnk",
                       cluster: tuple[int, int] = (1, 1),
                       return_loads: bool = False):
    """Plain PyTorch version of :func:`block_matmul`: Python loops over the
    same launches, clusters, blocks and steps.  Each step's tile product
    is ``a_tile.float() @ b_tile.float()``, added to the running C value in
    k order (in a local accumulator for K3, through an f32 buffer for K4)
    and cast once at the last k tile.

    With ``return_loads`` it also returns the traffic the kernel makes,
    counted as the kernel decides it: ``{"a": ..., "b": ...}`` A and B
    tiles that land in a block's shared memory (a block fetches a tile
    only when its index differs from the one it holds; in a K4 cluster
    the resident tile is fetched by rank 0 alone, the peers copy it from
    rank 0's shared memory), ``"l2_a"`` / ``"l2_b"`` those that L2 serves
    (a tile multicast to a K3 cluster's sharers once), ``"c_partial_reads"``
    / ``"c_partial_writes"`` (f32 partials through the buffer) and
    ``"c_writes"`` (final tiles)."""
    trips = _check(a, b, bm, bn, bk, order)
    _check_cluster(bm, bn, bk, order, trips, tuple(cluster),
                   a.element_size())
    m, n = a.shape[0], b.shape[1]
    k_t = trips["k"]
    rmw = order[2] != "k"
    cs = gemm_cluster_size(order, trips)
    # the operand resident across the inner loop, which rank 0 alone fetches
    resident = {"n": "a", "m": "b"}[order[2]] if cs > 1 else None
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    buf = torch.empty((m, n), dtype=torch.float32, device=a.device) \
        if rmw else None
    loads = dict.fromkeys(("a", "b", "l2_a", "l2_b", "c_partial_reads",
                           "c_partial_writes", "c_writes"), 0)
    for grid_dims, k_lo, k_cnt in launch_plan(order, trips):
        for rank, lo, cnt, step in cluster_blocks(order, trips, grid_dims,
                                                  cs, cluster):
            lo["k"], cnt["k"] = k_lo, k_cnt
            # a K3 sharer group's tile is served once: count it at its first
            first = {op: ranks[0] == rank for op, ranks in k3_sharers(
                order, cluster, rank).items()} if not rmw else \
                {"a": True, "b": True}
            held_a = held_b = None
            acc = None
            for mm, nn, kk in block_steps(order, lo, cnt, step):
                if (mm, kk) != held_a:
                    held_a = (mm, kk)
                    a_t = a[mm * bm:(mm + 1) * bm, kk * bk:(kk + 1) * bk]
                    loads["a"] += int(resident != "a" or rank == 0)
                    loads["l2_a"] += int((resident != "a" or rank == 0)
                                         and first["a"])
                if (kk, nn) != held_b:
                    held_b = (kk, nn)
                    b_t = b[kk * bk:(kk + 1) * bk, nn * bn:(nn + 1) * bn]
                    loads["b"] += int(resident != "b" or rank == 0)
                    loads["l2_b"] += int((resident != "b" or rank == 0)
                                         and first["b"])
                part = a_t.float() @ b_t.float()
                tile = (slice(mm * bm, (mm + 1) * bm),
                        slice(nn * bn, (nn + 1) * bn))
                if rmw:
                    if kk == 0:
                        val = part
                    else:
                        val = buf[tile] + part
                        loads["c_partial_reads"] += 1
                    if kk < k_t - 1:
                        buf[tile] = val
                        loads["c_partial_writes"] += 1
                else:
                    val = acc = part if kk == 0 else acc + part
                if kk == k_t - 1:
                    out[tile] = val.to(a.dtype)
                    loads["c_writes"] += 1
    if return_loads:
        return out, loads
    return out


def block_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                 bn: int = 128, bk: int = 128, order: str = "mnk",
                 cluster: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """C = A @ B with planner-chosen tiles, loop order and K3 cluster.

    ``order`` is outer->inner over the tile loops, e.g. "mnk" iterates k
    fastest (output-stationary, K3), in clusters of ``cluster`` = (cm,
    cn) ranks along m and n that share their A and B tiles by TMA
    multicast (``core.planner.k3_cluster_ok``); any order with k outside
    launches K4, its innermost loop split over a cluster of
    ``core.planner.gemm_cluster_size`` blocks.  Dims must divide by the
    tiles (``ops.matmul`` pads).  CUDA tensors: A and B contiguous,
    starting on 16 bytes, tiles multiples of 16; launches on the current
    stream without synchronising (one launch, or one per k tile when k is
    outermost).
    CPU tensors: :func:`block_matmul_plain`.
    """
    trips = _check(a, b, bm, bn, bk, order)
    cluster = tuple(cluster)
    if a.device.type == "cpu":
        return block_matmul_plain(a, b, bm=bm, bn=bn, bk=bk, order=order,
                                  cluster=cluster)
    _check_cluster(bm, bn, bk, order, trips, cluster, a.element_size())
    cs = gemm_cluster_size(order, trips)
    rmw = order[2] != "k"
    kernel_limits(bm, bn, bk, a.element_size(), a, b, rmw=rmw)
    if not a.is_contiguous() or not b.is_contiguous():
        raise KernelShapeError("A and B must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    name = "block_matmul_rmw" if rmw else "block_matmul_osta"
    core = core_of(bm, bn, bk, a.dtype)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    # K4's partials: C itself when C is f32, else an f32 buffer
    buf = out if (not rmw or a.dtype == torch.float32) else torch.empty(
        (m, n), dtype=torch.float32, device=a.device)
    launch = _LAUNCH[name]
    order_codes = [_DIM_CODES[d] for d in order]
    for grid_dims, k_lo, k_cnt in launch_plan(order, trips):
        grid_x, grid_y, axes = launch_grid(grid_dims, trips, cs)
        launch(a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
               buf.data_ptr(), _DTYPE_CODES[a.dtype], m, n, k, bm, bn, bk,
               *order_codes, axes.get("m", -1), axes.get("n", -1), k_lo,
               k_cnt, int(rmw), cs, *cluster, K3_RASTER_ROWS, grid_x, grid_y)
        LAST_LAUNCH.update(
            name=name, core=core, cluster=gemm_cluster_size(
                order, trips, cluster), k3_cluster=cluster,
            grid_cluster=k3_grid_cluster(order, cluster) if not rmw
            else (cs, 1), grid=(grid_x, grid_y))
    return out
