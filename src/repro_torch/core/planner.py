"""Offloading-schedule planner: the paper's formalism applied to the tiling
of the port's CUDA kernels.

The paper's strategy model — steps that (free, write-back, load
I_slice/K_sub, compute) against an on-chip memory of size ``size_MEM`` —
maps onto a CUDA kernel as:

    on-chip memory  = the shared memory one thread block can use
    a step          = one grid step (K2: one block; K1: one loop iteration)
    I_slice/K_sub   = device-memory -> shared-memory fetches
    delta (eq. 15)  = device-memory bytes moved / bandwidth + step overheads

For an operator the planner enumerates candidate strategies, prices each
with the paper's duration model under the card's constants
(:class:`~repro_torch.core.cost_model.GpuChipModel`: data-sheet figures
and rates measured on the card), and returns the argmin.  A candidate is
feasible when the shared memory its CUDA kernel really allocates
(``*_smem_bytes`` below, the same formulas as in the kernels' sources)
fits one block.  The tile candidates are Hopper-shaped:
multiples of 16 from 16 up, not the TPU's 128-wide lanes.
"""
from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import (H100_SXM, TPU_V5E, GpuChipModel,
                                         TpuChipModel)
from repro_torch.core.strategies import tiled as tiled_strategy

# The block GeMM kernel's C tile (csrc/block_matmul.cu): in bfloat16, one
# or two warpgroups each holding a 64 x bn wgmma accumulator (bm 64, 128;
# bn up to 256), or 8 warps each holding up to 4x4 tensor-core fragments
# of 16x8 (a 64x32 piece); in float32, 16x16 threads each holding up to 8
# rows x 4 column pairs.  So bm is at most 128, bn at most 256 on the
# wgmma core and 128 on the others, and every tile is a multiple of 16
# (the fragments' and the 16-byte copies' grain).
MATMUL_MAX_TILE = 256
MATMUL_MAX_BM = 128
# float32's threads multiply their whole 8 x 8 pieces, zeros past the tile,
# so every tile costs the product of a 128 x 128 one
MATMUL_FMA_TILE = 128
MATMUL_MAX_BN_SYNC = 128
# K3 runs in clusters of 1 or 2 ranks along m and along n, the ranks of a
# tile row sharing each A tile and those of a tile column each B tile by
# TMA multicast; its blocks take the tiles in groups of K3_RASTER_ROWS
# tile rows (of the grid's outer loop), column by column.
K3_MAX_CLUSTER_SIDE = 2
K3_RASTER_ROWS = 16
# K4 splits its innermost loop over a cluster of at most this many blocks
# (the portable cluster size on Hopper).
MATMUL_MAX_CLUSTER = 8
# The planned conv kernel (K1) runs each layer on a cluster of at most this
# many blocks: its kernel set split by output channel into groups of at
# least CONV_MIN_CHANNELS_PER_BLOCK, each group's step product split by
# output column into runs of at least CONV_MIN_COLUMNS_PER_BLOCK.  Each
# block keeps a ring of CONV_RING_DEPTH staging slots for the steps' boxes.
CONV_MAX_CLUSTER = 8
CONV_MIN_CHANNELS_PER_BLOCK = 8
CONV_MIN_COLUMNS_PER_BLOCK = 4
CONV_RING_DEPTH = 2


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, m: int) -> int:
    return _ceil_div(a, m) * m


@dataclasses.dataclass(frozen=True)
class Plan:
    """A chosen offloading schedule for one operator instance."""

    kind: str
    tiles: dict
    order: str
    steps: int
    hbm_bytes: int              # sum of I_slice/K_sub/W over all steps
    flops: int
    smem_bytes: int             # shared memory one block of the kernel uses
    duration_additive: float    # paper Def 3: loads + writes + compute
    duration_overlapped: float  # max(mem, compute); GeMM: max of its terms
    # block GeMM: what L2 serves (a multicast tile once), what reaches
    # device memory under the launch's tile order, and K3's cluster
    # (ranks along m, along n)
    l2_bytes: int | None = None
    dram_bytes: int | None = None
    cluster: tuple[int, int] = (1, 1)

    @property
    def arithmetic_intensity(self) -> float:  # lint: public-api
        return self.flops / max(1, self.hbm_bytes)


# The simple conv kernel (K2, csrc/conv2d_offload.cu): 256 threads, each
# holding a register tile of 4 output columns x 4 kernel channels; the
# C_in*H_K*W_K reduction is split over groups of threads, each group at
# least CONV_SIMPLE_MIN_K deep.
CONV_SIMPLE_THREADS = 256
CONV_SIMPLE_TILE = (4, 4)
CONV_SIMPLE_MIN_K = 4


def conv_simple_k_groups(t_run: int, n: int, k_total: int) -> int:
    """Groups of threads the simple conv kernel splits its reduction of
    ``k_total = C_in*H_K*W_K`` over: the largest power of two that leaves
    every register tile of the ``(t_run x N)`` output block a thread in
    each group and every group at least ``CONV_SIMPLE_MIN_K`` terms (1
    when the tiles alone fill the block).  ``conv_simple_k_groups`` in
    ``kernels/csrc/conv2d_offload.cu`` is the same rule."""
    tt, tn = CONV_SIMPLE_TILE
    tiles = _ceil_div(t_run, tt) * _ceil_div(n, tn)
    cap = min(CONV_SIMPLE_THREADS // tiles, k_total // CONV_SIMPLE_MIN_K)
    kg = 1
    while kg * 2 <= cap:
        kg *= 2
    return kg


def conv_simple_smem_bytes(spec: ConvSpec, t_run: int,
                           dtype_bytes: int) -> int:
    """Shared memory one block of the simple conv kernel allocates: its
    ``(C_in, H_K, t_in)`` input window and, when the reduction is split
    over more than one group, each group's f32 ``(N, t_run)`` partial
    block, from the next 16-byte boundary (Λ is read through L1 in its own
    layout, the output goes to device memory).  The same formula as
    ``conv2d_offload_smem_bytes`` in ``kernels/csrc/conv2d_offload.cu``."""
    t_in = (t_run - 1) * spec.s_w + spec.w_k
    window = spec.c_in * spec.h_k * t_in * dtype_bytes
    kg = conv_simple_k_groups(t_run, spec.c_out,
                              spec.c_in * spec.h_k * spec.w_k)
    if kg == 1:
        return window
    return _round_up(window, 16) + 4 * kg * t_run * spec.c_out


def matmul_max_bn(bm: int, dtype_bytes: int) -> int:
    """The widest bn the block GeMM kernel takes at this bm: 256 on the
    wgmma core (``MM_WG_MAX_BN``), 128 on mma.sync and fma."""
    if matmul_core(bm, 16, 16, dtype_bytes) == "wgmma":
        return MATMUL_MAX_TILE
    return MATMUL_MAX_BN_SYNC


def matmul_core(bm: int, bn: int, bk: int, dtype_bytes: int) -> str:
    """The core of the block GeMM kernel a tile runs on: ``"wgmma"`` for
    bfloat16 tiles of whole warpgroups of rows (``bm % 64 == 0``; one
    64-row warpgroup product each), ``"mma.sync"`` for the other bfloat16
    tiles, ``"fma"`` for float32 (the f32 units: TF32 would not hold f32's
    tolerance).  ``mm_core`` in ``kernels/csrc/block_matmul.cu`` is the
    same rule; ``kernels.block_matmul.core_of`` takes a dtype."""
    del bn, bk   # the rule reads the rows and the type alone
    if dtype_bytes == 4:
        return "fma"
    return "wgmma" if bm % 64 == 0 else "mma.sync"


# The wgmma core's rings hold 2 to this many slots of one A and one B
# tile; 1024 bytes align its shared memory to the 128-byte swizzle's
# period and 256 hold its mbarriers.
MATMUL_WG_MAX_STAGES = 4
MATMUL_WG_FIXED_BYTES = 1024 + 256


def matmul_wg_stages(bm: int, bn: int, bk: int, rmw: bool) -> int:
    """Slots of the wgmma core's A and B rings: as many as fit one block's
    shared memory beside K4's (``rmw``) partial C stage, from 2 up to
    ``MATMUL_WG_MAX_STAGES`` (``wg_stages`` in
    ``kernels/csrc/block_matmul.cu``)."""
    stage = 2 * (bm * bk + bk * bn)
    c_stage = 4 * bm * bn if rmw else 0
    fit = (H100_SXM.smem_bytes_per_block - MATMUL_WG_FIXED_BYTES
           - c_stage) // stage
    return min(MATMUL_WG_MAX_STAGES, max(2, fit))


def matmul_smem_bytes(bm: int, bn: int, bk: int, dtype_bytes: int,
                      rmw: bool = False) -> int:
    """Shared memory one block of the block GeMM kernel allocates, by core
    (:func:`matmul_core`), for K3 or, with ``rmw``, K4.  wgmma: the
    rings' :func:`matmul_wg_stages` slots of unpadded (swizzled) A and B
    tiles, K4's f32 partial C stage (bm x bn) and the fixed bytes.
    mma.sync and fma, either kernel: two stages of the A tile and of the B
    tile, each row padded by 16 bytes against bank conflicts (the C tile
    stays in registers, or goes through the f32 buffer in device memory).
    The same formula as ``block_matmul_smem_bytes`` in
    ``kernels/csrc/block_matmul.cu``."""
    if matmul_core(bm, bn, bk, dtype_bytes) == "wgmma":
        return (MATMUL_WG_FIXED_BYTES
                + matmul_wg_stages(bm, bn, bk, rmw) * 2 * (bm * bk + bk * bn)
                + (4 * bm * bn if rmw else 0))
    pad = 16 // dtype_bytes
    return 2 * (bm * (bk + pad) + bk * (bn + pad)) * dtype_bytes


# The decode split kernel (csrc/flash_decode.cu): DECODE_WARPS warps a
# block, each streaming its own tiles of the block's range through a ring
# of its own in shared memory (core.planner.decode_ring sizes it); a block
# holds at most DECODE_MAX_G query rows, so a KV head with more takes
# several blocks.  Its launch bounds cap a thread's registers
# (decode_regs).
DECODE_WARPS = 4
DECODE_MAX_G = 8
# Its tiles (rows of a slot, multiples of 8 where the scores run on the
# tensor cores) and its slots; the cache's padding grain of a range (rows).
DECODE_TILES = (16, 8, 4)
DECODE_STAGES = (4, 3, 2)
DECODE_GRAIN = 16
# At most this many blocks per (batch, KV head) range over the cache.
DECODE_MAX_SPLITS = 64


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def decode_smem_bytes(q_rows: int, head_dim: int, tile: int, stages: int,
                      warps: int, kv_bytes: int) -> int:
    """Shared memory one block of the decode split kernel allocates: each
    warp's ``(tile, G')`` f32 scores (``G' = min(G, 8)`` rounded up to a
    power of two); where the shape lets it score on the tensor cores
    (:func:`decode_mma`, tiles of 8 rows), 8 query rows of ``D`` bf16;
    then each warp's ring of ``stages`` slots of K and V, ``tile x D``
    each in the cache's type; the warps' merge buffer, ``(min(G, 8),
    D + 2)`` f32 a warp, reuses the rings' space (the carry lives in
    registers).  The same formula as ``flash_decode_smem_bytes`` in
    ``kernels/csrc/flash_decode.cu``."""
    rows = min(q_rows, DECODE_MAX_G)
    ring = 2 * warps * stages * tile * head_dim * kv_bytes
    merge = 4 * warps * rows * (head_dim + 2)
    q = 2 * DECODE_MAX_G * head_dim \
        if decode_mma(q_rows, head_dim, kv_bytes) and tile % 8 == 0 else 0
    return 4 * warps * tile * _pow2_at_least(rows) + q + max(ring, merge)


def decode_regs(q_rows: int) -> int:
    """Registers a thread of the decode split kernel may take: its launch
    bounds ask an SM to hold 2 blocks of 8 warps where the block's query
    rows round up to 4 or 8 (``acc`` alone takes 8 x 4 or 8 x 8 of them),
    3 below; 65 536 over those threads, in the register file's grain of
    8 (the launch bounds of ``flash_decode_split_kernel``)."""
    blocks = 2 if _pow2_at_least(min(q_rows, DECODE_MAX_G)) >= 4 else 3
    return H100_SXM.regs_per_sm // (blocks * 256) // 8 * 8


def decode_blocks_per_sm(smem: int, warps: int, regs: int,
                         chip: GpuChipModel = H100_SXM) -> int:
    """Blocks of the decode split kernel one SM holds at once: the least of
    what its shared memory (each block's ``smem`` and the bytes held back
    for it), its registers (``regs`` a thread, :func:`decode_regs`) and
    its warps allow."""
    return min(chip.smem_bytes_per_sm
               // (smem + chip.smem_reserved_per_block),
               chip.regs_per_sm // (regs * 32 * warps),
               chip.warps_per_sm // warps)


def decode_mma(q_rows: int, head_dim: int, kv_bytes: int) -> bool:
    """Whether the split kernel scores a bf16 cache on the tensor cores
    (``mma.sync.m16n8k16``, f32 sums): G of at least 2 and D a multiple
    of 16, in tiles of 8 rows; the query has to be bf16 too, which
    :mod:`repro_torch.kernels.flash_decode` checks at the launch."""
    return kv_bytes == 2 and q_rows >= 2 and head_dim % 16 == 0


def decode_ring(q_rows: int, head_dim: int, kv_bytes: int,
                chip: GpuChipModel = H100_SXM) -> dict[str, int]:
    """The split kernel's ring, ``{"tile", "stages", "warps"}``: rows of a
    slot, slots a warp, warps a block.  Sized by residency and not by one
    block's shared memory: among tiles of ``DECODE_TILES`` (of 8 rows or
    more where the scores run on the tensor cores) and ``DECODE_STAGES``
    slots whose block fits, the first pick is the one whose blocks keep
    the most warps resident an SM (by shared memory and
    :func:`decode_regs`), then the largest tile (the least work a softmax
    update), then the most slots (the most of the cache in flight:
    ``stages - 1`` tiles a warp)."""
    tiles = [t for t in DECODE_TILES
             if not decode_mma(q_rows, head_dim, kv_bytes) or t % 8 == 0]
    regs = decode_regs(q_rows)
    best, key = None, None
    for tile, stages in itertools.product(tiles, DECODE_STAGES):
        smem = decode_smem_bytes(q_rows, head_dim, tile, stages,
                                 DECODE_WARPS, kv_bytes)
        if smem > chip.smem_bytes_per_block:
            continue
        resident = DECODE_WARPS * decode_blocks_per_sm(smem, DECODE_WARPS,
                                                       regs, chip)
        cand = (resident, tile, stages)
        if key is None or cand > key:
            best, key = {"tile": tile, "stages": stages,
                         "warps": DECODE_WARPS}, cand
    if best is None:
        raise ValueError("no ring of the decode kernel fits one block")
    return best


# --------------------------------------------------------------------- #
# Block GeMM (paper Sec 1.3: TMMA/VTA adaptation — "we need to slightly
# adapt our ILP problem").  Strategies = loop orders x tile shapes.
# --------------------------------------------------------------------- #

_ORDERS = ("mnk", "mkn", "nmk", "nkm", "kmn", "knm")   # outer->inner


def _gemm_bytes(m_t: int, n_t: int, k_t: int, bm: int, bn: int, bk: int,
                mm: int, nn: int, kk: int, order: str,
                dtype_bytes: int, acc_bytes: int) -> int:
    """Device-memory bytes for C[M,N] += A[M,K] B[K,N] under a loop order:
    a tile is fetched again only when its index changes between
    consecutive steps (the formalism's I_slice), which is what the block
    GeMM kernel does inside each block.

    A tiles are indexed by (m,k), B by (k,n), C by (m,n).  With k not
    innermost the C tile leaves the chip while partial: every visit but
    the first reads the partial back and every visit but the last writes
    it, at ``acc_bytes`` (the kernel's f32 buffer), and the last visit
    writes C at ``dtype_bytes``."""
    a_bytes = bm * bk * dtype_bytes
    b_bytes = bk * bn * dtype_bytes
    c_bytes = bm * bn * dtype_bytes
    trips = {"m": m_t, "n": n_t, "k": k_t}

    def loads(dep: set[str]) -> int:
        """Distinct consecutive index changes for an operand depending on
        ``dep`` ⊆ {m,n,k}: product of trip counts of all loops at or outside
        the innermost loop the operand depends on."""
        deepest = max(order.index(d) for d in dep)
        total = 1
        for pos in range(deepest + 1):
            total *= trips[order[pos]]
        return total

    total = loads({"m", "k"}) * a_bytes + loads({"k", "n"}) * b_bytes
    total += m_t * n_t * c_bytes                       # final writes
    if order.index("k") < 2:
        partial = bm * bn * acc_bytes
        visits = loads({"m", "n"})
        total += 2 * (visits - m_t * n_t) * partial
    return total


def gemm_cluster_size(order: str, trips: dict[str, int],
                      cluster: tuple[int, int] = (1, 1)) -> int:
    """Blocks of a cluster of the block GeMM kernel: for k innermost (K3)
    its ``cluster`` of ``cm x cn`` ranks, each with its own C tile;
    otherwise (K4) the innermost loop is split over
    ``min(MATMUL_MAX_CLUSTER, its trips)`` blocks."""
    if order[2] == "k":
        return cluster[0] * cluster[1]
    return min(MATMUL_MAX_CLUSTER, trips[order[2]])


def k3_cluster_ok(bm: int, bn: int, bk: int, m_t: int, n_t: int, cm: int,
                  cn: int, dtype_bytes: int) -> bool:
    """Whether K3 takes a cluster of ``cm x cn`` ranks at these tiles and
    trips: 1 or 2 ranks a side, each dividing its trips (at m = 1920 and
    bm 128 the 15 tile rows take no 2 along m); more than one rank only on
    the wgmma core, where each sharer's part of a TMA box (bm / cn rows of
    A, min(bk, 256) / cm rows of B) starts on 1024 bytes of the slot, the
    128-byte swizzle's period.  ``block_matmul_k3_cluster_ok`` in
    ``kernels/csrc/block_matmul.cu`` is the same rule."""
    if not (1 <= cm <= K3_MAX_CLUSTER_SIDE and 1 <= cn <= K3_MAX_CLUSTER_SIDE
            and m_t % cm == 0 and n_t % cn == 0):
        return False
    if cm * cn == 1:
        return True
    if matmul_core(bm, bn, bk, dtype_bytes) != "wgmma":
        return False
    rows_b = min(bk, 256)
    return ((bm // cn) * atom_width(bk) * 2 % 1024 == 0
            and (rows_b // cm) * atom_width(bn) * 2 % 1024 == 0)


def k3_clusters(bm: int, bn: int, bk: int, m_t: int, n_t: int,
                dtype_bytes: int) -> list[tuple[int, int]]:
    """The K3 clusters :func:`plan_matmul` offers: every ``(cm, cn)``
    :func:`k3_cluster_ok` takes."""
    sides = range(1, K3_MAX_CLUSTER_SIDE + 1)
    return [(cm, cn) for cm in sides for cn in sides
            if k3_cluster_ok(bm, bn, bk, m_t, n_t, cm, cn, dtype_bytes)]


def atom_width(extent: int) -> int:
    """Elements of one swizzled row of a wgmma tile, the widest of 64, 32
    and 16 bf16 that divides the tile's contiguous extent (``atom_width``
    of ``csrc/block_matmul.cu``): a TMA box is that wide."""
    return 64 if extent % 64 == 0 else 32 if extent % 32 == 0 else 16


def k3_grid_cluster(order: str, cluster: tuple[int, int]
                    ) -> tuple[int, int]:
    """K3's cluster extent along the CUDA grid's x and y axes: the grid's
    inner loop (n for ``mnk``, m for ``nmk``) is on x."""
    cm, cn = cluster
    return (cn, cm) if order[1] == "n" else (cm, cn)


def k3_raster(lin: int, ncx: int, ncy: int, gy: int) -> tuple[int, int]:
    """The cluster (x, y) that K3's ``lin``-th cluster in launch order
    computes, on a grid of ``ncx x ncy`` clusters taken in groups of
    ``gy`` cluster rows, each group column by column (``k3_tile`` of
    ``csrc/block_matmul.cu``)."""
    first = lin // (gy * ncx) * gy
    rows = min(gy, ncy - first)
    within = lin - first * ncx
    return within // rows, first + within % rows


def _k3_wave_panels(ncx: int, ncy: int, gy: int, wave: int
                    ) -> list[tuple[int, int]]:
    """For each wave of ``wave`` clusters in launch order: the distinct
    cluster rows and cluster columns of :func:`k3_raster` it covers."""
    total = ncx * ncy
    out = []
    for lo in range(0, total, wave):
        hi = min(total, lo + wave)
        rows, spans, at = 0, [], lo
        while at < hi:
            first = at // (gy * ncx) * gy
            nrows = min(gy, ncy - first)
            start = first * ncx
            u0, u1 = at - start, min(hi, start + nrows * ncx) - start
            rows += min(nrows, u1 - u0)
            spans.append((u0 // nrows, (u1 - 1) // nrows))
            at = start + u1
        spans.sort()
        cols, end = 0, -1
        for c0, c1 in spans:
            if c1 > end:
                cols += c1 - max(c0, end + 1) + 1
                end = c1
        out.append((rows, cols))
    return out


def conv_cluster_shape(n: int, t_run: int) -> tuple[int, int]:
    """``(cs_n, cs_t)``: the planned conv kernel's cluster for ``n`` kernel
    channels and ``t_run`` output columns a step.  ``cs_n`` is the largest
    power of two up to ``CONV_MAX_CLUSTER`` that divides ``n`` and leaves
    every group at least ``CONV_MIN_CHANNELS_PER_BLOCK`` channels (1 for
    ``n < 16``); ``cs_t`` the largest power of two that divides ``t_run``,
    leaves every block at least ``CONV_MIN_COLUMNS_PER_BLOCK`` columns and
    keeps ``cs_n * cs_t <= CONV_MAX_CLUSTER``.  Rank ``g * cs_t + u`` keeps
    channels ``[g*n/cs_n, (g+1)*n/cs_n)`` of Λ and writes output columns
    ``[u*t_run/cs_t, (u+1)*t_run/cs_t)`` of each step.
    ``conv2d_offload_planned_cluster_shape`` in
    ``kernels/csrc/conv2d_offload_planned.cu`` is the same rule."""
    cs_n = CONV_MAX_CLUSTER
    while cs_n > 1 and (n % cs_n or n // cs_n < CONV_MIN_CHANNELS_PER_BLOCK):
        cs_n //= 2
    cs_t = 1
    while (cs_n * cs_t * 2 <= CONV_MAX_CLUSTER and t_run % (cs_t * 2) == 0
           and t_run // (cs_t * 2) >= CONV_MIN_COLUMNS_PER_BLOCK):
        cs_t *= 2
    return cs_n, cs_t


def gemm_grid_blocks(order: str, trips: dict[str, int]) -> int:
    """Thread blocks one launch of the block GeMM kernel runs at once: the
    loops outside k are on the grid, or, with k outermost, the middle loop
    (one launch per k tile), times K4's blocks of a cluster (K3's cluster
    groups its grid's blocks and adds none).
    ``kernels.block_matmul.launch_plan`` makes the launches."""
    pos_k = order.index("k")
    blocks = 1 if order[2] == "k" else gemm_cluster_size(order, trips)
    for d in ((order[1],) if pos_k == 0 else order[:pos_k]):
        blocks *= trips[d]
    return blocks


def _k3_dram_bytes(order: str, trips: dict[str, int], bm: int, bn: int,
                   bk: int, cluster: tuple[int, int], dtype_bytes: int,
                   stages: int, chip: GpuChipModel) -> int:
    """Device-memory bytes of a K3 launch under its raster: each wave of
    ``min(grid, SMs its clusters fill)`` blocks, in launch order, reads
    each distinct A row panel and B column panel once (the other blocks
    of the wave find them in L2), and C is written once.  A wave whose
    tiles in flight (its panels' ``stages`` k tiles) do not fit L2 reads
    what its blocks fetch.  Never below the compulsory bytes nor above the
    trips."""
    cx, cy = k3_grid_cluster(order, cluster)
    outer, inner = order[0], order[1]
    ncx, ncy = trips[inner] // cx, trips[outer] // cy
    panel = {"m": bm * trips["k"] * bk * dtype_bytes,
             "n": bn * trips["k"] * bk * dtype_bytes}
    in_flight = {"m": bm * bk * dtype_bytes * stages,
                 "n": bn * bk * dtype_bytes * stages}
    wave = min(ncx * ncy * cx * cy, _cluster_sms(cx * cy, chip)) // (cx * cy)
    dram = 0
    for rows, cols in _k3_wave_panels(ncx, ncy, K3_RASTER_ROWS // cy, wave):
        y, x = rows * cy, cols * cx
        if y * in_flight[outer] + x * in_flight[inner] <= chip.l2_bytes:
            dram += y * panel[outer] + x * panel[inner]
        else:
            dram += wave * cx * cy * (panel["m"] + panel["n"])
    m, n, k = (trips[d] * t for d, t in (("m", bm), ("n", bn), ("k", bk)))
    c_bytes = m * n * dtype_bytes
    trip_bytes = trips["m"] * trips["n"] * (panel["m"] + panel["n"])
    compulsory = (m * k + k * n) * dtype_bytes
    return max(compulsory, min(trip_bytes, dram)) + c_bytes


def _cluster_sms(size: int, chip: GpuChipModel) -> int:
    """SMs that clusters of ``size`` blocks of one block an SM fill."""
    return chip.sms_in_clusters_of_4 if size == 4 else chip.n_sms


def gemm_terms(trips: dict[str, int], bm: int, bn: int, bk: int,
               order: str, cluster: tuple[int, int], dtype_bytes: int,
               chip: GpuChipModel = H100_SXM, *, dram: bool = True) -> dict:
    """What one block GeMM schedule moves, and its duration terms in
    seconds, each for the grid's share of the card: a launch runs its
    blocks (one an SM) in waves of as many as its clusters fit at once,
    so ``share`` is its blocks over its waves times the card's SMs (240
    blocks take two waves of 132, as 120 take one; clusters of 4 reach
    only ``sms_in_clusters_of_4`` SMs).

    Bytes: ``hbm_bytes``, the tile trips into shared memory
    (:func:`_gemm_bytes`, the formalism's I_slice fetches); ``l2_bytes``,
    what L2 serves of them (a tile multicast to a K3 cluster's sharers
    once); ``dram_bytes``, what reaches device memory (K3: each wave of
    blocks reads each distinct panel once, :func:`_k3_dram_bytes`; K4: the
    trips), skipped with ``dram=False``; ``push_bytes``, K4 rank 0's
    copies of the resident tile into its cs - 1 peers' slots.

    Terms: ``operations``, the SMs' time computing: ``tensor`` (the
    FLOPs the kernel computes, the padded product's, or on the fma core
    that of 128 x 128 tiles, over
    ``tensor_flops``, the tensor cores' rate measured while boxes land)
    plus ``step`` (each SM's steps, its waves' blocks' in turn, at
    ``step_cycles`` each: the work of a step beside its product, during
    which the kernel's tensor cores idle, so that a tile of half the
    product costs more than half the time); ``l2`` (the larger
    of ``l2_bytes`` over ``l2_bw`` and ``hbm_bytes`` over
    ``smem_fill_bw``: unicast is bound by what L2 serves, multicast by
    what lands); ``dram`` (``dram_bytes`` over ``hbm_bw``); ``push``
    (``push_bytes`` through one SM a cluster at ``push_bw``, the clusters
    that fit at once side by side)."""
    m_t, n_t, k_t = trips["m"], trips["n"], trips["k"]
    m, n, k = m_t * bm, n_t * bn, k_t * bk
    hbm = _gemm_bytes(m_t, n_t, k_t, bm, bn, bk, m, n, k, order,
                      dtype_bytes, 4)
    blocks = gemm_grid_blocks(order, trips)
    size = gemm_cluster_size(order, trips, cluster)
    waves = _ceil_div(blocks, _cluster_sms(size, chip))
    share = blocks / (waves * chip.n_sms)
    out = {"hbm_bytes": hbm, "l2_bytes": hbm, "dram_bytes": hbm,
           "push_bytes": 0, "share": share}
    if order[2] == "k":
        cm, cn = cluster
        a_trips = m_t * n_t * k_t * bm * bk * dtype_bytes
        b_trips = m_t * n_t * k_t * bk * bn * dtype_bytes
        out["l2_bytes"] = hbm - a_trips - b_trips + a_trips // cn \
            + b_trips // cm
        if dram:
            out["dram_bytes"] = _k3_dram_bytes(
                order, trips, bm, bn, bk, cluster, dtype_bytes,
                matmul_wg_stages(bm, bn, bk, False)
                if matmul_core(bm, bn, bk, dtype_bytes) == "wgmma" else 2,
                chip)
    elif size > 1:
        tile = bm * bk if order[2] == "n" else bk * bn
        fetches = m_t * k_t if order[2] == "n" else k_t * n_t
        out["push_bytes"] = (size - 1) * fetches * tile * dtype_bytes
    flops = 2 * m * n * k
    if matmul_core(bm, bn, bk, dtype_bytes) == "fma":
        flops = 2 * m_t * n_t * MATMUL_FMA_TILE ** 2 * k
    out["tensor"] = flops / chip.tensor_flops / share
    out["step"] = (waves * m_t * n_t * k_t / blocks * chip.step_cycles
                   / chip.step_clock_hz)
    out["operations"] = out["tensor"] + out["step"]
    out["l2"] = max(out["l2_bytes"] / chip.l2_bw,
                    hbm / chip.smem_fill_bw) / share
    out["dram"] = out["dram_bytes"] / chip.hbm_bw / share
    at_once = max(1, min(blocks, chip.n_sms) // size)
    out["push"] = out["push_bytes"] / (chip.push_bw * at_once)
    return out


_TERMS = ("operations", "l2", "dram", "push")


# --------------------------------------------------------------------- #
# The reference's pricing on its own chip (src/repro/core/planner.py):
# given a TpuChipModel the planners below price the TPU's Pallas kernels
# exactly as the JAX package does, so that a claim the reference makes
# about its chip can be held on the port; no kernel or op of the port
# plans for that chip.  The budget is ``TpuChipModel.vmem_budget``, the
# tiles are the TPU's, the only rates are HBM's and the bf16 peak, and a
# plan's footprint goes in ``smem_bytes``.
# --------------------------------------------------------------------- #

_TPU_MATMUL_SIZES = (128, 256, 512, 1024, 2048)


def _tpu_plan(kind: str, tiles: dict, order: str, steps: int, hbm: int,
              flops: int, vmem: int, chip: TpuChipModel) -> Plan:
    t_mem = hbm / chip.hbm_bw
    t_cmp = flops / chip.peak_flops
    return Plan(kind=kind, tiles=tiles, order=order, steps=steps,
                hbm_bytes=hbm, flops=flops, smem_bytes=vmem,
                duration_additive=t_mem + t_cmp,
                duration_overlapped=max(t_mem, t_cmp))


def _tpu_plan_matmul(m: int, n: int, k: int, dtype_bytes: int,
                     chip: TpuChipModel) -> Plan:
    """The reference's ``plan_matmul``: tiles of 128-2048 (bm rounded to
    8, bn and bk to 128), A and B double-buffered in VMEM beside an f32 C
    block, C's partials at the dtype's bytes."""
    budget = chip.vmem_budget
    flops = 2 * m * n * k
    cands: list[Plan] = []
    for bm, bn, bk in itertools.product(_TPU_MATMUL_SIZES, repeat=3):
        bm_, bn_, bk_ = min(bm, _round_up(m, 8)), min(bn, _round_up(n, 128)), \
            min(bk, _round_up(k, 128))
        vmem = (2 * (bm_ * bk_ + bk_ * bn_) * dtype_bytes
                + bm_ * bn_ * 4)
        if vmem > budget:
            continue
        m_t, n_t, k_t = _ceil_div(m, bm_), _ceil_div(n, bn_), _ceil_div(k, bk_)
        for order in _ORDERS:
            hbm = _gemm_bytes(m_t, n_t, k_t, bm_, bn_, bk_, m, n, k, order,
                              dtype_bytes, dtype_bytes)
            cands.append(_tpu_plan("matmul", {"bm": bm_, "bn": bn_, "bk": bk_},
                                   order, m_t * n_t * k_t, hbm, flops, vmem,
                                   chip))
    if not cands:
        raise ValueError("no tile fits VMEM")
    return min(cands, key=_key)


def _tpu_plan_decode_attention(seq_len: int, head_dim: int, q_rows: int,
                               dtype_bytes: int, chip: TpuChipModel) -> Plan:
    """The reference's ``plan_decode_attention``: KV blocks of 128 up to
    8192 rows, doubling, that divide ``seq_len``; the fewest steps win."""
    budget = chip.vmem_budget
    flops = 4 * q_rows * seq_len * head_dim
    best: Plan | None = None
    bkv = 128
    while bkv <= max(128, min(seq_len, 8192)):
        vmem = (q_rows * head_dim * dtype_bytes
                + q_rows * head_dim * 4 + 2 * q_rows * 4
                + 2 * 2 * bkv * head_dim * dtype_bytes)
        if vmem <= budget and seq_len % bkv == 0:
            hbm = 2 * seq_len * head_dim * dtype_bytes \
                + 2 * q_rows * head_dim * dtype_bytes
            cand = _tpu_plan("decode_attention", {"bkv": bkv}, "kv",
                             seq_len // bkv, hbm, flops, vmem, chip)
            if best is None or cand.steps < best.steps:
                best = cand
        bkv *= 2
    if best is None:
        raise ValueError("no KV block fits VMEM")
    return best


def _tpu_plan_conv(spec: ConvSpec, dtype_bytes: int, chip: TpuChipModel,
                   max_run: int) -> Plan:
    """The reference's ``plan_conv``: Λ resident in VMEM, the input window
    double-buffered, an f32 output run."""
    budget = chip.vmem_budget
    flops = 2 * spec.macs_total
    best: Plan | None = None
    for t in range(1, min(max_run, spec.w_out) + 1):
        t_in = (t - 1) * spec.s_w + spec.w_k
        vmem = (spec.kernel_elements * dtype_bytes
                + 2 * spec.c_in * spec.h_k * t_in * dtype_bytes
                + spec.c_out * t * 4)
        if vmem > budget:
            continue
        strat = tiled_strategy(spec, t, tile=(1, t))
        hbm = (strat.pixels_loaded() * spec.c_in + spec.kernel_elements
               + spec.num_patches * spec.c_out) * dtype_bytes
        cand = _tpu_plan("conv2d", {"t": t}, "zigzag", strat.n_steps, hbm,
                         flops, vmem, chip)
        if best is None or (cand.duration_overlapped, cand.steps) < \
                (best.duration_overlapped, best.steps):
            best = cand
    if best is None:
        raise ValueError("conv does not fit VMEM at any run length")
    return best


def plan_matmul(m: int, n: int, k: int, dtype_bytes: int = 2,
                chip: GpuChipModel | TpuChipModel = H100_SXM) -> Plan:
    """Choose (bm, bn, bk, loop order, K3's cluster) minimising the
    paper's duration, among tiles the block GeMM kernel takes (bm in
    16..128, bn in 16..128 or 256 on the wgmma core, bk from 16 up, all
    powers of two) whose shared memory (:func:`matmul_smem_bytes` of the
    order's kernel, K3 or K4) fits one block, and for K3 every cluster
    :func:`k3_clusters` offers.

    The duration is priced as the H100 moves the tiles
    (:func:`gemm_terms`): ``duration_overlapped`` is the largest of the
    operations, L2's serving and landing of the tile trips, device
    memory's share of them and K4's pushes, ``duration_additive`` their
    sum.  The paper's steps run one after another on one processing
    element; on the card the blocks of a launch share out the SMs in
    waves, so a plan whose grid leaves SMs idle (fewer blocks than the
    SMs its clusters fill, or a last wave short of them) gets only that
    share of the card's rates.  Without it
    the orders with k in the middle, whose grid was one loop, won on bytes
    and ran 6-24x slower than k innermost on an H100 (PERF.md).

    Given a :class:`TpuChipModel` it plans as the reference planner does
    on that chip (:func:`_tpu_plan_matmul`)."""
    if isinstance(chip, TpuChipModel):
        return _tpu_plan_matmul(m, n, k, dtype_bytes, chip)
    budget = chip.smem_bytes_per_block
    best: Plan | None = None
    mn_sizes = [MATMUL_MAX_TILE, 128, 64, 32, 16]
    k_sizes = [16, 32, 64, 128, 256, 512, 1024]
    for bm, bn, bk in itertools.product(mn_sizes, mn_sizes, k_sizes):
        bm_, bn_, bk_ = (min(bm, _round_up(m, 16)), min(bn, _round_up(n, 16)),
                         min(bk, _round_up(k, 16)))
        if bm_ > MATMUL_MAX_BM or bn_ > matmul_max_bn(bm_, dtype_bytes):
            continue
        trips = {"m": _ceil_div(m, bm_), "n": _ceil_div(n, bn_),
                 "k": _ceil_div(k, bk_)}
        for order in _ORDERS:
            rmw = order[2] != "k"
            smem = matmul_smem_bytes(bm_, bn_, bk_, dtype_bytes, rmw=rmw)
            if smem > budget:
                continue
            clusters = [(1, 1)] if rmw else k3_clusters(
                bm_, bn_, bk_, trips["m"], trips["n"], dtype_bytes)
            for cluster in clusters:
                terms = gemm_terms(trips, bm_, bn_, bk_, order, cluster,
                                   dtype_bytes, chip, dram=False)
                if best is not None and max(
                        terms[t] for t in _TERMS if t != "dram") \
                        > best.duration_overlapped:
                    continue     # device memory can only add to it
                terms = gemm_terms(trips, bm_, bn_, bk_, order, cluster,
                                   dtype_bytes, chip)
                times = [terms[t] for t in _TERMS]
                cand = Plan(
                    kind="matmul", tiles={"bm": bm_, "bn": bn_, "bk": bk_},
                    order=order, steps=trips["m"] * trips["n"] * trips["k"],
                    hbm_bytes=terms["hbm_bytes"], flops=2 * m * n * k,
                    smem_bytes=smem, duration_additive=sum(times),
                    duration_overlapped=max(times),
                    l2_bytes=terms["l2_bytes"],
                    dram_bytes=terms["dram_bytes"], cluster=cluster)
                if best is None or _key(cand) < _key(best):
                    best = cand
    if best is None:
        raise ValueError("no tile fits one block's shared memory")
    return best


def _key(p: Plan) -> tuple:
    return p.duration_overlapped, p.duration_additive, p.steps


# --------------------------------------------------------------------- #
# Decode attention: S1 with roles swapped — Q is the resident "kernel set",
# KV blocks are the patches (disjoint, stride == block -> no halo).
# --------------------------------------------------------------------- #

def plan_decode_attention(seq_len: int, head_dim: int, q_rows: int,
                          dtype_bytes: int = 2,
                          chip: GpuChipModel | TpuChipModel = H100_SXM
                          ) -> Plan:
    """Plan the decode kernel's walk over one (batch, KV head)'s cache of
    ``seq_len`` rows in one range: the cache padded to the grain of
    ``DECODE_GRAIN`` rows (``tiles["bkv"]``), streamed through the ring
    of :func:`decode_ring` (its keys in ``tiles`` too; ``steps`` are its
    tiles).  The padded rows are priced.  Given a
    :class:`TpuChipModel` it plans as the reference planner does
    (:func:`_tpu_plan_decode_attention`): the largest VMEM block."""
    if isinstance(chip, TpuChipModel):
        return _tpu_plan_decode_attention(seq_len, head_dim, q_rows,
                                          dtype_bytes, chip)
    ring = decode_ring(q_rows, head_dim, dtype_bytes, chip)
    padded = _round_up(seq_len, DECODE_GRAIN)
    flops = 4 * q_rows * padded * head_dim      # QK^T + PV
    hbm = 2 * padded * head_dim * dtype_bytes \
        + 2 * q_rows * head_dim * dtype_bytes
    t_mem = hbm / chip.hbm_bw
    t_cmp = flops / chip.tensor_flops
    return Plan(kind="decode_attention",
                tiles={"bkv": DECODE_GRAIN, **ring}, order="kv",
                steps=_ceil_div(padded, ring["tile"]), hbm_bytes=hbm,
                flops=flops,
                smem_bytes=decode_smem_bytes(
                    q_rows, head_dim, ring["tile"], ring["stages"],
                    ring["warps"], dtype_bytes),
                duration_additive=t_mem + t_cmp,
                duration_overlapped=max(t_mem, t_cmp))


def plan_decode_split(seq_len: int, head_dim: int, q_rows: int,
                      heads: int, dtype_bytes: int = 2,
                      chip: GpuChipModel = H100_SXM) -> Plan:
    """Choose how many blocks share one (batch, KV head)'s cache for the
    decode split kernel and its combine; ``heads`` is batch x KV heads,
    and each takes ``groups = ceil(G / 8)`` blocks per range (one per 8
    query rows, each reading the range).

    The ring is :func:`decode_ring`'s, so the card holds ``slots =
    n_sms x`` :func:`decode_blocks_per_sm` blocks at once.  Candidates
    are ``splits`` of 1, 2, 4, ... while a range keeps at least 16 rows
    and the grid (``heads * groups * splits`` blocks) at most the slots.
    Each split takes ``range = round_up(ceil(S / splits), 16)`` rows.
    The duration is the paper's, priced as the card runs the grid: a
    warp of a slot moves its share of the card's rates, and a block takes
    as long as its busiest warp (``ceil(range / (tile x warps))`` tiles),
    so a grid of ``waves = ceil(blocks / slots)`` takes ``waves x slots x
    warps x that warp's rows / (blocks x range)`` times what the whole
    card would.  Bytes are the padded cache once per group, one q load
    per split, the output once, and, with more than one split, the f32
    partials ``(G, D + 2)`` per split written and read back by
    the combine.  Where ``splits x 16`` does not divide ``S``,
    ``ops.decode_attention`` pads the cache on every call: its copy (K
    and V read at ``S`` rows and written at the padded ones) is priced
    too, at the card's whole rate.  Among equal durations, fewer splits
    win.  ``tiles`` holds ``bkv`` (16, the grain of a range), ``splits``
    and the ring's ``tile``, ``stages`` and ``warps``;
    ``ops.decode_attention`` pads the cache to a multiple of ``splits *
    bkv``."""
    ring = decode_ring(q_rows, head_dim, dtype_bytes, chip)
    smem = decode_smem_bytes(q_rows, head_dim, ring["tile"], ring["stages"],
                             ring["warps"], dtype_bytes)
    slots = chip.n_sms * decode_blocks_per_sm(
        smem, ring["warps"], decode_regs(q_rows), chip)
    s16 = _round_up(seq_len, DECODE_GRAIN)
    blocks = heads * _ceil_div(q_rows, DECODE_MAX_G)   # per range
    best: Plan | None = None
    splits = 1
    while splits == 1 or (splits * DECODE_GRAIN <= s16
                          and splits <= DECODE_MAX_SPLITS
                          and blocks * splits <= slots):
        rng = _round_up(_ceil_div(seq_len, splits), DECODE_GRAIN)
        padded = rng * splits
        q_bytes = q_rows * head_dim * dtype_bytes
        partials = 2 * splits * q_rows * (head_dim + 2) * 4 \
            if splits > 1 else 0
        hbm = 2 * blocks * padded * head_dim * dtype_bytes \
            + heads * ((splits + 1) * q_bytes + partials)
        copy = 0 if seq_len % (DECODE_GRAIN * splits) == 0 else \
            2 * heads * (seq_len + padded) * head_dim * dtype_bytes
        flops = heads * 4 * q_rows * padded * head_dim
        grid = blocks * splits
        warp_rows = _ceil_div(rng, ring["tile"] * ring["warps"]) \
            * ring["tile"]
        share = grid * rng / (_ceil_div(grid, slots) * slots
                              * ring["warps"] * warp_rows)
        t_mem = hbm / chip.hbm_bw / share + copy / chip.hbm_bw
        t_cmp = flops / chip.tensor_flops / share
        cand = Plan(kind="decode_attention",
                    tiles={"bkv": DECODE_GRAIN, "splits": splits, **ring},
                    order="kv", steps=_ceil_div(rng, ring["tile"]),
                    hbm_bytes=hbm + copy, flops=flops, smem_bytes=smem,
                    duration_additive=t_mem + t_cmp,
                    duration_overlapped=max(t_mem, t_cmp))
        if best is None or cand.duration_overlapped < \
                best.duration_overlapped:
            best = cand
        splits *= 2
    return best


def plan_conv(spec: ConvSpec, dtype_bytes: int = 2,
              chip: GpuChipModel | TpuChipModel = H100_SXM,
              max_run: int = 64) -> Plan:
    """Pick the row-run length T for the simple conv kernel behind
    ``ops.conv2d``: each grid step computes a (1 x T) run of output
    columns for all C_out channels.  Cost = paper eq. 15 with halo-aware
    I_slice, evaluated exactly via the strategy bitmasks; feasibility =
    the kernel's own shared-memory allocation against one block's limit
    on the card.  Given a :class:`TpuChipModel` it plans as the reference
    planner does (:func:`_tpu_plan_conv`)."""
    if isinstance(chip, TpuChipModel):
        return _tpu_plan_conv(spec, dtype_bytes, chip, max_run)
    budget = chip.smem_bytes_per_block
    flops = 2 * spec.macs_total
    best: Plan | None = None
    for t in range(1, min(max_run, spec.w_out) + 1):
        smem = conv_simple_smem_bytes(spec, t, dtype_bytes)
        if smem > budget:
            continue
        strat = tiled_strategy(spec, t, tile=(1, t))
        pixels = strat.pixels_loaded()
        hbm = (pixels * spec.c_in + spec.kernel_elements
               + spec.num_patches * spec.c_out) * dtype_bytes
        steps = strat.n_steps
        t_mem = hbm / chip.hbm_bw
        t_cmp = flops / chip.tensor_flops
        cand = Plan(kind="conv2d", tiles={"t": t}, order="zigzag",
                    steps=steps, hbm_bytes=hbm, flops=flops, smem_bytes=smem,
                    duration_additive=t_mem + t_cmp,
                    duration_overlapped=max(t_mem, t_cmp))
        if best is None or (cand.duration_overlapped, cand.steps) < \
                (best.duration_overlapped, best.steps):
            best = cand
    if best is None:
        raise ValueError(
            "conv does not fit one block's shared memory at any run length")
    return best
