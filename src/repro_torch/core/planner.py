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
with the paper's duration model under the card's data-sheet constants
(:class:`~repro_torch.core.cost_model.GpuChipModel`), and returns the
argmin.  A candidate is feasible when the shared memory its CUDA kernel
really allocates (``*_smem_bytes`` below, the same formulas as in the
kernels' sources) fits one block.  The tile candidates are Hopper-shaped:
multiples of 16 from 16 up, not the TPU's 128-wide lanes.
"""
from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import H100_SXM, GpuChipModel
from repro_torch.core.strategies import tiled as tiled_strategy

# The block GeMM kernel's C tile (csrc/block_matmul.cu): in bfloat16, one
# or two warpgroups each holding a 64 x bn wgmma accumulator (bm 64, 128),
# or 8 warps each holding up to 4x4 tensor-core fragments of 16x8 (a 64x32
# piece); in float32, 16x16 threads each holding up to 8 rows x 4 column
# pairs.  So bm and bn are at most 128, and every tile is a multiple of 16
# (the fragments' and the 16-byte copies' grain).
MATMUL_MAX_TILE = 128
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
    duration_overlapped: float  # max(mem, compute)

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


# The decode split kernel (csrc/flash_decode.cu): four warps per block,
# each copying its quarter of every stage's K and V rows into a ring of
# two slots of bkv / 2 rows (one KV block); a block holds at most
# DECODE_MAX_G query rows, so a KV head with more takes several blocks.
DECODE_WARPS = 4
DECODE_MAX_G = 8
# At most this many blocks per (batch, KV head) range over the cache.
DECODE_MAX_SPLITS = 64


def decode_smem_bytes(q_rows: int, head_dim: int, bkv: int,
                      kv_bytes: int) -> int:
    """Shared memory one block of the decode split kernel allocates: the
    ring of K and V, two slots of ``bkv / 2`` rows, in the cache's type and
    unpadded, and the warps' merge buffer, ``(min(G, 8), D + 2)`` f32 per
    warp (the query rows and the carry live in registers).  The same
    formula as ``flash_decode_smem_bytes`` in
    ``kernels/csrc/flash_decode.cu``."""
    return (2 * bkv * head_dim * kv_bytes
            + 4 * DECODE_WARPS * min(q_rows, DECODE_MAX_G) * (head_dim + 2))


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


def gemm_cluster_size(order: str, trips: dict[str, int]) -> int:
    """Blocks of a cluster of the block GeMM kernel: 1 for k innermost
    (K3); otherwise (K4) the innermost loop is split over
    ``min(MATMUL_MAX_CLUSTER, its trips)`` blocks."""
    if order[2] == "k":
        return 1
    return min(MATMUL_MAX_CLUSTER, trips[order[2]])


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
    (one launch per k tile), times the blocks of a cluster.
    ``kernels.block_matmul.launch_plan`` makes the launches."""
    pos_k = order.index("k")
    blocks = gemm_cluster_size(order, trips)
    for d in ((order[1],) if pos_k == 0 else order[:pos_k]):
        blocks *= trips[d]
    return blocks


def plan_matmul(m: int, n: int, k: int, dtype_bytes: int = 2,
                chip: GpuChipModel = H100_SXM) -> Plan:
    """Choose (bm, bn, bk, loop order) minimising the paper's duration,
    among tiles the block GeMM kernel takes (bm, bn in 16..128, bk from
    16 up, all powers of two) whose shared memory (:func:`matmul_smem_bytes`
    of the order's kernel, K3 or K4) fits one block.

    The paper's steps run one after another on one processing element;
    on the card the blocks of a launch share out the SMs, so a plan whose
    grid holds fewer blocks than the card has SMs gets only that share of
    the card's rates (both terms are divided by
    ``min(1, blocks / n_sms)``, K4's blocks counted with its cluster).
    Without it the orders with k in the middle, whose grid was one loop,
    won on bytes and ran 6-24x slower than k innermost on an H100
    (PERF.md)."""
    budget = chip.smem_bytes_per_block
    flops = 2 * m * n * k
    cands: list[Plan] = []
    mn_sizes = [16, 32, 64, MATMUL_MAX_TILE]
    k_sizes = [16, 32, 64, 128, 256, 512, 1024]
    for bm, bn, bk in itertools.product(mn_sizes, mn_sizes, k_sizes):
        bm_, bn_, bk_ = (min(bm, _round_up(m, 16)), min(bn, _round_up(n, 16)),
                         min(bk, _round_up(k, 16)))
        m_t, n_t, k_t = _ceil_div(m, bm_), _ceil_div(n, bn_), _ceil_div(k, bk_)
        for order in _ORDERS:
            smem = matmul_smem_bytes(bm_, bn_, bk_, dtype_bytes,
                                     rmw=order[2] != "k")
            if smem > budget:
                continue
            hbm = _gemm_bytes(m_t, n_t, k_t, bm_, bn_, bk_, m, n, k,
                              order, dtype_bytes, 4)
            share = min(1.0, gemm_grid_blocks(
                order, {"m": m_t, "n": n_t, "k": k_t}) / chip.n_sms)
            t_mem = hbm / chip.hbm_bw / share
            t_cmp = flops / chip.peak_flops / share
            cands.append(Plan(
                kind="matmul", tiles={"bm": bm_, "bn": bn_, "bk": bk_},
                order=order, steps=m_t * n_t * k_t, hbm_bytes=hbm,
                flops=flops, smem_bytes=smem,
                duration_additive=t_mem + t_cmp,
                duration_overlapped=max(t_mem, t_cmp)))
    if not cands:
        raise ValueError("no tile fits one block's shared memory")
    return min(cands, key=lambda p: (p.duration_overlapped,
                                     p.duration_additive, p.steps))


# --------------------------------------------------------------------- #
# Decode attention: S1 with roles swapped — Q is the resident "kernel set",
# KV blocks are the patches (disjoint, stride == block -> no halo).
# --------------------------------------------------------------------- #

def plan_decode_attention(seq_len: int, head_dim: int, q_rows: int,
                          dtype_bytes: int = 2,
                          chip: GpuChipModel = H100_SXM) -> Plan:
    """Choose the KV block ``bkv`` of the decode kernel for one (batch,
    KV head): multiples of 16 whose block fits one block's shared memory.
    ``ops.decode_attention`` pads the cache to a multiple of ``bkv``, and
    the padded rows are priced, so a block that divides ``seq_len`` wins
    over one that pads; among equals, fewer steps win (fewer t_acc terms
    in the paper's units)."""
    budget = chip.smem_bytes_per_block
    flops = 4 * q_rows * seq_len * head_dim      # QK^T + PV
    best: Plan | None = None
    for bkv in range(16, _round_up(seq_len, 16) + 1, 16):
        smem = decode_smem_bytes(q_rows, head_dim, bkv, dtype_bytes)
        if smem > budget:
            break
        padded = _round_up(seq_len, bkv)
        steps = padded // bkv
        hbm = 2 * padded * head_dim * dtype_bytes \
            + 2 * q_rows * head_dim * dtype_bytes
        t_mem = hbm / chip.hbm_bw
        t_cmp = flops / chip.peak_flops
        cand = Plan(kind="decode_attention", tiles={"bkv": bkv},
                    order="kv", steps=steps, hbm_bytes=hbm, flops=flops,
                    smem_bytes=smem,
                    duration_additive=t_mem + t_cmp,
                    duration_overlapped=max(t_mem, t_cmp))
        if best is None or (cand.duration_overlapped, cand.steps) < \
                (best.duration_overlapped, best.steps):
            best = cand
    if best is None:
        raise ValueError("no KV block fits one block's shared memory")
    return best


def plan_decode_split(seq_len: int, head_dim: int, q_rows: int,
                      heads: int, dtype_bytes: int = 2,
                      chip: GpuChipModel = H100_SXM) -> Plan:
    """Choose how many blocks share one (batch, KV head)'s cache, and the
    KV block ``bkv`` they stream, for the decode split kernel and its
    combine; ``heads`` is batch x KV heads, and each takes
    ``groups = ceil(G / 8)`` blocks per range (one per 8 query rows, each
    reading the range).

    Candidates are ``splits`` of 1, 2, 4, ... while a range keeps at
    least 16 rows and the grid (``heads * groups * splits`` blocks) at
    most twice the SMs.  Each split takes
    ``range = round_up(ceil(S / splits), 16)`` rows, walked as
    :func:`plan_decode_attention` plans a walk of that length (its
    ``bkv`` divides the range).  The duration is the paper's, with the
    grid's share of the card as :func:`plan_matmul` prices it: bytes are
    the padded cache once per group, one q load per split, the output
    once, and,
    with more than one split, the f32 partials ``(G, D + 2)`` per split
    written and read back by the combine; both terms are divided by
    ``min(1, heads * groups * splits / n_sms)``.  Among equal durations, fewer
    splits, then fewer steps, win.  ``tiles`` holds ``bkv`` and
    ``splits``; ``ops.decode_attention`` pads the cache to a multiple of
    ``splits * bkv``."""
    s16 = _round_up(seq_len, 16)
    blocks = heads * _ceil_div(q_rows, DECODE_MAX_G)   # per range
    best: Plan | None = None
    splits = 1
    while splits == 1 or (splits * 16 <= s16 and splits <= DECODE_MAX_SPLITS
                          and blocks * splits <= 2 * chip.n_sms):
        rng = _round_up(_ceil_div(seq_len, splits), 16)
        walk = plan_decode_attention(rng, head_dim, q_rows, dtype_bytes,
                                     chip)
        padded = rng * splits
        q_bytes = q_rows * head_dim * dtype_bytes
        partials = 2 * splits * q_rows * (head_dim + 2) * 4 \
            if splits > 1 else 0
        hbm = 2 * blocks * padded * head_dim * dtype_bytes \
            + heads * ((splits + 1) * q_bytes + partials)
        flops = heads * 4 * q_rows * padded * head_dim
        share = min(1.0, blocks * splits / chip.n_sms)
        t_mem = hbm / chip.hbm_bw / share
        t_cmp = flops / chip.peak_flops / share
        cand = Plan(kind="decode_attention",
                    tiles={"bkv": walk.tiles["bkv"], "splits": splits},
                    order="kv", steps=walk.steps, hbm_bytes=hbm,
                    flops=flops, smem_bytes=walk.smem_bytes,
                    duration_additive=t_mem + t_cmp,
                    duration_overlapped=max(t_mem, t_cmp))
        if best is None or (cand.duration_overlapped, cand.steps) < \
                (best.duration_overlapped, best.steps):
            best = cand
        splits *= 2
    return best


def plan_conv(spec: ConvSpec, dtype_bytes: int = 2,
              chip: GpuChipModel = H100_SXM,
              max_run: int = 64) -> Plan:
    """Pick the row-run length T for the simple conv kernel behind
    ``ops.conv2d``: each grid step computes a (1 x T) run of output
    columns for all C_out channels.  Cost = paper eq. 15 with halo-aware
    I_slice, evaluated exactly via the strategy bitmasks; feasibility =
    the kernel's own shared-memory allocation against one block's limit
    on the card."""
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
        t_cmp = flops / chip.peak_flops
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
