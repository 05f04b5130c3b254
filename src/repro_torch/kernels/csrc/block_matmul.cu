// Block GeMM C = A @ B under a planned tiling (bm, bn, bk) and loop order.
//
// Replaces the Pallas TPU kernel `block_matmul` of
// src/repro/kernels/block_matmul.py with its two bodies: `_mm_kernel_osta`
// (k innermost, output-stationary; here K3) and `_mm_kernel_rmw` (k not
// innermost, partial C read-modified-written through an f32 buffer; here
// K4).  It is what `ops.matmul` launches.
//
// Mapping.  On the TPU the grid runs the order's three loops in order on
// one core, and an operand whose block index does not change between two
// consecutive steps stays in VMEM (the formalism's I_slice; `_gemm_bytes`
// in core.planner prices exactly that).  CUDA blocks run in no order, so
// the order is honoured like this: the loops OUTSIDE k go on the grid (two
// blocks then never hold partial sums of one C tile at once), and a block
// walks the rest, k included, in the order's sequence.  When k is the
// outermost loop, the wrapper makes one launch per k tile, with the middle
// loop on the grid: successive partial sums of a C tile then come from
// successive launches on one stream.  Inside a block an A or B tile is
// fetched into shared memory only when its index differs from the one the
// block holds, so a block's fetches are the sequential sweep's.
//
//   order mnk / nmk (K3): grid (m, n) tiles; the block sums its k tiles
//     into an f32 accumulator in registers and casts once at the last k.
//     The grid's blocks take their tiles in groups of MM_K3_RASTER_ROWS
//     tile rows, column by column (`k3_tile`), so that the blocks that
//     run at once share their A and B panels in L2.
//   order mkn / nkm (K4): grid over the outer loop; the block walks k, then
//     the inner loop, with the A (resp. B) tile resident across it; each
//     C tile's partial goes to the f32 buffer and comes back at the next
//     k, and the last k writes it cast to C's type.
//   order kmn / knm (K4): one launch per k tile, grid over the middle loop,
//     the block walks the inner loop with its A (resp. B) tile resident.
//
// K4's cluster.  K4's grid is one loop (15 blocks for `mkn` at m = 1920),
// so its innermost loop is split over a thread-block cluster of `cs`
// blocks (at most 8, the portable size): rank r walks inner tiles r,
// r + cs, ... in order.  Rank 0 alone fetches the resident tile from
// device memory; the peers get it from rank 0's shared memory
// (distributed shared memory).  Each A and B tile is thus read from device
// memory as often as in the sequential sweep, and each C tile still
// belongs to one block.
//
// K3's cluster.  On the wgmma core K3 runs in clusters of cm x cn blocks
// (1 or 2 a side), one C tile each: the ranks on one tile row share each
// A tile, those on one tile column each B tile.  Every sharer's producer
// fetches its g-th of each box's rows by TMA `.multicast::cluster` into
// the same slot of all g sharers, so L2 serves a shared tile once.
//
// Each step's tile product is formed from zero in f32 over bk and then
// added to the running C value in the order of k, the same in both
// bodies and on every core, so every order and every cluster size gives
// the same result, bit for bit, and C is rounded once.
//
// What bounds it on an H100: operations, for the large products the
// planner sizes (TinyLlama's prefill projections do 2*m*n*k = 16-44 GFLOP
// on 12-46 MB: 0.109 ms at 989 TFLOP/s); the operands' trips from L2 to
// the SMs (at 128x256 tiles 85 FLOP a byte landed, against the 10.6 TB/s
// that tools/l2_probe.py measured landing in shared memory); and for K4
// its f32 partials, which cross the memory system at every k step.  K3's
// step, which forms each product from zero and then adds it (the bits
// every order shares), leaves the tensor cores idle while both consumer
// warpgroups wait for their tiles and add.
// Three cores, by one rule (`mm_core`; `core_of` in kernels/block_matmul.py):
//   * wgmma, bf16 tiles with bm % 64 == 0 and bn up to 256 (the planner's
//     128x256x128 and 64x64x256 prefill tiles): bm / 64 consumer
//     warpgroups, each `wgmma.mma_async` m64nBNk16 (K3 at bn 256 in two
//     products of 128 columns) from shared memory through matrix
//     descriptors (A K-major, B (k, n) row-major read MN-major), and one
//     producer warp.  The producer walks the block's steps ahead of the
//     consumers and fetches each new A and B tile by TMA (tensor maps
//     built on the host for each launch, swizzled 128/64/32 bytes to
//     match the descriptors) into its operand's ring of slots, each with
//     a full `mbarrier` (expect-tx bytes) and an empty one (one arrival
//     per consumer warpgroup of every sharer), as deep as shared memory
//     allows (2-4 slots).  In a K4 cluster rank 0's producer fetches the
//     resident tile and pushes it into each peer's slot with a bulk
//     shared::cta ->
//     shared::cluster copy that completes on the peer's full barrier; the
//     peers say their slot is free on rank 0's `ready` barrier, and that
//     the copy landed on rank 0's empty one.  K4's
//     partials stay off the product's path: each consumer warp brings the
//     next step's partial C tile into its own part of a shared-memory
//     stage by `cp.async` while this step's product runs, and writes the
//     finished partial to the buffer with plain stores it never waits on;
//   * mma.sync, the other bf16 tiles (16-80 rows): 8 warps, each owning
//     up to 4 x 4 `mma.sync.m16n8k16` fragments, operands by `ldmatrix`,
//     tiles by 16-byte `cp.async` into a two-stage ring of rows padded by
//     16 bytes;
//   * fma, float32 on the f32 units (16x16 threads, each up to 8 rows x 4
//     column pairs), the same two-stage ring: TF32 would not hold f32's
//     tolerance.
// Tiles are multiples of 16, bm at most 128, bn at most 128 (256 on
// wgmma).  Multicast of K4's resident tile over its cluster is later work.
#include "repro_common.cuh"
#include "wgmma_bf16.cuh"

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>          // CUtensorMap (types only: no -lcuda)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled

namespace cg = cooperative_groups;

#define MM_MAX_TILE 128   // bm, bn: 8 warps x 64x32 fragments / 16 x 8 values
#define MM_WG_MAX_BN 256  // the wgmma core's bn: m64n256k16
#define MM_THREADS 256
#define MM_MAX_CLUSTER 8  // the portable cluster size
#define MM_K3_MAX_CLUSTER_SIDE 2   // K3's cluster: 1 or 2 ranks along m, n
#define MM_K3_RASTER_ROWS 16       // K3's raster: tile rows of a group
// wgmma core: at most two consumer warpgroups and one producer warp (a
// producer warpgroup for K3 tiles wider than 128, which move registers to
// the consumers with setmaxnreg); a ring of 2-4 slots; 1024 bytes to align
// shared memory to the 128-byte swizzle's period, and 256 for the ring's
// mbarriers
#define MM_WG_MAX_THREADS (2 * 128 + 32)
#define MM_WG_WIDE_THREADS (3 * 128)
#define MM_WG_PRODUCER_REGS 40
#define MM_WG_CONSUMER_REGS 232
#define MM_WG_MAX_STAGES 4
#define MM_WG_FIXED_BYTES (1024 + 256)

// Phase markers of the wgmma consumer's step (empty unless a probe
// defines them): MM_PHASE(0) starts the clock, MM_PHASE(k) closes phase k.
#ifndef MM_PHASE
#define MM_PHASE(k)
#endif

// The cores and the rule that picks one: wgmma for bf16 tiles of whole
// warpgroups of rows, mma.sync for the other bf16 tiles, fma for f32.
// `core_of` in kernels/block_matmul.py is the same rule.
enum MmCore { CORE_FMA = 0, CORE_MMA_SYNC = 1, CORE_WGMMA = 2 };

inline int mm_core(int bm, int dtype_bytes) {
  return dtype_bytes == 4 ? CORE_FMA
                          : bm % 64 == 0 ? CORE_WGMMA : CORE_MMA_SYNC;
}

// The wgmma core's rings: as many slots of one A and one B tile as fit
// beside K4's (rmw) partial C stage, from 2 up to MM_WG_MAX_STAGES.
inline int wg_stages(int bm, int bn, int bk, bool rmw) {
  const long long stage = 2LL * (1LL * bm * bk + 1LL * bk * bn);
  const long long c = rmw ? 4LL * bm * bn : 0;
  const long long s = (REPRO_SMEM_LIMIT_BYTES - MM_WG_FIXED_BYTES - c) / stage;
  return s < 2 ? 2 : s > MM_WG_MAX_STAGES ? MM_WG_MAX_STAGES
                                          : static_cast<int>(s);
}

// Shared memory one block of K3 or, with rmw, K4 allocates, by core
// (`matmul_smem_bytes` in core/planner.py is the same formula).  wgmma:
// the rings' slots of unpadded (swizzled) A and B tiles, K4's f32 partial
// C stage, the mbarriers and the alignment slack.  mma.sync and fma: two
// stages of the A tile and of the B tile, each row padded by 16 bytes.
inline long long mm_smem_bytes(int bm, int bn, int bk, int dtype_bytes,
                               bool rmw) {
  if (mm_core(bm, dtype_bytes) == CORE_WGMMA)
    return MM_WG_FIXED_BYTES
           + 2LL * wg_stages(bm, bn, bk, rmw) * (1LL * bm * bk + 1LL * bk * bn)
           + (rmw ? 4LL * bm * bn : 0);
  const int pad = 16 / dtype_bytes;
  return 2LL * (1LL * bm * (bk + pad) + 1LL * bk * (bn + pad)) * dtype_bytes;
}

namespace {

struct MmArgs {
  int m, n, k, bm, bn, bk;
  int m_t, n_t, k_t;
  int order[3];   // loop dims outer -> inner: 0 = m, 1 = n, 2 = k
  int axis_m;     // blockIdx axis of the m loop: 0 = x, 1 = y, -1 = walked
  int axis_n;     // the same for n (k is never on the grid)
  int k_lo, k_cnt;
  int cs;         // K4: blocks of a cluster (along x) splitting the inner loop
  int cm, cn;     // K3: ranks of a cluster along m and along n
  int group;      // K3: tile rows (the grid's y loop) of a raster group
  int stages;     // wgmma core: slots of the A and of the B ring
};

// K3's cluster extent along the grid's x and y axes
__host__ __device__ inline int k3_cx(const MmArgs& p) {
  return p.axis_n == 0 ? p.cn : p.cm;
}
__host__ __device__ inline int k3_cy(const MmArgs& p) {
  return p.axis_n == 0 ? p.cm : p.cn;
}

// ------------------------------------------------------------------ PTX

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory at address `dst`
__device__ inline void cp_async16_to(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(dst), "l"(src) : "memory");
}

__device__ inline void cp_async16(void* dst, const void* src) {
  cp_async16_to(smem_addr(dst), src);
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ inline void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ inline void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 "
               "{%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}

// d = a (16x16, row) * b (16x8, col) + d, bf16 inputs, f32 sums
__device__ inline void mma_bf16(float* d, const uint32_t* a,
                                const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ inline void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ inline void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// ------------------------------------------------------- tile products
//
// A core holds the block's share of one C tile: `part`, this step's
// product (formed from zero), and `acc`, the running C value (K3 keeps it
// across steps; K4 reads it from its f32 buffer each step).  `each`
// visits every (row, col) pair of adjacent columns the thread owns.

template <typename T> struct Core;

// bfloat16: 8 warps over the (bm/16) x (bn/8) mma fragments of the tile,
// in a 2 x 4 grid of warps (1 x 8 when bm = 16); a warp owns the next
// mf x nf fragments (mf, nf <= 4), fewer at the tile's edge, where an odd
// bm/16 or bn/8 leaves the last warp row or column short.  Warps past the
// tile's last fragment idle.
template <> struct Core<__nv_bfloat16> {
  static constexpr int MF = 4, NF = 4;
  float part[MF][NF][4];
  float acc[MF][NF][4];
  int row0, col0, mf, nf;

  __device__ void setup(int bm, int bn) {
    const int warp = threadIdx.x >> 5;
    const int frags_m = bm >> 4, frags_n = bn >> 3;
    const int warps_m = frags_m >= 2 ? 2 : 1;
    const int warps_n = (MM_THREADS / 32) / warps_m;
    const int per_m = (frags_m + warps_m - 1) / warps_m;
    const int per_n = (frags_n + warps_n - 1) / warps_n;
    const int first_m = (warp / warps_n) * per_m;
    const int first_n = (warp % warps_n) * per_n;
    mf = max(0, min(per_m, frags_m - first_m));
    nf = max(0, min(per_n, frags_n - first_n));
    row0 = first_m * 16;
    col0 = first_n * 8;
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  __device__ void product(const __nv_bfloat16* a_s, int lda,
                          const __nv_bfloat16* b_s, int ldb, int bk) {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
    if (mf == 0 || nf == 0) return;
    const int lane = threadIdx.x & 31;
    for (int q = 0; q < bk; q += 16) {
      uint32_t af[MF][4], bf[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        if (i < mf)   // rows lane % 16, k columns 8 * (lane / 16)
          ldmatrix_x4(af[i], a_s + (row0 + i * 16 + (lane & 15)) * lda + q
                                 + ((lane >> 4) << 3));
#pragma unroll
      for (int j = 0; j < NF; ++j)
        if (j < nf)   // k rows lane % 16 of 8 columns, transposed
          ldmatrix_x2_trans(bf[j], b_s + (q + (lane & 15)) * ldb + col0
                                       + j * 8);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
          if (i < mf && j < nf) mma_bf16(part[i][j], af[i], bf[j]);
    }
  }

  template <typename F> __device__ void each(F f) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (i < mf && j < nf)
            f(row0 + i * 16 + (lane >> 2) + 8 * h,
              col0 + j * 8 + 2 * (lane & 3), part[i][j][2 * h],
              part[i][j][2 * h + 1], acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  }
};

// float32: 16x16 threads; thread (ty, tx) owns rows ty + 16 i (i < 8) and
// the column pairs 2 tx + 32 j (j < 4), summed with fmaf in q order.
template <> struct Core<float> {
  static constexpr int R = 8, C = 4;
  float part[R][2 * C];
  float acc[R][2 * C];
  int ty, tx, bm, bn;

  __device__ void setup(int bm_, int bn_) {
    ty = threadIdx.x / 16;
    tx = threadIdx.x % 16;
    bm = bm_;
    bn = bn_;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 2 * C; ++j) acc[i][j] = 0.0f;
  }

  __device__ void product(const float* a_s, int lda, const float* b_s,
                          int ldb, int bk) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 2 * C; ++j) part[i][j] = 0.0f;
    for (int q = 0; q < bk; ++q) {
      float af[R];
      float2 bf[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
        af[i] = r < bm ? a_s[r * lda + q] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int col = 2 * tx + 32 * j;
        bf[j] = col < bn
            ? *reinterpret_cast<const float2*>(b_s + q * ldb + col)
            : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          part[i][2 * j] = fmaf(af[i], bf[j].x, part[i][2 * j]);
          part[i][2 * j + 1] = fmaf(af[i], bf[j].y, part[i][2 * j + 1]);
        }
    }
  }

  template <typename F> __device__ void each(F f) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int r = ty + 16 * i, col = 2 * tx + 32 * j;
        if (r < bm && col < bn)
          f(r, col, part[i][2 * j], part[i][2 * j + 1], acc[i][2 * j],
            acc[i][2 * j + 1]);
      }
  }
};

// ------------------------------------------------------------- fetches

// rows x cols of a row-major array (row stride ld_src) into shared memory
// (row stride ld_dst) by 16-byte cp.async copies, neighbouring threads on
// neighbouring addresses.  cols * sizeof(T) is a multiple of 16.
template <typename T>
__device__ void fetch_tile(T* dst, int ld_dst, const T* src, long long ld_src,
                           int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = cols / V;
  for (int e = threadIdx.x; e < rows * per_row; e += MM_THREADS) {
    const int r = e / per_row;
    const int col = (e - r * per_row) * V;
    cp_async16(dst + r * ld_dst + col, src + r * ld_src + col);
  }
}

// The same elements of rank 0's shared memory into this block's, through
// distributed shared memory.
template <typename T>
__device__ void copy_from_rank0(T* own, int elems) {
  const int4* src = reinterpret_cast<const int4*>(
      cg::this_cluster().map_shared_rank(own, 0));
  int4* dst = reinterpret_cast<int4*>(own);
  const int chunks = static_cast<int>(elems * sizeof(T) / 16);
  for (int e = threadIdx.x; e < chunks; e += MM_THREADS) dst[e] = src[e];
}

// The block's loops by position (outer -> inner): which dim, first tile,
// trip count and stride; the inner loop is strided over a cluster.
struct Walk {
  int dim[3], lo[3], cnt[3], str[3];

  __device__ void step(int s, int& mm, int& nn, int& kk) const {
    const int i2 = s % cnt[2];
    const int r = s / cnt[2];
    const int i1 = r % cnt[1];
    const int i0 = r / cnt[1];
    const int t0 = lo[0] + i0 * str[0];
    const int t1 = lo[1] + i1 * str[1];
    const int t2 = lo[2] + i2 * str[2];
    mm = dim[0] == 0 ? t0 : dim[1] == 0 ? t1 : t2;
    nn = dim[0] == 1 ? t0 : dim[1] == 1 ? t1 : t2;
    kk = dim[0] == 2 ? t0 : dim[1] == 2 ? t1 : t2;
  }

  __device__ int total() const { return cnt[0] * cnt[1] * cnt[2]; }
};

// K3's tile (x, y indices of the grid's loops) at this block.  The
// grid's clusters of cx x cy blocks are taken in launch order (x fastest)
// and laid over the tile grid group by group, each group `group` tile rows
// of the y loop walked column by column, so that the blocks that run at
// once share their A and B panels in L2; a cluster's ranks keep their
// offsets.  `k3_raster` in core/planner.py is the same map.
__device__ void k3_tile(const MmArgs& p, int& tx, int& ty) {
  const int cx = k3_cx(p), cy = k3_cy(p);
  const int ncx = gridDim.x / cx, ncy = gridDim.y / cy;
  const int gy = p.group / cy;   // cluster rows of a group
  const int lin = (blockIdx.y / cy) * ncx + blockIdx.x / cx;
  const int first = lin / (gy * ncx) * gy;
  const int rows = min(gy, ncy - first);
  const int within = lin - first * ncx;
  ty = (first + within % rows) * cy + blockIdx.y % cy;
  tx = (within / rows) * cx + blockIdx.x % cx;
}

// The walk of the block at this blockIdx and cluster rank.
__device__ Walk make_walk(const MmArgs& p, int rank) {
  Walk w;
  int tx = blockIdx.x / p.cs, ty = blockIdx.y;
  if (p.order[2] == 2) k3_tile(p, tx, ty);
  for (int i = 0; i < 3; ++i) {
    const int d = p.order[i];
    const int axis = d == 0 ? p.axis_m : d == 1 ? p.axis_n : -1;
    const int trips = d == 0 ? p.m_t : p.n_t;
    w.dim[i] = d;
    w.str[i] = 1;
    if (d == 2) {
      w.lo[i] = p.k_lo;
      w.cnt[i] = p.k_cnt;
    } else if (axis >= 0) {
      w.lo[i] = axis == 0 ? tx : ty;
      w.cnt[i] = 1;
    } else if (i == 2 && p.cs > 1) {   // rank r: inner tiles r, r + cs, ...
      w.lo[i] = rank;
      w.str[i] = p.cs;
      w.cnt[i] = (trips - rank + p.cs - 1) / p.cs;
    } else {
      w.lo[i] = 0;
      w.cnt[i] = trips;
    }
  }
  return w;
}

// The block's walk over its (mm, nn, kk) steps, in the order's sequence.
// RMW = false: K3, one C tile per block, accumulator in registers.
// RMW = true: K4, partials through `buf` (f32; may alias `c` when C is f32).
template <typename T, bool RMW>
__device__ void walk(const T* __restrict__ a, const T* __restrict__ b,
                     T* c, float* buf, const MmArgs& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int PAD = 16 / sizeof(T);   // 16 bytes a row, against conflicts
  const int lda = p.bk + PAD, ldb = p.bn + PAD;
  const int a_elems = p.bm * lda, b_elems = p.bk * ldb;
  T* const a_st = reinterpret_cast<T*>(smem_raw);   // two stages each
  T* const b_st = a_st + 2 * a_elems;

  // the resident operand of a clustered K4: A when n is innermost, B when m
  const bool clu = p.cs > 1;
  const bool res_a = clu && p.order[2] == 1;
  const bool res_b = clu && p.order[2] == 0;
  const int rank = clu ? static_cast<int>(cg::this_cluster().block_rank()) : 0;

  const Walk w = make_walk(p, rank);
  const int total = w.total();

  Core<T> core;
  core.setup(p.bm, p.bn);

  auto fetch_a = [&](T* dst, int mm, int kk) {   // a4: the A tile (mm, kk)
    fetch_tile(dst, lda, a + static_cast<long long>(mm) * p.bm * p.k
                             + kk * p.bk, p.k, p.bm, p.bk);
  };
  auto fetch_b = [&](T* dst, int kk, int nn) {   // a4: the B tile (kk, nn)
    fetch_tile(dst, ldb, b + static_cast<long long>(kk) * p.bk * p.n
                             + nn * p.bn, p.n, p.bk, p.bn);
  };

  int mm, nn, kk;
  w.step(0, mm, nn, kk);
  bool new_a = true, new_b = true;
  int sa = 0, sb = 0;   // the stage holding this step's A / B tile
  if (!res_a) fetch_a(a_st, mm, kk);
  if (!res_b) fetch_b(b_st, kk, nn);
  cp_async_commit();

  for (int s = 0; s < total; ++s) {
    if ((res_a && new_a) || (res_b && new_b)) {
      // every block of the cluster runs, and the peers are done with the
      // previous resident tile: rank 0 may overwrite it
      cg::this_cluster().sync();
      if (rank == 0) {
        if (res_a) fetch_a(a_st, mm, kk);
        else fetch_b(b_st, kk, nn);
        cp_async_commit();
      }
      cp_async_wait_all();
      cg::this_cluster().sync();   // rank 0's tile is visible to the peers
      if (rank != 0) {
        if (res_a) copy_from_rank0(a_st, a_elems);
        else copy_from_rank0(b_st, b_elems);
      }
    }
    cp_async_wait_all();
    __syncthreads();   // this step's tiles are in; last step's readers done

    // issue the next step's new tiles into the other stages
    int mm2 = mm, nn2 = nn, kk2 = kk;
    bool new_a2 = false, new_b2 = false;
    if (s + 1 < total) {
      w.step(s + 1, mm2, nn2, kk2);
      new_a2 = mm2 != mm || kk2 != kk;
      new_b2 = kk2 != kk || nn2 != nn;
      if (new_a2 && !res_a) fetch_a(a_st + (sa ^ 1) * a_elems, mm2, kk2);
      if (new_b2 && !res_b) fetch_b(b_st + (sb ^ 1) * b_elems, kk2, nn2);
      cp_async_commit();
    }

    const bool last_k = kk == p.k_t - 1;
    const bool first_k = kk == 0;
    const long long base = static_cast<long long>(mm) * p.bm * p.n
                           + static_cast<long long>(nn) * p.bn;
    // K4: the running C value comes from the f32 buffer into `acc`, read
    // before the product so that the reads overlap it
    if (RMW && !first_k)
      core.each([&](int r, int col, float&, float&, float& a0, float& a1) {
        const float2 old = *reinterpret_cast<const float2*>(
            buf + base + static_cast<long long>(r) * p.n + col);
        a0 = old.x;
        a1 = old.y;
      });

    // a6: this step's tile product, formed from zero in f32 over bk
    core.product(a_st + sa * a_elems, lda, b_st + sb * b_elems, ldb, p.bk);

    // a3: add to the running C value in k order; cast once at the end
    core.each([&](int r, int col, float& p0, float& p1, float& a0,
                  float& a1) {
      const long long at = base + static_cast<long long>(r) * p.n + col;
      a0 = first_k ? p0 : a0 + p0;
      a1 = first_k ? p1 : a1 + p1;
      if (last_k) store2(c + at, a0, a1);
      else if (RMW) store2(buf + at, a0, a1);
    });

    if (new_a2 && !res_a) sa ^= 1;
    if (new_b2 && !res_b) sb ^= 1;
    mm = mm2;
    nn = nn2;
    kk = kk2;
    new_a = new_a2;
    new_b = new_b2;
  }
  // no block leaves while a peer may still read its shared memory
  if (clu) cg::this_cluster().sync();
}

// ----------------------------------------------------------- wgmma core
//
// PTX of the asynchronous proxy: mbarriers, TMA, bulk copies into a
// peer's shared memory, wgmma's fences.

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count) : "memory");
}

// arrive, and expect `bytes` of asynchronous copies in this phase
__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(bar) : "memory");
}

// the same shared-memory location in the block of cluster rank `rank`
__device__ inline uint32_t cluster_addr(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// arrive on the mbarrier `bar` of cluster rank `rank`
__device__ inline void mbar_arrive_at(uint32_t bar, int rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      ::"r"(cluster_addr(bar, rank)) : "memory");
}

// arrive on the mbarrier `bar` of cluster rank `rank` with the default
// (release, CTA-scope) semantics: what K3's consumers say when a slot that
// a sharer multicast into is free, the wgmma reads of it retired
__device__ inline void mbar_arrive_remote(uint32_t bar, int rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
               ::"r"(cluster_addr(bar, rank)) : "memory");
}

// wait until the phase of parity `parity` has completed (CTA scope: the
// bytes the phase counted, and the arrivals, are what is waited for)
__device__ inline void mbar_wait_cta(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// wait until the phase of parity `parity` has completed, acquiring what
// the cluster's threads released into it
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// every thread of every block of the cluster
__device__ inline void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ inline int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// the box of a 2-d tensor map at element (inner, outer) into shared memory
__device__ inline void tma_load(uint32_t dst, const CUtensorMap* map,
                                uint32_t bar, int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
        "r"(inner), "r"(outer) : "memory");
}

// the same box into the shared memory of every cluster rank whose bit is
// set in `mask`, at the same address, completing on each rank's mbarrier
// at the same address as `bar`; L2 serves it once
__device__ inline void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int inner, int outer,
                                          uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], "
      "%5;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
        "r"(inner), "r"(outer), "h"(mask) : "memory");
}

// `bytes` of this block's shared memory at `src` to the same address in
// cluster rank `rank`, completing on that block's mbarrier `bar`
__device__ inline void push_to_rank(uint32_t src, uint32_t bytes,
                                    uint32_t bar, int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n"
      ::"r"(cluster_addr(src, rank)), "r"(src), "r"(bytes),
        "r"(cluster_addr(bar, rank)) : "memory");
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous product
template <int N>
__device__ inline void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Elements of one swizzled row of a tile: 64 (128 bytes), 32 (64) or 16
// (32) bf16, the widest that divides the tile's contiguous extent.
__host__ __device__ inline int atom_width(int extent) {
  return extent % 64 == 0 ? 64 : extent % 32 == 0 ? 32 : 16;
}

// A wgmma matrix descriptor: start address, leading and stride byte
// offsets, and the swizzle of rows of `w` bf16 (1 = 128 bytes, 2 = 64,
// 3 = 32).
__device__ inline uint64_t mat_desc(uint32_t addr, uint32_t lbo,
                                    uint32_t sbo, int w) {
  const uint64_t layout = w == 64 ? 1 : w == 32 ? 2 : 3;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// One operand's ring in shared memory: `stages` slots of one tile, and
// per slot a full, an empty and (K4's cluster) a ready mbarrier.  Tile i
// of the operand's sequence takes slot i % stages in phase (i / stages).
struct Ring {
  uint32_t slots, slot_bytes, bars;
  int stages;
  __device__ uint32_t slot(int i) const {
    return slots + (i % stages) * slot_bytes;
  }
  __device__ uint32_t full(int i) const { return bars + 8u * (i % stages); }
  __device__ uint32_t empty(int i) const {
    return bars + 8u * (stages + i % stages);
  }
  __device__ uint32_t ready(int i) const {
    return bars + 8u * (2 * stages + i % stages);
  }
  __device__ uint32_t phase(int i) const { return (i / stages) & 1; }
};

// The ranks of a K3 cluster that share one operand's tile: those on one
// line of the cluster along x (`along_x`) or along y through this block
// (at ix, iy of a cx-wide cluster); this block is number `idx` of the `g`.
struct Share {
  int g, idx, first, stride;
  __device__ int rank(int q) const { return first + q * stride; }
  __device__ uint16_t mask() const {
    uint32_t m = 0;
    for (int q = 0; q < g; ++q) m |= 1u << rank(q);
    return static_cast<uint16_t>(m);
  }
};

__device__ inline Share share_along(bool along_x, int ix, int iy, int cx,
                                    int cy) {
  return along_x ? Share{cx, ix, iy * cx, 1} : Share{cy, iy, ix, cx};
}

// A block of the wgmma core: consumer warpgroup g (threads 128 g ..) owns
// rows 64 g .. 64 g + 63 of the C tile; the last warp produces (for a K3
// tile wider than 128, the last warpgroup, which hands registers to the
// consumers).
//
// Shared memory, from a 1024-byte boundary: the A ring (slots of bk / wa
// boxes, each bm rows of wa bf16, swizzled), the B ring (slots of BN / wb
// column groups, each bk rows of wb bf16, swizzled, fetched in boxes of
// at most 256 rows), K4's partial C stage (bm x BN f32, each warp's part
// in the order its lanes read it), then the mbarriers.
//
// K3's cluster (cm x cn ranks, one C tile each): the ranks on one tile row
// share each A tile and the ranks on one tile column each B tile.  Every
// sharer's producer fetches its g-th of each box's rows with
// `.multicast::cluster` into the same slot of every sharer, completing on
// each sharer's `full`, which expects the whole slot; a slot's `empty`
// takes one arrival from every consumer warpgroup of every sharer before
// its producer refills it.  K3's barriers are CTA-scoped (what the TMA
// bytes and the arrivals complete is what is waited for), K4's acquire
// and release at cluster scope.
template <int BN, bool RMW>
__device__ __forceinline__ void wg_walk(const CUtensorMap& tm_a,
                                        const CUtensorMap& tm_b,
                                        __nv_bfloat16* __restrict__ c,
                                        float* __restrict__ buf,
                                        const MmArgs& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int nwg = p.bm / 64;
  const int wa = atom_width(p.bk), wb = atom_width(BN);
  Ring ra, rb;
  ra.stages = rb.stages = p.stages;
  ra.slot_bytes = p.bm * p.bk * 2;
  rb.slot_bytes = p.bk * BN * 2;
  ra.slots = base;
  rb.slots = ra.slots + p.stages * ra.slot_bytes;
  const uint32_t c_stage = rb.slots + p.stages * rb.slot_bytes;
  ra.bars = c_stage + (RMW ? p.bm * BN * 4 : 0);
  rb.bars = ra.bars + 8u * 3 * p.stages;

  // the operand resident across a clustered K4's inner loop, which rank 0
  // alone fetches: A when n is innermost, B when m
  const bool clu = p.cs > 1;
  const int rank = cluster_rank();
  const bool res_a = clu && p.order[2] == 1;
  const bool res_b = clu && p.order[2] == 0;
  // K3's sharers of A (one m tile: along x when m is on y) and of B
  const int cx = k3_cx(p), cy = k3_cy(p);
  const int ix = blockIdx.x % cx, iy = blockIdx.y % cy;
  const Share sa = RMW ? Share{1, 0, rank, 1}
                       : share_along(p.axis_m == 1, ix, iy, cx, cy);
  const Share sb = RMW ? Share{1, 0, rank, 1}
                       : share_along(p.axis_n == 1, ix, iy, cx, cy);
  const Walk w = make_walk(p, rank);
  const int total = w.total();
  auto wait = [](uint32_t bar, uint32_t parity) {
    if constexpr (RMW) mbar_wait(bar, parity);
    else mbar_wait_cta(bar, parity);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(ra.full(i), 1);
      mbar_init(rb.full(i), 1);
      // each consumer warpgroup (of every K3 sharer) frees a slot; into
      // rank 0's resident slots each K4 peer also says that rank 0's copy
      // has landed
      mbar_init(ra.empty(i), nwg * sa.g + (res_a && rank == 0 ? p.cs - 1 : 0));
      mbar_init(rb.empty(i), nwg * sb.g + (res_b && rank == 0 ? p.cs - 1 : 0));
      mbar_init(ra.ready(i), clu ? p.cs - 1 : 1);
      mbar_init(rb.ready(i), clu ? p.cs - 1 : 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync_all();   // every block's barriers are set up
  if constexpr (!RMW && BN > 128) {
    if (threadIdx.x >= nwg * 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   ::"n"(MM_WG_PRODUCER_REGS));
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   ::"n"(MM_WG_CONSUMER_REGS));
  }

  if (threadIdx.x >= nwg * 128) {
    // ---- the producer: one thread walks the steps ahead of the consumers
    // and fetches each tile whose index changes (a4), as the plan does
    if (threadIdx.x == nwg * 128) {
      // tile i of ring r into its slot; `issue` starts the TMA boxes
      auto fetch = [&](const Ring& r, int i, bool resident, auto issue) {
        const uint32_t ph = r.phase(i);
        wait(r.empty(i), ph ^ 1);
        if (resident && rank != 0) {   // rank 0 pushes the tile here
          mbar_expect_tx(r.full(i), r.slot_bytes);
          mbar_arrive_at(r.ready(i), 0);
          return;
        }
        if (resident) mbar_wait(r.ready(i), ph);   // every peer's slot free
        mbar_expect_tx(r.full(i), r.slot_bytes);
        issue(r.slot(i), r.full(i));
        if (resident) {
          mbar_wait(r.full(i), ph);
          for (int q = 1; q < p.cs; ++q)
            push_to_rank(r.slot(i), r.slot_bytes, r.full(i), q);
        }
      };
      // this block's g-th of a box's `rows` rows at (inner, outer), into
      // `dst` of every sharer
      auto box = [&](const CUtensorMap* map, const Share& sh, uint32_t dst,
                     uint32_t bar, int inner, int outer, int rows, int w_) {
        const int sub = rows / sh.g;
        dst += sh.idx * sub * w_ * 2;
        outer += sh.idx * sub;
        if (sh.g == 1) tma_load(dst, map, bar, inner, outer);
        else tma_load_multicast(dst, map, bar, inner, outer, sh.mask());
      };
      int ia = -1, ib = -1, pm = -1, pn = -1, pk = -1;
      for (int s = 0; s < total; ++s) {
        int mm, nn, kk;
        w.step(s, mm, nn, kk);
        if (mm != pm || kk != pk)
          fetch(ra, ++ia, res_a, [&](uint32_t dst, uint32_t bar) {
            for (int j = 0; j < p.bk / wa; ++j)
              box(&tm_a, sa, dst + j * p.bm * wa * 2, bar, kk * p.bk + j * wa,
                  mm * p.bm, p.bm, wa);
          });
        if (kk != pk || nn != pn)
          fetch(rb, ++ib, res_b, [&](uint32_t dst, uint32_t bar) {
            const int rows = min(p.bk, 256);
            for (int jn = 0; jn < BN / wb; ++jn)
              for (int jk = 0; jk < p.bk / rows; ++jk)
                box(&tm_b, sb, dst + (jn * p.bk + jk * rows) * wb * 2, bar,
                    nn * BN + jn * wb, kk * p.bk + jk * rows, rows, wb);
          });
        pm = mm;
        pn = nn;
        pk = kk;
      }
    }
  } else {
    // ---- the consumers
    constexpr int NR = BN / 2;   // accumulators a thread holds
    // columns of one product: K3 multiplies a tile wider than 128 in
    // products of 128 columns, each formed from zero and added to `acc`
    // before the next, so that `d` and `acc` fit the registers
    constexpr int NP = RMW || BN <= 128 ? BN : 128;
    const int wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    float d[NP / 2];
    float acc[RMW ? 1 : NR];
    // thread's rows row0 and row0 + 8 of the tile, columns col0 + 8 j, + 1
    const int row0 = wg * 64 + wi * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);
    // K4: this warp's part of the partial C stage, 512 bytes for each 8
    // columns: the 16-byte pieces of rows lane / 4, then of rows + 8
    const uint32_t c_warp = c_stage + (wg * 4 + wi) * (BN / 8) * 512;
    const unsigned char* const c_warp_ptr = smem_raw + (c_warp - raw);
    // K4: the partial C tile (mm, nn) into the stage; lane l copies row
    // l / 4 (+ 8 for odd l), columns 8 j + 4 ((l % 4) / 2) .. + 3
    auto fetch_partial = [&](int mm, int nn) {
      const float* src = buf
          + static_cast<long long>(mm * p.bm + row0 + 8 * (lane & 1)) * p.n
          + nn * BN + 4 * ((lane % 4) / 2);
      const uint32_t dst = c_warp + (lane & 1) * 256 + (lane / 2) * 16;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) cp_async16_to(dst + j * 512, src + 8 * j);
      cp_async_commit();
    };
    // a slot is free: its empty barrier on every sharer (K3), or its own
    auto release = [&](uint32_t bar, const Share& sh) {
      if (sh.g == 1) mbar_arrive(bar);
      else
        for (int q = 0; q < sh.g; ++q) mbar_arrive_remote(bar, sh.rank(q));
    };

    int ia = -1, ib = -1, pm = -1, pn = -1, pk = -1;
    int mm, nn, kk;
    w.step(0, mm, nn, kk);
    if (RMW && kk > 0) fetch_partial(mm, nn);
    for (int s = 0; s < total; ++s) {
      MM_PHASE(0);
      if (mm != pm || kk != pk) {
        ++ia;
        wait(ra.full(ia), ra.phase(ia));
        if (res_a && rank != 0 && threadIdx.x == 0)
          mbar_arrive_at(ra.empty(ia), 0);   // rank 0's copy has landed
      }
      MM_PHASE(1);
      if (kk != pk || nn != pn) {
        ++ib;
        wait(rb.full(ib), rb.phase(ib));
        if (res_b && rank != 0 && threadIdx.x == 0)
          mbar_arrive_at(rb.empty(ib), 0);
      }
      const bool more = s + 1 < total;
      int mm2 = mm, nn2 = nn, kk2 = kk;
      if (more) w.step(s + 1, mm2, nn2, kk2);
      const bool first_k = kk == 0, last_k = kk == p.k_t - 1;
      // K3: product h into the running C value, in k order
      auto add = [&](int h) {
        if constexpr (!RMW) {
#pragma unroll
          for (int i = 0; i < NP / 2; ++i)
            acc[h * NP / 2 + i] = first_k ? d[i] : acc[h * NP / 2 + i] + d[i];
        }
      };
      MM_PHASE(2);

      // a6: this step's tile product, formed from zero in f32 over bk
      const uint32_t a_tile = ra.slot(ia) + wg * 64 * wa * 2;
      const uint32_t b_tile = rb.slot(ib);
#pragma unroll
      for (int h = 0; h < BN / NP; ++h) {
        if (h > 0) add(h - 1);
        fence_regs<NP / 2>(d);
        wgmma_fence();
        for (int q = 0; q < p.bk / 16; ++q) {
          const int ka = 16 * q;
          const uint64_t da = mat_desc(
              a_tile + (ka / wa) * p.bm * wa * 2 + (ka % wa) * 2, 16, 16 * wa,
              wa);
          const uint64_t db = mat_desc(b_tile + h * NP * p.bk * 2 + 32 * wb * q,
                                       p.bk * wb * 2, 16 * wb, wb);
          wgmma_bf16<NP>(d, da, db, q > 0);
        }
        wgmma_commit_wait();
        fence_regs<NP / 2>(d);
      }
      MM_PHASE(3);
      // a slot is free once the next step holds another tile
      if (threadIdx.x % 128 == 0) {
        if (!more || mm2 != mm || kk2 != kk) release(ra.empty(ia), sa);
        if (!more || kk2 != kk || nn2 != nn) release(rb.empty(ib), sb);
      }

      // a3: add to the running C value in k order; cast once at the end
      if constexpr (RMW) {
        if (!first_k) {   // the partial fetched one step ahead
          repro_cp_async_wait<0>();
          __syncwarp();
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float2 lo = *reinterpret_cast<const float2*>(
                c_warp_ptr + j * 512 + 8 * lane);
            const float2 hi = *reinterpret_cast<const float2*>(
                c_warp_ptr + j * 512 + 256 + 8 * lane);
            d[4 * j] = lo.x + d[4 * j];
            d[4 * j + 1] = lo.y + d[4 * j + 1];
            d[4 * j + 2] = hi.x + d[4 * j + 2];
            d[4 * j + 3] = hi.y + d[4 * j + 3];
          }
        }
      } else {
        add(BN / NP - 1);
      }
      MM_PHASE(4);
      const long long at = static_cast<long long>(mm * p.bm + row0) * p.n
                           + nn * BN + col0;
      const long long down = 8LL * p.n;   // row0 + 8
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float* v = RMW ? d : acc;
        if (last_k) {
          store2(c + at + 8 * j, v[4 * j], v[4 * j + 1]);
          store2(c + at + down + 8 * j, v[4 * j + 2], v[4 * j + 3]);
        } else if (RMW) {
          store2(buf + at + 8 * j, v[4 * j], v[4 * j + 1]);
          store2(buf + at + down + 8 * j, v[4 * j + 2], v[4 * j + 3]);
        }
      }
      // K4: the next step's partial comes in while its product runs; the
      // stores above are not waited on
      if (RMW && more && kk2 > 0) {
        __syncwarp();   // the warp's reads of the stage and stores are done
        fetch_partial(mm2, nn2);
      }
      MM_PHASE(5);
      pm = mm;
      pn = nn;
      pk = kk;
      mm = mm2;
      nn = nn2;
      kk = kk2;
    }
  }
  // no block leaves while a peer may still copy into or out of its
  // shared memory, or arrive on its barriers
  cluster_sync_all();
}

// Threads of a wgmma block: bm / 64 consumer warpgroups and a producer
// warp, or, for K3 tiles wider than 128, a producer warpgroup.
__host__ __device__ constexpr int wg_block_threads(int bm, int bn, bool rmw) {
  return bm / 64 * 128 + (!rmw && bn > 128 ? 128 : 32);
}

template <int BN>
__global__ void __launch_bounds__(BN > 128 ? MM_WG_WIDE_THREADS
                                           : MM_WG_MAX_THREADS, 1)
block_matmul_osta_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                               const __grid_constant__ CUtensorMap tm_b,
                               __nv_bfloat16* __restrict__ c,
                               float* __restrict__ buf, MmArgs p) {
  wg_walk<BN, false>(tm_a, tm_b, c, buf, p);
}

template <int BN>
__global__ void __launch_bounds__(MM_WG_MAX_THREADS, 1)
block_matmul_rmw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                              const __grid_constant__ CUtensorMap tm_b,
                              __nv_bfloat16* __restrict__ c,
                              float* __restrict__ buf, MmArgs p) {
  wg_walk<BN, true>(tm_a, tm_b, c, buf, p);
}

// ----------------------------------------------------------- launching

template <typename T>
__global__ void __launch_bounds__(MM_THREADS, 1)
block_matmul_osta_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         T* c, float* buf, MmArgs p) {
  walk<T, false>(a, b, c, buf, p);
}

template <typename T>
__global__ void __launch_bounds__(MM_THREADS, 1)
block_matmul_rmw_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        T* c, float* buf, MmArgs p) {
  walk<T, true>(a, b, c, buf, p);
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, T*, float*, MmArgs);

template <typename T>
KernelFn<T> kernel_of(bool rmw) {
  return rmw ? block_matmul_rmw_kernel<T> : block_matmul_osta_kernel<T>;
}

using WgKernelFn = void (*)(CUtensorMap, CUtensorMap, __nv_bfloat16*, float*,
                            MmArgs);

// The wgmma core's kernel for a tile width and body; null for a width
// the core does not take.
WgKernelFn wg_kernel_of(int bn, bool rmw) {
  switch (bn) {
#define MM_WG_CASE(N)                                                    \
  case N:                                                                \
    return rmw ? block_matmul_rmw_wgmma_kernel<N>                        \
               : block_matmul_osta_wgmma_kernel<N>;
    MM_WG_CASE(16) MM_WG_CASE(32) MM_WG_CASE(48) MM_WG_CASE(64)
    MM_WG_CASE(80) MM_WG_CASE(96) MM_WG_CASE(112) MM_WG_CASE(128)
    MM_WG_CASE(256)
#undef MM_WG_CASE
  }
  return nullptr;
}

// A launch configuration of `grid` blocks of `threads` in clusters of
// cs x cs_y blocks along x and y.
struct Config {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  Config(dim3 grid, int smem, int cs, cudaStream_t stream, int threads,
         int cs_y = 1) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
    attr[0].val.clusterDim.y = static_cast<unsigned>(cs_y);
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, void* buf,
                   const MmArgs& p, bool rmw, dim3 grid, int smem,
                   cudaStream_t stream) {
  auto kern = kernel_of<T>(rmw);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Config conf(grid, smem, p.cs, stream, MM_THREADS);
  err = cudaLaunchKernelEx(&conf.cfg, kern, static_cast<const T*>(a),
                           static_cast<const T*>(b), static_cast<T*>(c),
                           static_cast<float*>(buf), p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The driver's cuTensorMapEncodeTiled, through the runtime, so that the
// library needs no -lcuda; null if the driver has none.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// A tensor map over a row-major bf16 array of `outer` rows of `inner`
// elements, in boxes of box_outer rows of box_inner elements, each row
// swizzled as the wgmma descriptors read it.
bool bf16_tensor_map(CUtensorMap* map, const void* ptr, int inner,
                     int outer, int box_inner, int box_outer) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elems[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      box_inner == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_inner == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elems,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of the wgmma core: the tensor maps (K3's boxes in shares of
// their rows), the ring depth, and K3's cm x cn or K4's cs x 1 cluster.
cudaError_t launch_wg(const void* a, const void* b, void* c, void* buf,
                      MmArgs p, bool rmw, dim3 grid, int smem,
                      cudaStream_t stream) {
  const WgKernelFn kern = wg_kernel_of(p.bn, rmw);
  // each sharer fetches its share of a box's rows: K3's A boxes are split
  // over the cn ranks of a tile row, its B boxes over the cm of a column
  const int b_rows = p.bk < 256 ? p.bk : 256;
  CUtensorMap tm_a, tm_b;
  if (kern == nullptr ||
      !bf16_tensor_map(&tm_a, a, p.k, p.m, atom_width(p.bk), p.bm / p.cn) ||
      !bf16_tensor_map(&tm_b, b, p.n, p.k, atom_width(p.bn), b_rows / p.cm))
    return cudaErrorInvalidValue;
  p.stages = wg_stages(p.bm, p.bn, p.bk, rmw);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool k3 = !rmw;
  Config conf(grid, smem, k3 ? k3_cx(p) : p.cs, stream,
              wg_block_threads(p.bm, p.bn, rmw), k3 ? k3_cy(p) : 1);
  err = cudaLaunchKernelEx(&conf.cfg, kern, tm_a, tm_b,
                           static_cast<__nv_bfloat16*>(c),
                           static_cast<float*>(buf), p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Fn>
int clusters_that_fit(Fn kern, int threads, int cs, int smem, int cs_y = 1) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  Config conf(dim3(cs, cs_y), smem, cs, nullptr, threads, cs_y);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kern, &conf.cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return count;
}

}  // namespace

// The core a tile runs on (0 = fma, 1 = mma.sync, 2 = wgmma); dtype: 0 =
// float32, 1 = bfloat16.
extern "C" int block_matmul_core(int bm, int bn, int bk, int dtype) {
  (void)bn;
  (void)bk;
  return mm_core(bm, dtype == 0 ? 4 : 2);
}

// Shared memory one block of K3 (rmw = 0) or K4 (rmw = 1) allocates.
extern "C" long long block_matmul_smem_bytes(int bm, int bn, int bk,
                                             int dtype_bytes, int rmw) {
  return mm_smem_bytes(bm, bn, bk, dtype_bytes, rmw != 0);
}

// How many clusters of cs blocks of K4 at tiles (bm, bn) with `smem` bytes
// of shared memory each fit on the card at once
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t on error.
extern "C" int block_matmul_max_active_clusters(int dtype, int bm, int bn,
                                                int cs, int smem) {
  if (dtype == 0)
    return clusters_that_fit(kernel_of<float>(true), MM_THREADS, cs, smem);
  if (dtype != 1) return -static_cast<int>(cudaErrorInvalidValue);
  if (mm_core(bm, 2) != CORE_WGMMA)
    return clusters_that_fit(kernel_of<__nv_bfloat16>(true), MM_THREADS, cs,
                             smem);
  const WgKernelFn kern = wg_kernel_of(bn, true);
  if (kern == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return clusters_that_fit(kern, wg_block_threads(bm, bn, true), cs, smem);
}

// How many clusters of cm x cn blocks of K3 on the wgmma core at tiles
// (bm, bn) with `smem` bytes of shared memory each fit on the card at once;
// a negative cudaError_t on error.
extern "C" int block_matmul_k3_max_active_clusters(int bm, int bn, int cm,
                                                   int cn, int smem) {
  const WgKernelFn kern = wg_kernel_of(bn, false);
  if (kern == nullptr || mm_core(bm, 2) != CORE_WGMMA)
    return -static_cast<int>(cudaErrorInvalidValue);
  return clusters_that_fit(kern, wg_block_threads(bm, bn, false), cn, smem,
                           cm);
}

// Whether K3 takes a cluster of cm x cn ranks (along m and n) at these
// tiles and trips: 1 or 2 ranks a side, each dividing its trips; more than
// one rank only on the wgmma core, where each sharer's part of a box must
// start on 1024 bytes of its slot (the 128-byte swizzle's period).
// `k3_cluster_ok` in core/planner.py is the same rule.
extern "C" int block_matmul_k3_cluster_ok(int bm, int bn, int bk, int m_t,
                                          int n_t, int cm, int cn,
                                          int dtype_bytes) {
  if (cm < 1 || cn < 1 || cm > MM_K3_MAX_CLUSTER_SIDE ||
      cn > MM_K3_MAX_CLUSTER_SIDE || m_t % cm || n_t % cn)
    return 0;
  if (cm * cn == 1) return 1;
  if (mm_core(bm, dtype_bytes) != CORE_WGMMA) return 0;
  const int b_rows = bk < 256 ? bk : 256;
  return (bm / cn) * atom_width(bk) * 2 % 1024 == 0 &&
         (b_rows / cm) * atom_width(bn) * 2 % 1024 == 0;
}

// A (m, k), B (k, n), C (m, n), row-major and contiguous, each starting on
// 16 bytes; buf (m, n) f32, used by K4 only (it may be C itself when C is
// f32).  order_* are the loop dims outer -> inner (0 = m, 1 = n, 2 = k);
// axis_m / axis_n say which grid axis carries m / n (0 = x, 1 = y, -1 =
// walked in the block); the launch walks k tiles [k_lo, k_lo + k_cnt).
// cs: blocks of a cluster along x splitting the innermost loop (K4; 1
// otherwise); grid_x counts them.  cm x cn: K3's cluster, ranks along m
// and n (`block_matmul_k3_cluster_ok`; 1 x 1 for K4), and group: the
// tile rows of the grid's y loop in one group of K3's raster (a multiple
// of the cluster's extent along y).  dtype: 0 = float32, 1 = bfloat16.  The
// core is `block_matmul_core`'s; there is no fallback from one to another.
// Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
extern "C" int block_matmul_launch(const void* a, const void* b, void* c,
                                   void* buf, int dtype, int m, int n, int k,
                                   int bm, int bn, int bk, int order_0,
                                   int order_1, int order_2, int axis_m,
                                   int axis_n, int k_lo, int k_cnt, int rmw,
                                   int cs, int cm, int cn, int group,
                                   int grid_x, int grid_y, void* stream) {
  const int dtype_bytes = dtype == 0 ? 4 : 2;
  const int max_bn =
      mm_core(bm, dtype_bytes) == CORE_WGMMA ? MM_WG_MAX_BN : MM_MAX_TILE;
  if (bm <= 0 || bn <= 0 || bk <= 0 || bm > MM_MAX_TILE || bn > max_bn ||
      bm % 16 || bn % 16 || bk % 16 || m % bm != 0 || n % bn != 0 ||
      k % bk != 0 || cs < 1 || cs > MM_MAX_CLUSTER || grid_x % cs != 0 ||
      (cs > 1 && (rmw == 0 || axis_m > 0 || axis_n > 0 ||
                  (order_2 == 0 ? m / bm : n / bn) < cs)) ||
      (dtype != 0 && dtype != 1) || (rmw != 0) != (order_2 != 2) ||
      (rmw != 0 && (cm != 1 || cn != 1)) ||
      (rmw == 0 && (cs != 1 || group < 1 ||
                    !block_matmul_k3_cluster_ok(bm, bn, bk, m / bm, n / bn,
                                                cm, cn, dtype_bytes))))
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a)
                         | reinterpret_cast<uintptr_t>(b)
                         | reinterpret_cast<uintptr_t>(c)
                         | reinterpret_cast<uintptr_t>(buf);
  if (ptrs % 16 != 0) return cudaErrorMisalignedAddress;
  const long long smem = mm_smem_bytes(bm, bn, bk, dtype_bytes, rmw != 0);
  if (smem > REPRO_SMEM_LIMIT_BYTES) return cudaErrorInvalidValue;
  MmArgs p{m, n, k, bm, bn, bk, m / bm, n / bn, k / bk,
           {order_0, order_1, order_2}, axis_m, axis_n, k_lo, k_cnt, cs, cm,
           cn, group, 0};
  if (rmw == 0 && (grid_x % k3_cx(p) || grid_y % k3_cy(p) ||
                   group % k3_cy(p)))
    return cudaErrorInvalidValue;
  dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  switch (mm_core(bm, dtype_bytes)) {
    case CORE_WGMMA:
      return launch_wg(a, b, c, buf, p, rmw != 0, grid, sm, st);
    case CORE_MMA_SYNC:
      return launch<__nv_bfloat16>(a, b, c, buf, p, rmw != 0, grid, sm, st);
    default:
      return launch<float>(a, b, c, buf, p, rmw != 0, grid, sm, st);
  }
}
