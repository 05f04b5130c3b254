// Block GeMM C = A @ B under a planned tiling (bm, bn, bk) and loop order.
//
// Replaces the Pallas TPU kernel `block_matmul` of
// src/repro/kernels/block_matmul.py with its two bodies: `_mm_kernel_osta`
// (k innermost, output-stationary; here `block_matmul_osta_kernel`, K3) and
// `_mm_kernel_rmw` (k not innermost, partial C read-modified-written
// through an f32 buffer; here `block_matmul_rmw_kernel`, K4).  It is what
// `ops.matmul` launches.
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
// device memory; the peers copy it out of rank 0's shared memory
// (distributed shared memory), between two cluster barriers.  Each A and B
// tile is thus read from device memory as often as in the sequential
// sweep, and each C tile still belongs to one block.
//
// Each step's tile product is formed from zero in f32 over bk and then
// added to the running C value in the order of k, the same in both
// bodies, so every order gives the same result, bit for bit, and C is
// rounded once.
//
// What bounds it on an H100: operations, for the large products the
// planner sizes (TinyLlama's prefill projections do 2*m*n*k = 16-44 GFLOP
// on 12-46 MB); bytes, for skinny ones and for K4, whose f32 partials
// cross device memory at every k step.  The design:
//   * bfloat16 runs on the tensor cores: 8 warps, each owning up to 4 x 4
//     `mma.sync.m16n8k16` fragments (a 64x32 piece of a 128x128 C tile),
//     operands loaded with `ldmatrix` (B, stored (k, n) row-major, with
//     `.trans`); float32 stays on the f32 units (16x16 threads, each up to
//     8 rows x 4 column pairs), since TF32 would not hold f32's tolerance;
//   * A and B tiles come in by 16-byte `cp.async` copies into a two-stage
//     ring: the next step's new tiles are issued before this step's
//     product; rows are padded by 16 bytes against bank conflicts;
//   * tiles are multiples of 16, and bm, bn at most 128 (the fragments a
//     warp holds).  wgmma, TMA and multicast are later work.
#include "repro_common.cuh"

#include <cooperative_groups.h>
#include <cstdint>

namespace cg = cooperative_groups;

#define MM_MAX_TILE 128   // bm, bn: 8 warps x 64x32 fragments / 16 x 8 values
#define MM_THREADS 256
#define MM_MAX_CLUSTER 8  // the portable cluster size

namespace {

struct MmArgs {
  int m, n, k, bm, bn, bk;
  int m_t, n_t, k_t;
  int order[3];   // loop dims outer -> inner: 0 = m, 1 = n, 2 = k
  int axis_m;     // blockIdx axis of the m loop: 0 = x, 1 = y, -1 = walked
  int axis_n;     // the same for n (k is never on the grid)
  int k_lo, k_cnt;
  int cs;         // blocks of a cluster (along x) splitting the inner loop
};

// ------------------------------------------------------------------ PTX

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
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
};

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

  Walk w;
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
      w.lo[i] = axis == 0 ? static_cast<int>(blockIdx.x) / p.cs
                          : static_cast<int>(blockIdx.y);
      w.cnt[i] = 1;
    } else if (i == 2 && clu) {   // rank r: inner tiles r, r + cs, ...
      w.lo[i] = rank;
      w.str[i] = p.cs;
      w.cnt[i] = (trips - rank + p.cs - 1) / p.cs;
    } else {
      w.lo[i] = 0;
      w.cnt[i] = trips;
    }
  }
  const int total = w.cnt[0] * w.cnt[1] * w.cnt[2];

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

// A launch configuration of `grid` blocks in clusters of cs along x.
struct Config {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  Config(dim3 grid, int smem, int cs, cudaStream_t stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(MM_THREADS);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
    attr[0].val.clusterDim.y = 1;
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
  Config conf(grid, smem, p.cs, stream);
  err = cudaLaunchKernelEx(&conf.cfg, kern, static_cast<const T*>(a),
                           static_cast<const T*>(b), static_cast<T*>(c),
                           static_cast<float*>(buf), p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int max_active_clusters(int cs, int smem) {
  auto kern = kernel_of<T>(true);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  Config conf(dim3(cs), smem, cs, nullptr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kern, &conf.cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return count;
}

}  // namespace

// Shared memory one block allocates: two stages of the A tile and of the
// B tile, each row padded by 16 bytes.
extern "C" long long block_matmul_smem_bytes(int bm, int bn, int bk,
                                             int dtype_bytes) {
  const int pad = 16 / dtype_bytes;
  return 2LL * (1LL * bm * (bk + pad) + 1LL * bk * (bn + pad)) * dtype_bytes;
}

// How many clusters of cs blocks of K4 with `smem` bytes of shared memory
// each fit on the card at once (cudaOccupancyMaxActiveClusters); a
// negative cudaError_t on error.
extern "C" int block_matmul_max_active_clusters(int dtype, int cs,
                                                int smem) {
  if (dtype == 0) return max_active_clusters<float>(cs, smem);
  if (dtype == 1) return max_active_clusters<__nv_bfloat16>(cs, smem);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// A (m, k), B (k, n), C (m, n), row-major and contiguous, each starting on
// 16 bytes; buf (m, n) f32, used by K4 only (it may be C itself when C is
// f32).  order_* are the loop dims outer -> inner (0 = m, 1 = n, 2 = k);
// axis_m / axis_n say which grid axis carries m / n (0 = x, 1 = y, -1 =
// walked in the block); the launch walks k tiles [k_lo, k_lo + k_cnt).
// cs: blocks of a cluster along x splitting the innermost loop (K4; 1
// otherwise); grid_x counts them.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
extern "C" int block_matmul_launch(const void* a, const void* b, void* c,
                                   void* buf, int dtype, int m, int n, int k,
                                   int bm, int bn, int bk, int order_0,
                                   int order_1, int order_2, int axis_m,
                                   int axis_n, int k_lo, int k_cnt, int rmw,
                                   int cs, int grid_x, int grid_y,
                                   void* stream) {
  if (bm <= 0 || bn <= 0 || bk <= 0 || bm > MM_MAX_TILE || bn > MM_MAX_TILE ||
      bm % 16 || bn % 16 || bk % 16 || m % bm != 0 || n % bn != 0 ||
      k % bk != 0 || cs < 1 || cs > MM_MAX_CLUSTER || grid_x % cs != 0 ||
      (cs > 1 && (rmw == 0 || axis_m > 0 || axis_n > 0 ||
                  (order_2 == 0 ? m / bm : n / bn) < cs)))
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a)
                         | reinterpret_cast<uintptr_t>(b)
                         | reinterpret_cast<uintptr_t>(c)
                         | reinterpret_cast<uintptr_t>(buf);
  if (ptrs % 16 != 0) return cudaErrorMisalignedAddress;
  const int dtype_bytes = dtype == 0 ? 4 : 2;
  const long long smem = block_matmul_smem_bytes(bm, bn, bk, dtype_bytes);
  if (smem > REPRO_SMEM_LIMIT_BYTES) return cudaErrorInvalidValue;
  MmArgs p{m, n, k, bm, bn, bk, m / bm, n / bn, k / bk,
           {order_0, order_1, order_2}, axis_m, axis_n, k_lo, k_cnt, cs};
  dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  if (dtype == 0)
    return launch<float>(a, b, c, buf, p, rmw != 0, grid, sm, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, c, buf, p, rmw != 0, grid, sm, st);
  return cudaErrorInvalidValue;
}
