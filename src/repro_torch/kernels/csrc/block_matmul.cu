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
// Each step's tile product is summed in f32 over bk and then added to the
// running C value in the order of k, the same in both bodies, so every
// order gives the same result, bit for bit, and C is rounded once.
//
// What bounds it on an H100: operations, for the large products the
// planner sizes (TinyLlama's prefill projections do 2*m*n*k = 16-44 GFLOP
// on 12-46 MB); bytes, for skinny ones.  This first version runs its
// products on the ordinary f32 units (fmaf; 67 TFLOP/s at best), 16x16
// threads each owning an up to 8x8 piece of the C tile, so bm and bn are
// at most 128.  Tensor cores (wgmma) and TMA fetches are later work.
#include "repro_common.cuh"

#define MM_MAX_TILE 128   // bm, bn: 16 threads x 8 values
#define MM_SIDE 16
#define MM_REG 8

namespace {

struct MmArgs {
  int m, n, k, bm, bn, bk;
  int m_t, n_t, k_t;
  int order[3];   // loop dims outer -> inner: 0 = m, 1 = n, 2 = k
  int axis_m;     // blockIdx axis of the m loop: 0 = x, 1 = y, -1 = walked
  int axis_n;     // the same for n (k is never on the grid)
  int k_lo, k_cnt;
};

__device__ inline int block_index(int axis) {
  return axis == 0 ? static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.y);
}

// The block's walk over its (mm, nn, kk) steps, in the order's sequence.
// RMW = false: K3, one C tile per block, accumulator in registers.
// RMW = true: K4, partials through `buf` (f32; may alias `c` when C is f32).
template <typename T, bool RMW>
__device__ void walk(const T* __restrict__ a, const T* __restrict__ b,
                     T* c, float* buf, const MmArgs& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);
  T* b_s = a_s + p.bm * p.bk;

  const int tid = threadIdx.x;
  const int ty = tid / MM_SIDE;
  const int tx = tid - ty * MM_SIDE;

  int lo[3], cnt[3];
  lo[0] = p.axis_m >= 0 ? block_index(p.axis_m) : 0;
  cnt[0] = p.axis_m >= 0 ? 1 : p.m_t;
  lo[1] = p.axis_n >= 0 ? block_index(p.axis_n) : 0;
  cnt[1] = p.axis_n >= 0 ? 1 : p.n_t;
  lo[2] = p.k_lo;
  cnt[2] = p.k_cnt;
  const int o0 = p.order[0], o1 = p.order[1], o2 = p.order[2];

  float acc[MM_REG][MM_REG];
#pragma unroll
  for (int i = 0; i < MM_REG; ++i)
#pragma unroll
    for (int j = 0; j < MM_REG; ++j) acc[i][j] = 0.0f;

  int held_a_m = -1, held_a_k = -1, held_b_k = -1, held_b_n = -1;
  for (int i0 = 0; i0 < cnt[o0]; ++i0) {
    for (int i1 = 0; i1 < cnt[o1]; ++i1) {
      for (int i2 = 0; i2 < cnt[o2]; ++i2) {
        int t[3];
        t[o0] = lo[o0] + i0;
        t[o1] = lo[o1] + i1;
        t[o2] = lo[o2] + i2;
        const int mm = t[0], nn = t[1], kk = t[2];
        const bool new_a = mm != held_a_m || kk != held_a_k;
        const bool new_b = kk != held_b_k || nn != held_b_n;
        if (new_a || new_b) {
          __syncthreads();   // the previous step's readers are done
          if (new_a) {       // a4: the A tile (mm, kk)
            for (int e = tid; e < p.bm * p.bk; e += blockDim.x) {
              const int r = e / p.bk;
              const int col = e - r * p.bk;
              a_s[e] = a[static_cast<long long>(mm * p.bm + r) * p.k
                         + kk * p.bk + col];
            }
            held_a_m = mm;
            held_a_k = kk;
          }
          if (new_b) {       // a4: the B tile (kk, nn)
            for (int e = tid; e < p.bk * p.bn; e += blockDim.x) {
              const int r = e / p.bn;
              const int col = e - r * p.bn;
              b_s[e] = b[static_cast<long long>(kk * p.bk + r) * p.n
                         + nn * p.bn + col];
            }
            held_b_k = kk;
            held_b_n = nn;
          }
          __syncthreads();
        }
        // a6: this step's tile product, summed in f32 over bk
        float part[MM_REG][MM_REG];
#pragma unroll
        for (int i = 0; i < MM_REG; ++i)
#pragma unroll
          for (int j = 0; j < MM_REG; ++j) part[i][j] = 0.0f;
        for (int q = 0; q < p.bk; ++q) {
          float af[MM_REG], bf[MM_REG];
#pragma unroll
          for (int i = 0; i < MM_REG; ++i) {
            const int r = ty + MM_SIDE * i;
            af[i] = r < p.bm ? to_f32(a_s[r * p.bk + q]) : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < MM_REG; ++j) {
            const int col = tx + MM_SIDE * j;
            bf[j] = col < p.bn ? to_f32(b_s[q * p.bn + col]) : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < MM_REG; ++i)
#pragma unroll
            for (int j = 0; j < MM_REG; ++j)
              part[i][j] = fmaf(af[i], bf[j], part[i][j]);
        }
        // a3: add to the running C value in k order; cast once at the end
        const bool last_k = kk == p.k_t - 1;
#pragma unroll
        for (int i = 0; i < MM_REG; ++i) {
          const int r = ty + MM_SIDE * i;
#pragma unroll
          for (int j = 0; j < MM_REG; ++j) {
            const int col = tx + MM_SIDE * j;
            if (r >= p.bm || col >= p.bn) continue;
            const long long at = static_cast<long long>(mm * p.bm + r) * p.n
                                 + nn * p.bn + col;
            if (RMW) {
              const float val = kk == 0 ? part[i][j] : buf[at] + part[i][j];
              if (last_k) c[at] = from_f32<T>(val);
              else buf[at] = val;
            } else {
              acc[i][j] = kk == 0 ? part[i][j] : acc[i][j] + part[i][j];
              if (last_k) c[at] = from_f32<T>(acc[i][j]);
            }
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void block_matmul_osta_kernel(const T* __restrict__ a,
                                         const T* __restrict__ b, T* c,
                                         MmArgs p) {
  walk<T, false>(a, b, c, nullptr, p);
}

template <typename T>
__global__ void block_matmul_rmw_kernel(const T* __restrict__ a,
                                        const T* __restrict__ b, T* c,
                                        float* buf, MmArgs p) {
  walk<T, true>(a, b, c, buf, p);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, void* buf,
                   const MmArgs& p, bool rmw, dim3 grid, int smem,
                   cudaStream_t stream) {
  const T* a_ = static_cast<const T*>(a);
  const T* b_ = static_cast<const T*>(b);
  T* c_ = static_cast<T*>(c);
  cudaError_t err;
  if (rmw) {
    err = cudaFuncSetAttribute(block_matmul_rmw_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    block_matmul_rmw_kernel<T><<<grid, MM_SIDE * MM_SIDE, smem, stream>>>(
        a_, b_, c_, static_cast<float*>(buf), p);
  } else {
    err = cudaFuncSetAttribute(block_matmul_osta_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    block_matmul_osta_kernel<T><<<grid, MM_SIDE * MM_SIDE, smem, stream>>>(
        a_, b_, c_, p);
  }
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block allocates: one A tile and one B tile.
extern "C" long long block_matmul_smem_bytes(int bm, int bn, int bk,
                                             int dtype_bytes) {
  return (1LL * bm * bk + 1LL * bk * bn) * dtype_bytes;
}

// A (m, k), B (k, n), C (m, n), row-major and contiguous; buf (m, n) f32,
// used by K4 only (it may be C itself when C is f32).  order_* are the loop
// dims outer -> inner (0 = m, 1 = n, 2 = k); axis_m / axis_n say which grid
// axis carries m / n (0 = x, 1 = y, -1 = walked in the block); the launch
// walks k tiles [k_lo, k_lo + k_cnt).  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
extern "C" int block_matmul_launch(const void* a, const void* b, void* c,
                                   void* buf, int dtype, int m, int n, int k,
                                   int bm, int bn, int bk, int order_0,
                                   int order_1, int order_2, int axis_m,
                                   int axis_n, int k_lo, int k_cnt, int rmw,
                                   int grid_x, int grid_y, void* stream) {
  if (bm <= 0 || bn <= 0 || bk <= 0 || bm > MM_MAX_TILE || bn > MM_MAX_TILE ||
      m % bm != 0 || n % bn != 0 || k % bk != 0)
    return cudaErrorInvalidValue;
  const int dtype_bytes = dtype == 0 ? 4 : 2;
  const long long smem = block_matmul_smem_bytes(bm, bn, bk, dtype_bytes);
  if (smem > REPRO_SMEM_LIMIT_BYTES) return cudaErrorInvalidValue;
  MmArgs p{m, n, k, bm, bn, bk, m / bm, n / bn, k / bk,
           {order_0, order_1, order_2}, axis_m, axis_n, k_lo, k_cnt};
  dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  if (dtype == 0)
    return launch<float>(a, b, c, buf, p, rmw != 0, grid, sm, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, c, buf, p, rmw != 0, grid, sm, st);
  return cudaErrorInvalidValue;
}
