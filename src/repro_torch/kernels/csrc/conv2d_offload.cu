// S1 convolution, simple kernel: every grid step fetches its full window.
//
// Replaces the Pallas TPU kernel `conv2d_offload` / `_conv_kernel` (with
// the shared `_im2col_dot`) of src/repro/kernels/conv2d_offload.py; it is
// what `ops.conv2d` launches.
//
// Mapping.  The TPU kernel carries nothing from one grid step to the next,
// so nothing forces its steps into one block: one thread block per grid
// step (i, jt).  The block loads its (C_in, H_K, t_in) input window into
// shared memory (the step's I_slice, action a4) and waits on it, with no
// prefetch of the next step (that is the planned kernel's contract, not
// this one's), computes the (t_run x N) product in f32 and stores the
// (N, 1, t_run) output block, rounded once.  Zigzag only decides which
// block writes which tile (`eff_tile`), as the reference's output index
// map does.
//
// WARNING, as in the reference: neighbouring steps re-fetch the w_k - s_w
// columns and h_k - s_h rows their windows share, so this kernel's traffic
// is NOT the plan's Def-3 I_slice accounting.  conv2d_offload_planned.cu
// is the kernel whose fetches are the plan's.
//
// The product.  Each thread keeps a register tile of 4 output columns x 4
// kernel channels, so every window value and every Λ value it loads feeds
// four multiply-adds.  The C_in*H_K*W_K reduction is split into
// `conv_simple_k_groups` contiguous ranges, one per group of threads (a
// group holds one thread per tile of the output block); each group leaves
// its partial block in shared memory and the block sums the groups in a
// fixed order, so the result does not depend on the schedule.  Λ is read
// in w's own (N, C_in, H_K, W_K) layout through L1, so the wrapper
// transposes nothing: consecutive terms of one channel are consecutive
// addresses (one 32-byte sector serves eight f32 terms), and the threads
// of a warp that share a channel tile read the same word.  The term loop
// has no branch (the window offset advances by a select), so the compiler
// unrolls it and keeps several terms' loads in flight: in a first version
// a branch at each row's end serialised every term on a load's latency.
// (Staging Λ in shared memory, transposed, was tried and measured slower
// at every ResNet-8 layer: the copy's own latency cost more than it
// saved.)  The window is fetched one warp per (c, kh) row, 16-byte vectors
// where the row's source and destination are both aligned, with one
// division per row and none per element.
//
// What bounds it on an H100: at the layer sizes of the conv networks here
// (at most a few hundred KB in, a few MFLOP) both the bytes moved and the
// operations take well under a microsecond at the card's peak rates, so a
// launch's latency and the depth of each thread's sum bound it.  The
// design shortens that sum by the number of groups (up to 8 at ResNet-8's
// layers, whose 8-32 steps each have a 512-output block) and feeds four
// FMAs per load.  The product runs on the ordinary f32 units (fmaf), not
// on the tensor cores.
#include "conv_common.cuh"

#define CONV_THREADS 256
#define CONV_TT 4          // output columns of a thread's tile
#define CONV_TN 4          // kernel channels of a thread's tile
#define CONV_MIN_K 4       // least reduction depth of one group

// Groups the reduction is split over: the largest power of two with one
// thread per output tile in every group and every group CONV_MIN_K deep.
// core.planner.conv_simple_k_groups is the same rule.
__host__ __device__ inline int conv_simple_k_groups(int t_run, int n,
                                                    int k_total) {
  const int tiles = ((t_run + CONV_TT - 1) / CONV_TT)
                    * ((n + CONV_TN - 1) / CONV_TN);
  int cap = CONV_THREADS / tiles;
  if (k_total / CONV_MIN_K < cap) cap = k_total / CONV_MIN_K;
  int kg = 1;
  while (kg * 2 <= cap) kg *= 2;
  return kg;
}

namespace {

struct ConvArgs {
  int c_in, h_in, w_in, n, h_k, w_k, s_h, s_w, t_run, h_out, tiles, zigzag;
  int kg;
  long long red_offset;    // bytes from the window to the partial blocks
};

template <typename T>
__global__ void __launch_bounds__(CONV_THREADS)
conv2d_offload_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      T* __restrict__ out, ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + a.red_offset);

  const int i = blockIdx.y;
  const int jt = eff_tile(i, static_cast<int>(blockIdx.x), a.tiles, a.zigzag);
  const int t_in = t_in_cols(a.t_run, a.s_w, a.w_k);
  const int h0 = i * a.s_h;
  const int w0 = jt * a.t_run * a.s_w;
  const int rows = a.c_in * a.h_k;
  const int lane = threadIdx.x & 31;

  // a4: the full (C_in, H_K, t_in) window, one warp per row, waited on
  // before the product.
  constexpr int VEC = 16 / sizeof(T);
  for (int row = threadIdx.x >> 5; row < rows; row += CONV_THREADS / 32) {
    const int c = row / a.h_k;
    const int r = row - c * a.h_k;
    const T* src = x + (static_cast<long long>(c) * a.h_in + h0 + r) * a.w_in
                   + w0;
    T* dst = win + row * t_in;
    int done = 0;
    if (((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst))
         & 15) == 0) {
      const int nv = t_in / VEC;
      for (int e = lane; e < nv; e += 32)
        reinterpret_cast<uint4*>(dst)[e] =
            reinterpret_cast<const uint4*>(src)[e];
      done = nv * VEC;
    }
    for (int e = done + lane; e < t_in; e += 32) dst[e] = src[e];
  }
  __syncthreads();

  // a6: register tiles of (4 columns x 4 channels), the reduction split
  // over a.kg groups of n_tiles threads.
  const int k_total = rows * a.w_k;
  const int wrap = t_in - a.w_k + 1;   // offset step from a row's last term
  const int tiles_t = (a.t_run + CONV_TT - 1) / CONV_TT;
  const int n_tiles = tiles_t * ((a.n + CONV_TN - 1) / CONV_TN);
  const int w_out = a.tiles * a.t_run;
  const int col0 = jt * a.t_run;
  for (int job = threadIdx.x; job < a.kg * n_tiles; job += CONV_THREADS) {
    const int g = job / n_tiles;
    const int tile = job - g * n_tiles;
    const int nc = tile / tiles_t;
    const int t0 = (tile - nc * tiles_t) * CONV_TT;
    const int n0 = nc * CONV_TN;
    const int k_lo = static_cast<int>(static_cast<long long>(g) * k_total
                                      / a.kg);
    const int k_hi = static_cast<int>(static_cast<long long>(g + 1) * k_total
                                      / a.kg);
    // columns and channels past the block's edge are clamped onto its last
    // one: computed, never stored
    const T* lam[CONV_TN];
#pragma unroll
    for (int j = 0; j < CONV_TN; ++j)
      lam[j] = w + static_cast<long long>(min(n0 + j, a.n - 1)) * k_total;
    int col[CONV_TT];
#pragma unroll
    for (int tt = 0; tt < CONV_TT; ++tt)
      col[tt] = min(t0 + tt, a.t_run - 1) * a.s_w;
    float acc[CONV_TT][CONV_TN];
#pragma unroll
    for (int tt = 0; tt < CONV_TT; ++tt)
#pragma unroll
      for (int j = 0; j < CONV_TN; ++j) acc[tt][j] = 0.0f;
    const int row0 = k_lo / a.w_k;
    int kw = k_lo - row0 * a.w_k;
    int off = row0 * t_in + kw;          // term k's column 0 in the window
#pragma unroll 8
    for (int k = k_lo; k < k_hi; ++k) {
      float xv[CONV_TT], lv[CONV_TN];
#pragma unroll
      for (int tt = 0; tt < CONV_TT; ++tt) xv[tt] = to_f32(win[off + col[tt]]);
#pragma unroll
      for (int j = 0; j < CONV_TN; ++j) lv[j] = to_f32(lam[j][k]);
#pragma unroll
      for (int tt = 0; tt < CONV_TT; ++tt)
#pragma unroll
        for (int j = 0; j < CONV_TN; ++j)
          acc[tt][j] = fmaf(xv[tt], lv[j], acc[tt][j]);
      const bool row_end = ++kw == a.w_k;   // selects, not a branch
      kw = row_end ? 0 : kw;
      off += row_end ? wrap : 1;
    }
#pragma unroll
    for (int j = 0; j < CONV_TN; ++j) {
      const int n = n0 + j;
#pragma unroll
      for (int tt = 0; tt < CONV_TT; ++tt) {
        const int t = t0 + tt;
        if (n >= a.n || t >= a.t_run) continue;
        if (a.kg == 1)
          out[(static_cast<long long>(n) * a.h_out + i) * w_out + col0 + t] =
              from_f32<T>(acc[tt][j]);
        else
          red[(g * a.n + n) * a.t_run + t] = acc[tt][j];
      }
    }
  }
  if (a.kg > 1) {
    // W: the groups' partial blocks summed in order, rounded once; rows
    // of the output block are t_run consecutive addresses
    __syncthreads();
    const int o = a.n * a.t_run;
    for (int e = threadIdx.x; e < o; e += CONV_THREADS) {
      float s = red[e];
      for (int g = 1; g < a.kg; ++g) s += red[g * o + e];
      const int n = e / a.t_run;
      const int t = e - n * a.t_run;
      out[(static_cast<long long>(n) * a.h_out + i) * w_out + col0 + t] =
          from_f32<T>(s);
    }
  }
}

long long window_bytes(int c_in, int h_k, int w_k, int s_w, int t_run,
                       int dtype_bytes) {
  return static_cast<long long>(c_in) * h_k * t_in_cols(t_run, s_w, w_k)
         * dtype_bytes;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out,
                   const ConvArgs& a, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv2d_offload_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.tiles, a.h_out);
  conv2d_offload_kernel<T><<<grid, CONV_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block allocates: the window and, with more than one
// group, from the next 16-byte boundary, each group's f32 (N, t_run)
// partial block.
extern "C" long long conv2d_offload_smem_bytes(int c_in, int h_k, int w_k,
                                               int s_w, int t_run, int n,
                                               int dtype_bytes) {
  const long long win = window_bytes(c_in, h_k, w_k, s_w, t_run, dtype_bytes);
  const int kg = conv_simple_k_groups(t_run, n, c_in * h_k * w_k);
  if (kg == 1) return win;
  return (win + 15) / 16 * 16 + 4LL * kg * t_run * n;
}

extern "C" int conv2d_offload_k_groups(int t_run, int n, int k_total) {
  return conv_simple_k_groups(t_run, n, k_total);
}

// x (C_in, H_in, W_in) and w (N, C_in, H_K, W_K), contiguous, of the same
// dtype: 0 = float32, 1 = bfloat16; out (N, h_out, tiles * t_run).
// Returns the cudaError_t of the launch (0 on success); a launch that is
// refused never runs, and only this code says so.  Does not synchronise.
extern "C" int conv2d_offload_launch(const void* x, const void* w, void* out,
                                     int dtype, int c_in, int h_in, int w_in,
                                     int n, int h_k, int w_k, int s_h, int s_w,
                                     int t_run, int h_out, int tiles,
                                     int zigzag, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int dtype_bytes = dtype == 0 ? 4 : 2;
  const long long smem = conv2d_offload_smem_bytes(c_in, h_k, w_k, s_w, t_run,
                                                   n, dtype_bytes);
  if (smem > REPRO_SMEM_LIMIT_BYTES) return cudaErrorInvalidValue;
  const long long win = window_bytes(c_in, h_k, w_k, s_w, t_run, dtype_bytes);
  ConvArgs a{c_in, h_in, w_in, n, h_k, w_k, s_h, s_w, t_run, h_out, tiles,
             zigzag, conv_simple_k_groups(t_run, n, c_in * h_k * w_k),
             (win + 15) / 16 * 16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, out, a, static_cast<int>(smem), st);
  return launch<__nv_bfloat16>(x, w, out, a, static_cast<int>(smem), st);
}
