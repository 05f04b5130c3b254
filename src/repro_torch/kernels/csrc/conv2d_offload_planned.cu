// S1 convolution, plan-shaped kernel: resident window, per-step I_slice
// deltas prefetched one step ahead.
//
// Replaces the Pallas TPU kernel `conv2d_offload_planned` /
// `_conv_planned_kernel` (with the shared `_im2col_dot`) of
// src/repro/kernels/conv2d_offload.py; it is what `EmittedConv.run`
// launches for a solved LayerPlan.
//
// Contract.  Grid step s of the plan's ordered sweep fetches exactly the
// plan's Def-3 I_slice(s) from device memory and nothing else:
//   full       first step, or no overlap with the previous window: the
//              whole (C_in, H_K, t_in) box, fetched and waited on;
//   row-delta  a row turn that keeps the column window (zigzag, or one
//              tile per row): only the s_h new rows; the kept rows shift up;
//   col-delta  a within-row move: only the t_run*s_w new columns; the kept
//              ov_w columns slide left or right by sweep direction.
// Which case a step takes is `step_case` of kernels/conv2d_offload.py; the
// host decides `row_delta` and `col_delta` and passes them as flags.
//
// Mapping.  A Pallas-TPU grid runs its steps in order on one core and
// carries the window from step to step; CUDA blocks run in no order and
// share nothing.  So ONE thread block owns the whole ordered sweep of a
// layer, as a loop over the grid sequence inside the block, with Λ as
// (C_in*H_K*W_K, N), the window, the column-delta buffer and the row-delta
// buffer in dynamic shared memory for the length of the sweep (Λ is
// "loaded during the first step and never freed until the last", Def 16).
// No output is staged in shared memory: each thread stores its sums
// straight to device memory, so the footprint has no output term.
//
// What bounds it on an H100: neither the bytes nor the operations (both
// take well under a microsecond at the card's peak rates for the layers of
// the conv networks here) but the length of the sweep run by one block:
// h_out * tiles steps, each with its barriers and a per-thread sum
// C_in*H_K*W_K deep, on one of the card's 132 SMs.  That is the plan's
// ordered sweep mapped faithfully, and the known limit of this kernel.
// Spreading independent pieces of a plan (row bands, kernel-channel groups)
// over blocks is the way to use the other SMs.  The product runs on the
// ordinary f32 units (fmaf), not on the tensor cores.
//
// Prefetch.  The next step's delta is issued before this step's product
// into col_buf / row_buf (never into the live window) and retired at the
// top of the next step, with a barrier on each side.  For float32 the
// copies are cp.async (4 bytes each, always aligned), so they run under
// the product.  For bfloat16 a column delta may start at an odd element,
// which cp.async (4, 8 or 16 aligned bytes) cannot copy: bfloat16 uses
// ordinary loads issued before the product.
#include "conv_common.cuh"

namespace {

struct PlannedArgs {
  int c_in, h_in, w_in, n, h_k, w_k, s_h, s_w, t_run, h_out, tiles;
  int zigzag, row_delta, col_delta;
};

// One element of a delta, device memory -> shared memory.
__device__ inline void fetch_async(float* dst, const float* src) {
  const unsigned smem_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr),
               "l"(src));
}
__device__ inline void fetch_async(__nv_bfloat16* dst,
                                   const __nv_bfloat16* src) {
  *dst = *src;  // 2 bytes: below cp.async's smallest copy
}
__device__ inline void fetch_commit() {
  asm volatile("cp.async.commit_group;\n");
}
__device__ inline void fetch_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Move `count` elements inside one shared buffer where source and
// destination overlap.  Element e = (rr, cc), cc < inner, goes from
// buf[rr*stride + src_off + cc] to buf[rr*stride + dst_off + cc]: one flat
// shift by dst_off - src_off.  Threads that copy in place race, so a chunk
// of blockDim elements is read into registers, a barrier, then written.
// Chunks go in the direction of the shift's far end first (ascending for a
// shift down in address, descending for a shift up), so a chunk's writes
// land outside every later chunk's sources; one closing barrier orders the
// last writes before whatever follows.  Every thread runs every iteration.
template <typename T>
__device__ inline void shift_in_place(T* buf, int count, int inner, int stride,
                                      int src_off, int dst_off) {
  const int nthreads = blockDim.x;
  const int chunks = (count + nthreads - 1) / nthreads;
  const bool ascending = dst_off < src_off;
  for (int q = 0; q < chunks; ++q) {
    const int chunk = ascending ? q : chunks - 1 - q;
    const int e = chunk * nthreads + static_cast<int>(threadIdx.x);
    const bool live = e < count;
    int rr = 0, cc = 0;
    T v = T();
    if (live) {
      rr = e / inner;
      cc = e - rr * inner;
      v = buf[rr * stride + src_off + cc];
    }
    __syncthreads();
    if (live) buf[rr * stride + dst_off + cc] = v;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(1024)
conv2d_offload_planned_kernel(const T* __restrict__ x,
                              const T* __restrict__ lam_g,
                              T* __restrict__ out, PlannedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t_in = t_in_cols(a.t_run, a.s_w, a.w_k);
  const int nw = a.t_run * a.s_w;          // new columns per within-row move
  const int ov_w = t_in - nw;              // columns shared with the neighbour
  const int keep_rows = a.h_k - a.s_h;     // rows shared across a row turn
  const int k_total = a.c_in * a.h_k * a.w_k;
  const int win_elems = a.c_in * a.h_k * t_in;
  const int w_out = a.tiles * a.t_run;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  T* lam = reinterpret_cast<T*>(smem_raw);            // (k_total, N)
  T* win = lam + k_total * a.n;                       // (C_in, H_K, t_in)
  T* col_buf = win + win_elems;                       // (C_in, H_K, nw)
  T* row_buf = col_buf + a.c_in * a.h_k * nw;         // (C_in, rb_rows, t_in)

  // K_sub of the first step: all of Λ, once, resident to the end.
  for (int e = tid; e < k_total * a.n; e += nthreads) lam[e] = lam_g[e];

  const int n_steps = a.h_out * a.tiles;
  for (int s = 0; s < n_steps; ++s) {
    const int i = s / a.tiles;
    const int jt_raw = s - i * a.tiles;
    const int jt = eff_tile(i, jt_raw, a.tiles, a.zigzag);
    const int h0 = i * a.s_h;
    const int w0 = jt * nw;
    const bool first = s == 0;
    const bool rowchg = jt_raw == 0 && i > 0;
    const bool within = jt_raw > 0;
    const bool full = first || (!a.row_delta && rowchg)
                      || (!a.col_delta && within);

    // Retire the prefetch issued one step ago, and let every thread finish
    // the previous product before the window changes under it.
    fetch_wait();
    __syncthreads();

    if (full) {
      // No usable overlap with the previous window: the whole box.
      const int row_len = a.h_k * t_in;
      for (int e = tid; e < win_elems; e += nthreads) {
        const int c = e / row_len;
        const int rem = e - c * row_len;
        const int r = rem / t_in;
        const int col = rem - r * t_in;
        win[e] = x[(static_cast<long long>(c) * a.h_in + h0 + r) * a.w_in
                   + w0 + col];
      }
    } else if (rowchg) {
      // Row turn: shift the kept rows up, splice the s_h new rows in at
      // the bottom.  (row_delta implies keep_rows > 0 and s_h < h_k.)
      shift_in_place<T>(win, a.c_in * keep_rows * t_in, keep_rows * t_in,
                        a.h_k * t_in, a.s_h * t_in, 0);
      const int new_len = a.s_h * t_in;
      for (int e = tid; e < a.c_in * new_len; e += nthreads) {
        const int c = e / new_len;
        const int rem = e - c * new_len;
        win[(c * a.h_k + keep_rows) * t_in + rem] = row_buf[e];
      }
    } else {
      // Within-row move: slide the kept ov_w columns to their place in the
      // new window, splice the nw new columns in beside them.
      const int right = moving_right(i, a.zigzag);
      const int delta_off = ov_w * right;  // right: [ov_w, t_in); left: [0, nw)
      shift_in_place<T>(win, a.c_in * a.h_k * ov_w, ov_w, t_in, nw * right,
                        nw * (1 - right));
      for (int e = tid; e < a.c_in * a.h_k * nw; e += nthreads) {
        const int rr = e / nw;
        const int cc = e - rr * nw;
        win[rr * t_in + delta_off + cc] = col_buf[e];
      }
    }
    // The window is whole, and nobody reads col_buf / row_buf any more.
    __syncthreads();

    // Prefetch the NEXT step's delta into its own buffer while this step
    // computes.
    if (s + 1 < n_steps) {
      const int nxt_turn = (jt_raw == a.tiles - 1) ? 1 : 0;
      const int i_n = i + nxt_turn;
      const int jt_n =
          eff_tile(i_n, (jt_raw + 1) * (1 - nxt_turn), a.tiles, a.zigzag);
      const int h0_n = i_n * a.s_h;
      const int w0_n = jt_n * nw;
      if (nxt_turn && a.row_delta) {
        const int new_len = a.s_h * t_in;
        for (int e = tid; e < a.c_in * new_len; e += nthreads) {
          const int c = e / new_len;
          const int rem = e - c * new_len;
          const int r = rem / t_in;
          const int col = rem - r * t_in;
          fetch_async(row_buf + e,
                      x + (static_cast<long long>(c) * a.h_in + h0_n
                           + keep_rows + r) * a.w_in + w0_n + col);
        }
      } else if (!nxt_turn && a.col_delta) {
        const int delta_off_n = ov_w * moving_right(i_n, a.zigzag);
        const int row_len = a.h_k * nw;
        for (int e = tid; e < a.c_in * row_len; e += nthreads) {
          const int c = e / row_len;
          const int rem = e - c * row_len;
          const int r = rem / nw;
          const int cc = rem - r * nw;
          fetch_async(col_buf + e,
                      x + (static_cast<long long>(c) * a.h_in + h0_n + r)
                              * a.w_in + w0_n + delta_off_n + cc);
        }
      }
      fetch_commit();
    }

    patches_times_lambda<T>(win, lam, out, a.c_in, a.h_k, a.w_k, t_in, a.s_w,
                            a.t_run, a.n, a.h_out, w_out, i, jt * a.t_run);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* lam, void* out,
                   const PlannedArgs& a, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv2d_offload_planned_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int threads = ((a.t_run * a.n + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > 1024 ? 1024 : threads);
  conv2d_offload_planned_kernel<T><<<1, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lam),
      static_cast<T*>(out), a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory the one block allocates, in elements: Λ, the window, the
// column-delta buffer, the row-delta buffer.  kernels/emit.py's
// kernel_vmem_elements is this formula in Python.
extern "C" long long conv2d_offload_planned_smem_elements(
    int c_in, int n, int h_k, int w_k, int s_h, int s_w, int t_run) {
  const long long t_in = t_in_cols(t_run, s_w, w_k);
  const long long nw = static_cast<long long>(t_run) * s_w;
  const long long rb_rows = s_h < h_k ? s_h : h_k;
  return static_cast<long long>(c_in) * h_k * w_k * n   // Λ
         + static_cast<long long>(c_in) * h_k * t_in    // window
         + static_cast<long long>(c_in) * h_k * nw      // column delta
         + static_cast<long long>(c_in) * (rb_rows < 1 ? 1 : rb_rows) * t_in;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success); a launch that is refused never runs, and only this code
// says so.  Does not synchronise.
extern "C" int conv2d_offload_planned_launch(
    const void* x, const void* lam, void* out, int dtype, int c_in, int h_in,
    int w_in, int n, int h_k, int w_k, int s_h, int s_w, int t_run, int h_out,
    int tiles, int zigzag, int row_delta, int col_delta, void* stream) {
  PlannedArgs a{c_in, h_in, w_in, n, h_k, w_k, s_h, s_w, t_run, h_out, tiles,
                zigzag, row_delta, col_delta};
  const int dtype_bytes = dtype == 0 ? 4 : 2;
  const long long smem = dtype_bytes * conv2d_offload_planned_smem_elements(
                                           c_in, n, h_k, w_k, s_h, s_w, t_run);
  if (smem > REPRO_SMEM_LIMIT_BYTES) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, lam, out, a, static_cast<int>(smem), st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, lam, out, a, static_cast<int>(smem), st);
  return cudaErrorInvalidValue;
}
