// Shared by the two S1 convolution kernels (conv2d_offload.cu,
// conv2d_offload_planned.cu): the grid geometry, the element conversions
// and the per-step product of patches with the kernel set Λ.
//
// The geometry mirrors kernels/conv2d_offload.py (t_in_cols, eff_tile,
// moving_right): Python stays the single source of the step structure,
// these are the same formulas evaluated on the card, in signed ints.
#pragma once

#include "repro_common.cuh"

__host__ __device__ inline int t_in_cols(int t_run, int s_w, int w_k) {
  return (t_run - 1) * s_w + w_k;
}

// Physical column tile of grid step (i, jt): zigzag reverses odd rows.
// (tiles - 1 - 2 * jt) goes negative: signed arithmetic on purpose.
__host__ __device__ inline int eff_tile(int i, int jt, int tiles, int zigzag) {
  if (!zigzag) return jt;
  return jt + (i % 2) * (tiles - 1 - 2 * jt);
}

// 1 when the within-row steps of row i advance left to right, else 0.
__host__ __device__ inline int moving_right(int i, int zigzag) {
  if (!zigzag) return 1;
  return (i % 2 == 0) ? 1 : 0;
}

// The step's product, without a materialised im2col.  For each (t, n) of
// the (t_run x N) output block, n fastest so that Λ (k_total x N, row
// major) is read along its contiguous axis:
//
//   out[n][i][col0 + t] = sum_{c,kh,kw} win[c][kh][t*s_w + kw]
//                                       * lam[(c*h_k + kh)*w_k + kw][n]
//
// Inputs are upcast to f32, the sum is f32, the store casts to T.  `win` is
// the (c_in, h_k, t_in) window in shared memory; `lam` may be in shared
// memory (planned kernel) or in device memory (simple kernel).  The store
// is strided: the block's (N, 1, t_run) piece of (N, h_out, w_out).
template <typename T>
__device__ inline void patches_times_lambda(
    const T* __restrict__ win, const T* __restrict__ lam, T* __restrict__ out,
    int c_in, int h_k, int w_k, int t_in, int s_w, int t_run, int n,
    int h_out, int w_out, int i, int col0) {
  const int row_len = h_k * t_in;
  for (int e = threadIdx.x; e < t_run * n; e += blockDim.x) {
    const int t = e / n;
    const int ch = e - t * n;
    const T* wbase = win + t * s_w;
    const T* lbase = lam + ch;
    float acc = 0.0f;
    int k = 0;
    for (int c = 0; c < c_in; ++c) {
      for (int kh = 0; kh < h_k; ++kh) {
        const T* wrow = wbase + c * row_len + kh * t_in;
        for (int kw = 0; kw < w_k; ++kw, ++k) {
          acc = fmaf(to_f32(wrow[kw]), to_f32(lbase[k * n]), acc);
        }
      }
    }
    out[(static_cast<long long>(ch) * h_out + i) * w_out + col0 + t] =
        from_f32<T>(acc);
  }
}
