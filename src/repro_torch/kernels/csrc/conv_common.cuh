// Shared by the two S1 convolution kernels (conv2d_offload.cu,
// conv2d_offload_planned.cu): the grid geometry and the element
// conversions.
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
