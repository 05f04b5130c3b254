// S1 convolution, simple kernel: every grid step fetches its full window.
//
// Replaces the Pallas TPU kernel `conv2d_offload` / `_conv_kernel` (with
// the shared `_im2col_dot`) of src/repro/kernels/conv2d_offload.py; it is
// what `ops.conv2d` launches.
//
// Mapping.  The TPU kernel carries nothing from one grid step to the next,
// so nothing forces its steps into one block: one thread block per grid
// step (i, jt).  The block loads its (C_in, H_K, t_in) input window into
// shared memory (the step's I_slice, action a4), reads the kernel set Λ,
// laid out (C_in*H_K*W_K, N), through L2, computes the (t_run x N) product
// in f32 and stores the (N, 1, t_run) output block.  Zigzag only decides
// which block writes which tile (`eff_tile`), as the reference's output
// index map does.
//
// WARNING, as in the reference: neighbouring steps re-fetch the w_k - s_w
// columns and h_k - s_h rows their windows share, so this kernel's traffic
// is NOT the plan's Def-3 I_slice accounting.  conv2d_offload_planned.cu
// is the kernel whose fetches are the plan's.
//
// What bounds it on an H100: at the layer sizes of the conv networks here
// (at most a few hundred KB in, a few MFLOP) both the bytes moved and the
// operations take well under a microsecond at the card's peak rates, so a
// launch's latency and the depth of the per-thread sum bound it.  The
// design answers with one block per step, so that the steps of a layer
// spread over the SMs.  The product runs on the ordinary f32 units (fmaf),
// not on the tensor cores: a simple kernel that is right comes first.
#include "conv_common.cuh"

namespace {

struct ConvArgs {
  int c_in, h_in, w_in, n, h_k, w_k, s_h, s_w, t_run, h_out, tiles, zigzag;
};

template <typename T>
__global__ void conv2d_offload_kernel(const T* __restrict__ x,
                                      const T* __restrict__ lam,
                                      T* __restrict__ out, ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);

  const int i = blockIdx.y;
  const int jt = eff_tile(i, static_cast<int>(blockIdx.x), a.tiles, a.zigzag);
  const int t_in = t_in_cols(a.t_run, a.s_w, a.w_k);
  const int h0 = i * a.s_h;
  const int w0 = jt * a.t_run * a.s_w;

  // a4: the full (C_in, H_K, t_in) window, waited on before the product.
  const int row_len = a.h_k * t_in;
  for (int e = threadIdx.x; e < a.c_in * row_len; e += blockDim.x) {
    const int c = e / row_len;
    const int rem = e - c * row_len;
    const int r = rem / t_in;
    const int col = rem - r * t_in;
    win[e] = x[(static_cast<long long>(c) * a.h_in + h0 + r) * a.w_in
               + w0 + col];
  }
  __syncthreads();

  patches_times_lambda<T>(win, lam, out, a.c_in, a.h_k, a.w_k, t_in, a.s_w,
                          a.t_run, a.n, a.h_out, a.tiles * a.t_run, i,
                          jt * a.t_run);
}

template <typename T>
cudaError_t launch(const void* x, const void* lam, void* out,
                   const ConvArgs& a, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv2d_offload_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int threads = ((a.t_run * a.n + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > 1024 ? 1024 : threads);
  dim3 grid(a.tiles, a.h_out);
  conv2d_offload_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lam),
      static_cast<T*>(out), a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block allocates: the window, nothing else.
extern "C" long long conv2d_offload_smem_bytes(int c_in, int h_k, int w_k,
                                               int s_w, int t_run,
                                               int dtype_bytes) {
  return static_cast<long long>(c_in) * h_k * t_in_cols(t_run, s_w, w_k)
         * dtype_bytes;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success); a launch that is refused never runs, and only this code
// says so.  Does not synchronise.
extern "C" int conv2d_offload_launch(const void* x, const void* lam, void* out,
                                     int dtype, int c_in, int h_in, int w_in,
                                     int n, int h_k, int w_k, int s_h, int s_w,
                                     int t_run, int h_out, int tiles,
                                     int zigzag, void* stream) {
  ConvArgs a{c_in, h_in, w_in, n, h_k, w_k, s_h, s_w, t_run, h_out, tiles,
             zigzag};
  const int dtype_bytes = dtype == 0 ? 4 : 2;
  const long long smem =
      conv2d_offload_smem_bytes(c_in, h_k, w_k, s_w, t_run, dtype_bytes);
  if (smem > REPRO_SMEM_LIMIT_BYTES) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, lam, out, a, static_cast<int>(smem), st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, lam, out, a, static_cast<int>(smem), st);
  return cudaErrorInvalidValue;
}
