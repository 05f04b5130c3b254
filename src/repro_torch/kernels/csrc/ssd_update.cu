// The Mamba-2 recurrent update of one decode step, fused: one pass over a
// layer's state that decays it, adds dt x B^T, writes it back in place and
// reads it out through C.
//
// Replaces no TPU kernel: the JAX package writes the step in `jnp`
// (src/repro/models/ssm.py), and the port's plain version is
// `kernels/ssd_update.py::ssd_update_plain`, the operations of
// `models/ssm.py`'s step.  `ssm.ssd_decode` launches it once a layer a step
// on its un-meshed path.
//
// Function, in f32 for batch row b and head h of H, group g = h / (H / G):
//   dt    = softplus(dt_raw[b, h] + dt_bias[h])   (torch's threshold of 20)
//   dec   = exp(dt * -exp(a_log[h]))
//   h[p, n] <- dec * h[p, n] + (dt * x[p]) * B_g[n]
//   y[p]  = sum_n C_g[n] * h_new[p, n] + x[p] * D[h]   (stored in x's type)
// x (H * P), B and C (G * N each) are the conv's output row, side by side
// as `xbc` holds them: x, then B, then C.  Each product and the sum of the
// state are rounded as PyTorch rounds them (no contraction into an FMA);
// the read-out's sum over N is a shuffle tree, so its order is not
// cuBLAS's.
//
// What bounds it on an H100: bytes.  The state is (B, H, P, N) f32, read
// once and written once: 2 * B * H * P * N * 4 bytes, 234.9 MB a layer at
// Zamba2-7B (B 64, H 112, P 64, N 64), 70 us at 3.35 TB/s, against some 3
// operations an entry.  x, B, C, dt and y are a few KB a block.
//
// Design.  One block per (b, h): its P x N tile (16 KB at P 64, N 64) is
// contiguous.  N / 4 lanes share a row, each a 16-byte vector of it, so a
// warp covers 128 / N rows at a time; a thread holds SSD_ROWS rows of the
// tile at once.  Every thread issues all its 16-byte loads of a pass first
// (`__ldcs`: the state is touched once a step and outruns the 50 MB L2),
// then updates, stores (`__stcs`) and reduces its rows: some 16 KB a block
// in flight, several blocks on each SM.  Each element is read and written
// by the same thread, so the update in place needs no barrier and no
// shared memory.  The read-out over N is a shuffle reduction within the
// N / 4 lanes of a row, and the row's first lane stores y.  x, B, C and dt
// go through the read-only path.
#include "repro_common.cuh"

#define SSD_ROWS 4            // rows of the tile a thread holds at a time
#define SSD_MAX_THREADS 256
#define SSD_MIN_BLOCKS 4      // resident blocks an SM is compiled for

namespace {

struct SsdArgs {
  int heads, p, groups;       // H, P, G (G divides H)
  long long x_sb, dt_sb;      // batch strides of xbc and dt_raw (elements)
};

__device__ inline float ldg_f32(const float* p) { return __ldg(p); }
__device__ inline float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// torch.nn.functional.softplus with beta 1 and threshold 20.
__device__ inline float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

template <int N, typename T>
__global__ void __launch_bounds__(SSD_MAX_THREADS, SSD_MIN_BLOCKS)
ssd_update_kernel(float* __restrict__ h, const T* __restrict__ xbc,
                  const T* __restrict__ dt_raw,
                  const float* __restrict__ dt_bias,
                  const float* __restrict__ a_log,
                  const float* __restrict__ d_skip, T* __restrict__ y,
                  SsdArgs a) {
  constexpr int L = N / 4;                   // lanes that share a row
  const int tile = blockIdx.x;               // b * H + head
  const int b = tile / a.heads;
  const int head = tile - b * a.heads;
  const int g = head / (a.heads / a.groups);
  const int n0 = (threadIdx.x % L) * 4;
  const int row0 = threadIdx.x / L;
  const int rstep = blockDim.x / L;          // rows a block takes at a time

  const T* xrow = xbc + b * a.x_sb;
  const T* xs = xrow + static_cast<long long>(head) * a.p;
  const T* bs = xrow + static_cast<long long>(a.heads) * a.p + g * N;
  const T* cs = bs + a.groups * N;
  float* st = h + static_cast<long long>(tile) * a.p * N;
  T* yo = y + static_cast<long long>(tile) * a.p;

  const float dt = softplus(__fadd_rn(ldg_f32(dt_raw + b * a.dt_sb + head),
                                      __ldg(dt_bias + head)));
  const float dec = expf(__fmul_rn(dt, -expf(__ldg(a_log + head))));
  const float dsk = __ldg(d_skip + head);
  float bn[4], cn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bn[i] = ldg_f32(bs + n0 + i);
    cn[i] = ldg_f32(cs + n0 + i);
  }

  // The pass loop is the same for every thread of the block, so every lane
  // of a warp reaches each shuffle; a row past P reads and writes nothing
  // and reduces zeros.
  for (int pass = 0; pass < a.p; pass += SSD_ROWS * rstep) {
    float4 s[SSD_ROWS];
#pragma unroll
    for (int r = 0; r < SSD_ROWS; ++r) {
      const int row = pass + r * rstep + row0;
      if (row < a.p)
        s[r] = __ldcs(reinterpret_cast<const float4*>(st + row * N + n0));
    }
#pragma unroll
    for (int r = 0; r < SSD_ROWS; ++r) {
      const int row = pass + r * rstep + row0;
      const bool in = row < a.p;
      float part = 0.0f, x = 0.0f;
      if (in) {
        x = ldg_f32(xs + row);
        const float dtx = __fmul_rn(dt, x);
        float4 v = s[r];
        v.x = __fadd_rn(__fmul_rn(v.x, dec), __fmul_rn(dtx, bn[0]));
        v.y = __fadd_rn(__fmul_rn(v.y, dec), __fmul_rn(dtx, bn[1]));
        v.z = __fadd_rn(__fmul_rn(v.z, dec), __fmul_rn(dtx, bn[2]));
        v.w = __fadd_rn(__fmul_rn(v.w, dec), __fmul_rn(dtx, bn[3]));
        __stcs(reinterpret_cast<float4*>(st + row * N + n0), v);
        part = fmaf(cn[0], v.x, fmaf(cn[1], v.y,
                    fmaf(cn[2], v.z, __fmul_rn(cn[3], v.w))));
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (in && n0 == 0)
        yo[row] = from_f32<T>(__fadd_rn(part, __fmul_rn(x, dsk)));
    }
  }
}

// Threads of a block: enough for SSD_ROWS rows each to cover the tile in
// one pass, in whole warps, at most SSD_MAX_THREADS (more passes then).
int block_threads(int p, int n) {
  const int need = p * (n / 4) / SSD_ROWS;
  const int warps = (need + 31) / 32;
  const int t = 32 * (warps < 1 ? 1 : warps);
  return t < SSD_MAX_THREADS ? t : SSD_MAX_THREADS;
}

template <int N, typename T>
cudaError_t launch(void* h, const void* xbc, const void* dt_raw,
                   const float* dt_bias, const float* a_log,
                   const float* d_skip, void* y, int batch, const SsdArgs& a,
                   cudaStream_t stream) {
  const long long tiles = static_cast<long long>(batch) * a.heads;
  ssd_update_kernel<N, T><<<static_cast<unsigned>(tiles),
                            block_threads(a.p, N), 0, stream>>>(
      static_cast<float*>(h), static_cast<const T*>(xbc),
      static_cast<const T*>(dt_raw), dt_bias, a_log, d_skip,
      static_cast<T*>(y), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(int n, void* h, const void* xbc, const void* dt_raw,
                     const float* dt_bias, const float* a_log,
                     const float* d_skip, void* y, int batch,
                     const SsdArgs& a, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<16, T>(h, xbc, dt_raw, dt_bias, a_log, d_skip, y, batch,
                           a, stream);
    case 32:
      return launch<32, T>(h, xbc, dt_raw, dt_bias, a_log, d_skip, y, batch,
                           a, stream);
    case 64:
      return launch<64, T>(h, xbc, dt_raw, dt_bias, a_log, d_skip, y, batch,
                           a, stream);
    case 128:
      return launch<128, T>(h, xbc, dt_raw, dt_bias, a_log, d_skip, y, batch,
                            a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// h (B, H, P, N) f32, contiguous, 16-byte aligned, updated in place;
// xbc (B, H * P + 2 * G * N) and dt_raw (B, H), each with its batch stride
// and the last dim contiguous, of x_dtype (0 = float32, 1 = bfloat16);
// dt_bias, a_log, d_skip (H,) f32; y (B, H * P) of x_dtype, contiguous.
// Takes N of 16, 32, 64 or 128 and G dividing H.  Returns the cudaError_t
// of the launch (0 on success); does not synchronise.
extern "C" int ssd_update_launch(void* h, const void* xbc, const void* dt_raw,
                                 const void* dt_bias, const void* a_log,
                                 const void* d_skip, void* y, int x_dtype,
                                 int batch, int heads, int p, int n,
                                 int groups, long long x_sb, long long dt_sb,
                                 void* stream) {
  if (batch < 1 || heads < 1 || p < 1 || groups < 1 || heads % groups != 0
      || static_cast<long long>(batch) * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const SsdArgs a{heads, p, groups, x_sb, dt_sb};
  const float* bias = static_cast<const float*>(dt_bias);
  const float* al = static_cast<const float*>(a_log);
  const float* ds = static_cast<const float*>(d_skip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_n<float>(n, h, xbc, dt_raw, bias, al, ds, y, batch, a, st);
  if (x_dtype == 1)
    return launch_n<__nv_bfloat16>(n, h, xbc, dt_raw, bias, al, ds, y, batch,
                                   a, st);
  return cudaErrorInvalidValue;
}
