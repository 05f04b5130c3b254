// Decode attention for one new token per sequence: grouped query heads
// resident, the KV cache streamed block by block with an online softmax.
//
// Replaces the Pallas TPU kernel `decode_attention` / `_decode_kernel` of
// src/repro/kernels/flash_decode.py; it is what `ops.decode_attention`
// launches, on every layer of every step of `transformer.decode_fn`.
//
// Mapping.  The TPU kernel runs one (G, D) query group against one (S, D)
// cache with the grid walking the S / bkv blocks in order and carrying
// m, l and acc from step to step; `ops.decode_attention` vmaps it over
// batch and KV heads.  Here one thread block takes one (b, kv_head): the
// batch and head loops go on the CUDA grid, and the ordered walk over the
// KV blocks is a loop inside the block, so the carry never leaves it.  The
// block reads its K and V rows straight from the cache's own
// (B, S, H_kv, D) layout through strides: nothing is transposed or copied
// per step.  Per block, in shared memory:
//
//   q    (G, D)    f32  the resident query group (the paper's Λ)
//   acc  (G, D)    f32  the running weighted sum of V
//   m, l, alpha (G) f32  running max, running sum, this block's rescale
//   p    (G, bkv)  f32  scores, then probabilities, of the current block
//   k, v (bkv, D+pad)   the current K and V block, in the cache's type
//
// (`flash_decode_smem_bytes` below; `core.planner.decode_smem_bytes` is the
// same formula).  Positions >= lengths[b] are masked to -1e30, as on the
// TPU, so an empty cache (length 0) gives the plain mean of V over the S
// rows.  For length >= 1 a block that lies wholly past the length changes
// nothing (its probabilities are exp(-1e30 - m) = 0 and its rescale is
// exp(0) = 1), so the loop stops at the length: the result is the same,
// bit for bit, and the blocks past it are never read.
//
// What bounds it on an H100: bytes.  Each cache row is read once, and a
// row of D values feeds 2*G multiply-adds per matrix, far below the
// ~295 operations per byte where the tensor cores would become the limit.
// At the serving shapes (B * H_kv = 16 blocks, S = 512) the whole cache of
// a layer is 2 MB, under a microsecond at 3.35 TB/s, so launch latency and
// the 16 blocks' serial walk bound it instead.  The design keeps every
// cache byte read once and the carry on chip; splitting S over more blocks
// (with a second combine kernel) to fill the other SMs is later work.
// The products run on the ordinary f32 units, not on the tensor cores.
#include "repro_common.cuh"

#define DECODE_THREADS 256

namespace {

// Row stride of the K and V blocks in shared memory: D plus 4 bytes, so
// that the threads of a warp, each on its own row, hit distinct banks.
__host__ __device__ inline int kv_row(int d, int kv_bytes) {
  return d + 4 / kv_bytes;
}

struct DecodeArgs {
  int s, h_kv, g, d, bkv;
  long long q_sb, q_sh;            // q strides (elements): batch, head
  long long kv_sb, kv_ss, kv_sh;   // cache strides: batch, position, head
  float scale;
};

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TQ, typename TKV>
__global__ void flash_decode_kernel(const TQ* __restrict__ q,
                                    const TKV* __restrict__ k,
                                    const TKV* __restrict__ v,
                                    const int* __restrict__ lengths,
                                    TQ* __restrict__ out, DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g_n = a.g, d_n = a.d, bkv = a.bkv;
  const int ld = kv_row(d_n, static_cast<int>(sizeof(TKV)));
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* acc = q_s + g_n * d_n;
  float* m_s = acc + g_n * d_n;
  float* l_s = m_s + g_n;
  float* alpha = l_s + g_n;
  float* p_s = alpha + g_n;
  TKV* k_s = reinterpret_cast<TKV*>(p_s + g_n * bkv);
  TKV* v_s = k_s + bkv * ld;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int length = lengths[b];

  // Λ: the G query rows of this KV head, resident for the whole walk.
  const TQ* q_b = q + b * a.q_sb;
  for (int e = tid; e < g_n * d_n; e += blockDim.x) {
    const int gi = e / d_n;
    const int di = e - gi * d_n;
    q_s[e] = to_f32(q_b[(kvh * g_n + gi) * a.q_sh + di]);
    acc[e] = 0.0f;
  }
  for (int gi = tid; gi < g_n; gi += blockDim.x) {
    m_s[gi] = -1e30f;
    l_s[gi] = 0.0f;
  }

  const long long kv_base = b * a.kv_sb + kvh * a.kv_sh;
  const int n_blocks = a.s / bkv;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int pos0 = blk * bkv;
    if (length >= 1 && pos0 >= length) break;   // changes nothing: see above
    __syncthreads();   // the previous block's readers are done with k, v, p
    // a4: this block's K and V rows (the patch group), read once each.
    for (int e = tid; e < bkv * d_n; e += blockDim.x) {
      const int j = e / d_n;
      const int di = e - j * d_n;
      const long long src = kv_base + (pos0 + j) * a.kv_ss + di;
      k_s[j * ld + di] = k[src];
      v_s[j * ld + di] = v[src];
    }
    __syncthreads();
    // scores s[g][j] = (q[g] . k[j]) * scale, masked past the length
    for (int e = tid; e < g_n * bkv; e += blockDim.x) {
      const int gi = e / bkv;
      const int j = e - gi * bkv;
      const float* qr = q_s + gi * d_n;
      const TKV* kr = k_s + j * ld;
      float s = 0.0f;
      for (int di = 0; di < d_n; ++di) s = fmaf(qr[di], to_f32(kr[di]), s);
      s *= a.scale;
      p_s[e] = (pos0 + j < length) ? s : -1e30f;
    }
    __syncthreads();
    // online softmax, one warp per query row
    for (int gi = warp; gi < g_n; gi += n_warps) {
      float* pr = p_s + gi * bkv;
      float mx = __int_as_float(0xff800000);   // -inf
      for (int j = lane; j < bkv; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < bkv; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float al = expf(m_prev - m_new);
        alpha[gi] = al;
        l_s[gi] = l_s[gi] * al + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ v
    for (int e = tid; e < g_n * d_n; e += blockDim.x) {
      const int gi = e / d_n;
      const int di = e - gi * d_n;
      const float* pr = p_s + gi * bkv;
      float sum = 0.0f;
      for (int j = 0; j < bkv; ++j) sum = fmaf(pr[j], to_f32(v_s[j * ld + di]), sum);
      acc[e] = acc[e] * alpha[gi] + sum;
    }
  }
  __syncthreads();
  // W: acc / l, written once
  TQ* o_b = out + b * a.q_sb;
  for (int e = tid; e < g_n * d_n; e += blockDim.x) {
    const int gi = e / d_n;
    const int di = e - gi * d_n;
    o_b[(kvh * g_n + gi) * a.q_sh + di] = from_f32<TQ>(acc[e] / l_s[gi]);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int batch,
                   const DecodeArgs& a, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<TQ, TKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.h_kv, batch);
  flash_decode_kernel<TQ, TKV><<<grid, DECODE_THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), lengths, static_cast<TQ*>(out), a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block allocates: q and acc (f32), m, l and alpha (f32),
// the scores of one block (f32), the K and V blocks (padded rows).
extern "C" long long flash_decode_smem_bytes(int g, int d, int bkv,
                                             int kv_bytes) {
  const long long f32 = 4LL * (2LL * g * d + 3LL * g + 1LL * g * bkv);
  return f32 + 2LL * bkv * kv_row(d, kv_bytes) * kv_bytes;
}

// q (B, H_q, D) and out (same shape and strides), k and v (B, S, H_kv, D)
// with the strides given, lengths (B,) int32 on the card.  q_dtype and
// kv_dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out,
                                   int q_dtype, int kv_dtype, int batch, int s,
                                   int h_kv, int g, int d, int bkv,
                                   long long q_sb, long long q_sh,
                                   long long kv_sb, long long kv_ss,
                                   long long kv_sh, float scale, void* stream) {
  if (bkv <= 0 || s % bkv != 0 || g <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  const int kv_bytes = kv_dtype == 0 ? 4 : 2;
  const long long smem = flash_decode_smem_bytes(g, d, bkv, kv_bytes);
  if (smem > REPRO_SMEM_LIMIT_BYTES) return cudaErrorInvalidValue;
  DecodeArgs a{s, h_kv, g, d, bkv, q_sb, q_sh, kv_sb, kv_ss, kv_sh, scale};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, len, out, batch, a, sm, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, len, out, batch, a, sm, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, len, out, batch, a, sm, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, len, out, batch, a,
                                                 sm, st);
  return cudaErrorInvalidValue;
}
