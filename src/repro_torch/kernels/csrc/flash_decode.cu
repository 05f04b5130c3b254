// Decode attention for one new token per sequence: the KV cache split over
// thread blocks, each streaming its range of rows with an online softmax,
// and a second kernel that combines the ranges.
//
// Replaces the Pallas TPU kernel `decode_attention` / `_decode_kernel` of
// src/repro/kernels/flash_decode.py; the pair is what `ops.decode_attention`
// launches, on every layer of every step of `transformer.decode_fn`.
//
// Function (the TPU kernel's, unchanged): for one (b, kv_head) the G query
// rows attend to the cache's S rows; scores are (q . k) * D**-0.5,
// positions >= lengths[b] are masked to -1e30 (not -inf, so an empty cache
// gives the mean of v over the S rows); the running max m, sum l and
// weighted sum acc are f32; acc / l is cast to q's type once.
//
// Mapping.  The TPU kernel walks the S / bkv blocks of one (b, kv_head) in
// order on one core, carrying (m, l, acc).  On an H100 that walk would hold
// one SM per (b, kv_head): 16 of 132 at the serving shape.  So the walk is
// cut into `splits` contiguous ranges of S / splits rows (a multiple of
// bkv), one thread block each, on a grid of (splits, H_kv, B):
//
//   * flash_decode_split_kernel: the block keeps its G query rows in
//     registers (each lane the VEC elements it multiplies; with G > 8 the
//     rows go to ceil(G / 8) blocks of at most 8, on grid.y beside the KV
//     head, and each of them reads the range) and streams its
//     range in KV blocks of bkv rows, each copied as two stages of bkv / 2
//     rows into a two-slot ring.  Each warp owns a quarter of every
//     stage's rows and copies them itself, 16 bytes per `cp.async`, into
//     its own slots in shared memory: the next stage's copies are in
//     flight while this one is computed, and only __syncwarp orders the
//     ring, with no block barrier.  Within a warp, D / VEC lanes rounded
//     up to a power of two share a row (VEC = 16 bytes of the cache's type
//     each; the lanes past D hold zeros), so a warp takes 32 / that many
//     rows at a time; the lanes of a row reduce its G scores
//     with shuffles and each keeps its own (m, l, acc) slice.  At the end of
//     the range the warp's row groups merge by shuffles, the four warps
//     merge once through shared memory (one block barrier), and the block
//     writes a partial (acc, m, l) in f32 to the workspace
//     (B, H_kv, splits, G, D + 2).  With one split and no workspace it
//     writes acc / l instead, and no combine runs.  A workspace given
//     with one split gets that split's partial: a cache whose sequence
//     lies on several cards is walked shard by shard, and the combine
//     takes the shards' partials gathered side by side.
//   * flash_decode_combine_kernel: one block per (b, kv_head), a warp per
//     query row (up to 8 warps, each taking every 8th row beyond): M = max
//     over splits of m, weights exp(m_s - M), and
//     sum(w acc) / sum(w l) cast to q's type, the splits summed in order.
//
// Rows past the length: for length >= 1 a range reads only its rows below
// the length (the rows past it would get exp(-1e30 - m) = 0 and change
// nothing), and a range that lies wholly past the length reads nothing and
// writes the partial (acc, m, l) = (0, -1e30, 0), which the combine gives
// zero weight.  For length == 0 every range reads all its rows, whose
// scores are all -1e30, so every p is 1 and the pair gives the mean of v.
//
// What bounds it on an H100: bytes.  Each cache row is read once and feeds
// 2 * G multiply-adds per matrix, far below the ~295 operations per byte
// where the tensor cores would become the limit.  At the serving shape
// (B = 4, H_kv = 4, D = 64, G = 8, bf16, S = 512) a call must move the
// cache's 2 MiB and little else: 0.000636 ms at 3.35 TB/s.  One SM's share
// of that bandwidth, 3.35 TB/s / 132, takes 16 KiB (one block's range at
// 8 splits) in about 0.6 us, which is the floor of one block's walk; the
// launch of two kernels costs more than either bound.  The design fills
// the SMs (8 splits x 16 = 128 blocks at the serving shape, chosen by
// core.planner.plan_decode_split), keeps every cache byte read once with
// 16-byte copies, and keeps the carry in registers.  The products run on
// the ordinary f32 units, not on the tensor cores.
#include "repro_common.cuh"

#define DECODE_WARPS 4
#define DECODE_THREADS (32 * DECODE_WARPS)
#define DECODE_STAGES 2
#define DECODE_MAX_G 8   // query rows one block of the split kernel holds
#define DECODE_MASKED (-1e30f)

namespace {

struct DecodeArgs {
  int s, h_kv, g, d, bkv, splits;
  int groups;                      // blocks sharing one (b, kv_head)'s G rows
  int lpr;                         // lanes per row: a power of two
  long long q_sb, q_sh;            // q and out strides (elements): batch, head
  long long kv_sb, kv_ss, kv_sh;   // cache strides: batch, position, head
  float scale;
};

// VEC elements of a 16-byte vector in shared memory, as f32.
__device__ inline void load_vec(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

__device__ inline void load_vec(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// GM: the block's query rows, at most DECODE_MAX_G, rounded up to a power
// of two (the register arrays' size); the rows gi >= g_n of the arrays
// hold zeros or unused values and are never written.
template <typename TQ, typename TKV, int GM>
__global__ void __launch_bounds__(DECODE_THREADS)
flash_decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                          const TKV* __restrict__ v,
                          const int* __restrict__ lengths,
                          TQ* __restrict__ out, float* __restrict__ part,
                          DecodeArgs a) {
  constexpr int VEC = 16 / sizeof(TKV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d_n = a.d, bkv = a.bkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lpr = a.lpr;
  const int lpr_shift = __ffs(lpr) - 1;
  const int rpp = 32 >> lpr_shift;           // rows a warp takes at a time
  const int grp = lane >> lpr_shift;
  const int d0 = (lane & (lpr - 1)) * VEC;
  const bool active = d0 < d_n;              // the lane holds part of D
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / a.groups;
  const int g0 = (blockIdx.y - kvh * a.groups) * DECODE_MAX_G;
  const int g_n = min(DECODE_MAX_G, a.g - g0);   // this block's query rows
  const int length = lengths[b];
  const int range = a.s / a.splits;
  const int row0 = split * range;
  const int end = (length >= 1 && length < row0 + range) ? length
                                                          : row0 + range;
  const int stage = bkv / DECODE_STAGES;     // rows of one ring slot
  const int steps = end > row0 ? (end - row0 + stage - 1) / stage : 0;
  const int rpw = stage / DECODE_WARPS;      // rows of a slot a warp owns
  TKV* ring = reinterpret_cast<TKV*>(smem_raw)
              + warp * (DECODE_STAGES * 2 * rpw * d_n);
  float* merge = reinterpret_cast<float*>(
      smem_raw + static_cast<size_t>(2) * bkv * d_n * sizeof(TKV));

  // The G query rows (the paper's resident Λ), pre-scaled, in registers.
  float qr[GM][VEC];
  const TQ* q_b = q + b * a.q_sb
                  + (static_cast<long long>(kvh) * a.g + g0) * a.q_sh;
#pragma unroll
  for (int gi = 0; gi < GM; ++gi)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[gi][e] = gi < g_n && active
                      ? to_f32(q_b[gi * a.q_sh + d0 + e]) * a.scale : 0.0f;
  float m[GM], l[GM], acc[GM][VEC];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    m[gi] = DECODE_MASKED;
    l[gi] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[gi][e] = 0.0f;
  }

  const long long kv_base = b * a.kv_sb + kvh * a.kv_sh;
  // a4: this warp's rows of stage st (those below `end`), K and V, into
  // ring slot st % 2, one commit group per stage.
  auto fetch = [&](int st) {
    const int first = row0 + st * stage + warp * rpw;
    const int rows = min(rpw, end - first);
    TKV* ks = ring + (st & 1) * 2 * rpw * d_n;
    TKV* vs = ks + rpw * d_n;
    for (int c = lane; c < rows * lpr; c += 32) {
      const int r = c >> lpr_shift;
      const int col = (c & (lpr - 1)) * VEC;
      if (col >= d_n) continue;
      const long long src = kv_base + (first + r) * a.kv_ss + col;
      repro_cp_async16(ks + r * d_n + col, k + src);
      repro_cp_async16(vs + r * d_n + col, v + src);
    }
    repro_cp_async_commit();
  };

  if (steps > 0) fetch(0);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) fetch(st + 1);   // its slot was last read at st - 1
    else repro_cp_async_commit();        // an empty group keeps the count
    repro_cp_async_wait<1>();            // stage st has landed ...
    __syncwarp();                        // ... for every lane of the warp
    const int first = row0 + st * stage + warp * rpw;
    const int rows = min(rpw, end - first);
    const TKV* ks = ring + (st & 1) * 2 * rpw * d_n;
    const TKV* vs = ks + rpw * d_n;
    for (int r0 = 0; r0 < rows; r0 += rpp) {   // warp-uniform trip count
      const int r = r0 + grp;
      const bool valid = r < rows;
      float kf[VEC], vf[VEC];
      if (valid && active) {
        load_vec(ks + r * d_n + d0, kf);
        load_vec(vs + r * d_n + d0, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.0f;
      }
      float sc[GM];
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        float t = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) t = fmaf(qr[gi][e], kf[e], t);
        sc[gi] = t;
      }
      for (int o = 1; o < lpr; o <<= 1)
#pragma unroll
        for (int gi = 0; gi < GM; ++gi)
          sc[gi] += __shfl_xor_sync(0xffffffffu, sc[gi], o);
      if (valid) {
        const bool in = first + r < length;
#pragma unroll
        for (int gi = 0; gi < GM; ++gi) {
          const float s = in ? sc[gi] : DECODE_MASKED;
          const float m_new = fmaxf(m[gi], s);
          const float al = __expf(m[gi] - m_new);
          const float p = __expf(s - m_new);
          l[gi] = fmaf(l[gi], al, p);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[gi][e] = fmaf(acc[gi][e], al, p * vf[e]);
          m[gi] = m_new;
        }
      }
    }
    __syncwarp();                        // slot st % 2 may be refilled
  }

  // The warp's row groups merge, in a fixed order, by shuffles.
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], o);
      const float mn = fmaxf(m[gi], mo);
      const float a1 = __expf(m[gi] - mn), a2 = __expf(mo - mn);
      l[gi] = l[gi] * a1 + lo * a2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][e], o);
        acc[gi][e] = acc[gi][e] * a1 + ao * a2;
      }
      m[gi] = mn;
    }
  }
  // The warps merge once, through shared memory: [warp][g][acc | m | l].
  if (grp == 0 && active) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi >= g_n) break;
      float* row = merge + (warp * g_n + gi) * (d_n + 2);
#pragma unroll
      for (int e = 0; e < VEC; ++e) row[d0 + e] = acc[gi][e];
      if (lane == 0) {
        row[d_n] = m[gi];
        row[d_n + 1] = l[gi];
      }
    }
  }
  __syncthreads();
  const int pitch = g_n * (d_n + 2);
  for (int e = threadIdx.x; e < g_n * d_n; e += DECODE_THREADS) {
    const int gi = e / d_n;
    const int di = e - gi * d_n;
    const float* row = merge + gi * (d_n + 2);
    float mx = row[d_n];
    for (int w = 1; w < DECODE_WARPS; ++w)
      mx = fmaxf(mx, row[w * pitch + d_n]);
    float sum_l = 0.0f, sum_a = 0.0f;
    for (int w = 0; w < DECODE_WARPS; ++w) {
      const float wt = __expf(row[w * pitch + d_n] - mx);
      sum_l = fmaf(row[w * pitch + d_n + 1], wt, sum_l);
      sum_a = fmaf(row[w * pitch + di], wt, sum_a);
    }
    if (part == nullptr) {   // the whole walk: W, acc / l written once
      out[b * a.q_sb + (static_cast<long long>(kvh) * a.g + g0 + gi) * a.q_sh
          + di] = from_f32<TQ>(sum_a / sum_l);
    } else {
      float* p = part + ((static_cast<long long>(b * a.h_kv + kvh) * a.splits
                          + split) * a.g + g0 + gi) * (d_n + 2);
      p[di] = sum_a;
      if (di == 0) {
        p[d_n] = mx;
        p[d_n + 1] = sum_l;
      }
    }
  }
}

struct CombineArgs {
  int h_kv, g, d, splits;
  long long q_sb, q_sh;
};

// One block per (kv_head, b), a warp per query row (blockDim.x / 32 warps,
// each stepping over the rows by that many); splits summed in order, so
// the result does not depend on the schedule.
template <typename TQ>
__global__ void flash_decode_combine_kernel(const float* __restrict__ part,
                                            TQ* __restrict__ out,
                                            CombineArgs c) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int pitch = c.g * (c.d + 2);
  for (int gi = threadIdx.x >> 5; gi < c.g; gi += blockDim.x >> 5) {
    const float* p = part + static_cast<long long>(b * c.h_kv + kvh)
                                * c.splits * pitch + gi * (c.d + 2);
    float mx = p[c.d];
    for (int s = 1; s < c.splits; ++s) mx = fmaxf(mx, p[s * pitch + c.d]);
    float sum_l = 0.0f;
    for (int s = 0; s < c.splits; ++s)
      sum_l = fmaf(p[s * pitch + c.d + 1], expf(p[s * pitch + c.d] - mx),
                   sum_l);
    TQ* o = out + b * c.q_sb
            + (static_cast<long long>(kvh) * c.g + gi) * c.q_sh;
    for (int di = lane; di < c.d; di += 32) {
      float sum_a = 0.0f;
      for (int s = 0; s < c.splits; ++s)
        sum_a = fmaf(p[s * pitch + di], expf(p[s * pitch + c.d] - mx), sum_a);
      o[di] = from_f32<TQ>(sum_a / sum_l);
    }
  }
}

template <typename TQ, typename TKV, int GM>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* lengths, void* out, float* part,
                         int batch, const DecodeArgs& a, int smem,
                         cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_split_kernel<TQ, TKV, GM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.splits, a.h_kv * a.groups, batch);
  flash_decode_split_kernel<TQ, TKV, GM><<<grid, DECODE_THREADS, smem,
                                           stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), lengths, static_cast<TQ*>(out), part, a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_split_g(const void* q, const void* k, const void* v,
                           const int* lengths, void* out, float* part,
                           int batch, const DecodeArgs& a, int smem,
                           cudaStream_t stream) {
  const int rows = a.groups > 1 ? DECODE_MAX_G : a.g;
  if (rows <= 1)
    return launch_split<TQ, TKV, 1>(q, k, v, lengths, out, part, batch, a,
                                    smem, stream);
  if (rows <= 2)
    return launch_split<TQ, TKV, 2>(q, k, v, lengths, out, part, batch, a,
                                    smem, stream);
  if (rows <= 4)
    return launch_split<TQ, TKV, 4>(q, k, v, lengths, out, part, batch, a,
                                    smem, stream);
  return launch_split<TQ, TKV, 8>(q, k, v, lengths, out, part, batch, a,
                                  smem, stream);
}

}  // namespace

// Shared memory one block of the split kernel allocates: the ring of K and
// V, two slots of bkv / 2 rows each (one KV block), every warp its quarter
// of each slot, unpadded (a quarter-warp's 16-byte loads cover one
// 128-byte span), and the warps' merge buffer, (min(G, 8), D + 2) f32 per
// warp.
extern "C" long long flash_decode_smem_bytes(int g, int d, int bkv,
                                             int kv_bytes) {
  return 2LL * bkv * d * kv_bytes
         + 4LL * DECODE_WARPS * (g < DECODE_MAX_G ? g : DECODE_MAX_G)
               * (d + 2);
}

// Lanes that share one cache row: D / (16 bytes of the cache's type)
// rounded up to a power of two.
static int lanes_per_row(int d, int kv_bytes) {
  const int vec = 16 / kv_bytes;
  int lpr = 1;
  while (lpr * vec < d) lpr *= 2;
  return lpr;
}

// What the split kernel takes: bkv a multiple of 16, S = splits * (a
// multiple of bkv), G >= 1, and D a multiple of 16 bytes of the cache's
// type, at most 32 of them (bf16 D <= 256, f32 D <= 128).  Returns 0 when
// it takes the shape.
extern "C" int flash_decode_shape_ok(int s, int g, int d, int bkv,
                                     int splits, int kv_bytes) {
  const int vec = 16 / kv_bytes;
  return bkv > 0 && bkv % 16 == 0 && splits > 0 && s % (bkv * splits) == 0
         && g >= 1 && d >= vec && d % vec == 0 && d <= 32 * vec ? 0 : 1;
}

// q (B, H_q, D) and out (same shape and strides), k and v (B, S, H_kv, D)
// with the strides given (16-byte aligned rows), lengths (B,) int32 and
// part (B, H_kv, splits, G, D + 2) f32 on the card or null.  With part
// null (one split only) the kernel writes acc / l to out; otherwise it
// writes every split's partial to part and does not write out (the
// combine does).  q_dtype and kv_dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
extern "C" int flash_decode_split_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part, int q_dtype, int kv_dtype, int batch, int s,
    int h_kv, int g, int d, int bkv, int splits, long long q_sb,
    long long q_sh, long long kv_sb, long long kv_ss, long long kv_sh,
    float scale, void* stream) {
  const int kv_bytes = kv_dtype == 0 ? 4 : 2;
  if (flash_decode_shape_ok(s, g, d, bkv, splits, kv_bytes) != 0
      || (part == nullptr && splits != 1))
    return cudaErrorInvalidValue;
  const long long smem = flash_decode_smem_bytes(g, d, bkv, kv_bytes);
  if (smem > REPRO_SMEM_LIMIT_BYTES) return cudaErrorInvalidValue;
  DecodeArgs a{s, h_kv, g, d, bkv, splits,
               (g + DECODE_MAX_G - 1) / DECODE_MAX_G,
               lanes_per_row(d, kv_bytes), q_sb, q_sh, kv_sb, kv_ss, kv_sh,
               scale};
  const int* len = static_cast<const int*>(lengths);
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_split_g<float, float>(q, k, v, len, out, p, batch, a, sm,
                                        st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_split_g<float, __nv_bfloat16>(q, k, v, len, out, p, batch,
                                                a, sm, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_split_g<__nv_bfloat16, float>(q, k, v, len, out, p, batch,
                                                a, sm, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_split_g<__nv_bfloat16, __nv_bfloat16>(q, k, v, len, out, p,
                                                        batch, a, sm, st);
  return cudaErrorInvalidValue;
}

// part (B, H_kv, splits, G, D + 2) f32, out (B, H_q, D) of q_dtype with
// strides q_sb, q_sh.  Returns the cudaError_t of the launch.
extern "C" int flash_decode_combine_launch(const void* part, void* out,
                                           int q_dtype, int batch, int h_kv,
                                           int g, int d, int splits,
                                           long long q_sb, long long q_sh,
                                           void* stream) {
  if (g < 1 || d < 1 || splits < 1) return cudaErrorInvalidValue;
  CombineArgs c{h_kv, g, d, splits, q_sb, q_sh};
  const dim3 grid(h_kv, batch);
  const int threads = 32 * (g < DECODE_MAX_G ? g : DECODE_MAX_G);
  const float* p = static_cast<const float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    flash_decode_combine_kernel<float><<<grid, threads, 0, st>>>(
        p, static_cast<float*>(out), c);
  else if (q_dtype == 1)
    flash_decode_combine_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        p, static_cast<__nv_bfloat16*>(out), c);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
