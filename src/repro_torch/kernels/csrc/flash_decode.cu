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
// one SM per (b, kv_head), so it is cut into `splits` contiguous ranges of
// S / splits rows (a multiple of bkv, the cache's padding grain), one
// thread block each, on a grid of (splits, H_kv * ceil(G / 8), B): a block
// holds at most 8 query rows, and more go to further blocks that each read
// the range.
//
//   * flash_decode_split_kernel: the block's range is cut into tiles of
//     `tile` rows, and its `warps` warps take them in turn (warp w the
//     tiles w, w + warps, ...).  Each warp streams its tiles through a
//     ring of its own, `stages` slots of K and V, copied 16 bytes a
//     `cp.async` with stages - 1 tiles in flight while one is computed;
//     only __syncwarp orders a ring.  Rows are stored with their 16-byte
//     chunks swizzled (chunk c of row r at c ^ (r & 7) when a row holds a
//     multiple of 8 chunks), so the 8 rows an `ldmatrix` reads lie in
//     distinct banks.  A tile is one softmax update:
//       1. scores.  Tensor cores where they keep the bits of the function:
//          a bf16 q against a bf16 cache, G >= 2, D a multiple of 16 and
//          tiles of 8 rows: `mma.sync.m16n8k16` with the block's query
//          rows (padded to 16) as A in registers and 8 cache rows as B,
//          both through `ldmatrix`, f32 sums, then times the scale, as the
//          reference scales its f32 scores.  Otherwise on the CUDA cores:
//          D / 16 bytes lanes share a row (rounded up to a power of two),
//          each holding its slice of the pre-scaled query rows in f32,
//          and reduce the row's G partial dots by shuffles.  The tile's
//          (row, query row) scores go to a per-warp buffer in shared
//          memory.
//       2. softmax.  Lane l keeps (m, a share of l) of query row l % G'
//          (G' = G rounded up to a power of two, at most 8); the lanes of
//          one query row take the tile's max, each exp is computed once
//          for each (row, query row), and the probabilities p (f32)
//          replace the scores in the buffer.
//       3. p v.  acc is rescaled once for the tile; the lanes that share a
//          row hold 8 or 16 bytes of it (D / 32 elements or more, for
//          every query row) and add p * v in f32 on the CUDA cores, p read
//          by broadcast from the buffer.
//     At the end of the range the warp's row groups sum their acc (one m
//     a query row in the warp), the warps merge once through shared
//     memory (the ring's space, one block barrier), and the block writes
//     a partial (acc, m, l) in f32 to the workspace (B, H_kv, splits, G,
//     D + 2).  With one split and no workspace it writes acc / l instead,
//     and no combine runs.  A workspace given with one split gets that
//     split's partial: a cache whose sequence lies on several cards is
//     walked shard by shard, and the combine takes the shards' partials
//     gathered side by side.
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
// What bounds it on an H100: bytes, and the SM's issue slots on the way to
// them.  Each cache row is read once and feeds 2 * G multiply-adds per
// matrix, far below the ~295 operations per byte where the tensor cores
// would bound it; but a walk that spends some 250 warp instructions on
// two rows (the softmax of each row recomputed by every lane of it) with
// four warps an SM reached a quarter of the byte bound.  The ring is sized
// by residency (core.planner.decode_ring): within the registers the
// launch bounds leave a thread (128 at G > 2, 80 below), as many warps an
// SM as fit, 16 at D 128 and G 7, 24 at D 224 and G 1, each with one or
// two tiles in flight; and the scores' half of the products on the tensor
// cores at G >= 2 leaves p v's f32 multiply-adds as the work that remains
// on the CUDA cores.  Measured on an H100 at 700 W, bf16: the pair moves
// 76.6 % of the byte bound's rate at G 7, D 128 over 8320 rows (B 32,
// 4 KV heads: one wave of 512 blocks on the 528 resident; its ragged end
// and the combine are the rest), 82.8 % at G 1, D 224 over 640 (B 64, 32
// KV heads: 2048 blocks in 2.6 waves), and 35.8 % at G 7 over 640, where
// a launch's start and the ranges' ends outweigh 6 tiles a warp.
#include <type_traits>

#include "repro_common.cuh"

#define DECODE_MAX_WARPS 8
#define DECODE_MAX_G 8        // query rows one block of the split kernel holds
#define DECODE_MASKED (-1e30f)
#define DECODE_FULL 0xffffffffu

namespace {

struct DecodeArgs {
  int s, h_kv, g, d, splits;
  int groups;                      // blocks sharing one (b, kv_head)'s G rows
  int tile, stages;                // rows of a ring slot, slots of a ring
  int lpr;                         // lanes a row of 16-byte chunks: a power of 2
  int plpr;                        // lanes a row in p v: a power of two
  long long q_sb, q_sh;            // q and out strides (elements): batch, head
  long long kv_sb, kv_ss, kv_sh;   // cache strides: batch, position, head
  float scale;
};

// 8 or 16 bytes of the cache's type in shared memory, as f32.
__device__ inline void load_f32(const float* p, float (&o)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  o[0] = t.x; o[1] = t.y;
}

__device__ inline void load_f32(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

template <int N>
__device__ inline void bf16_to_f32(const __nv_bfloat162* h, float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ inline void load_f32(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  bf16_to_f32(reinterpret_cast<const __nv_bfloat162*>(&t), o);
}

__device__ inline void load_f32(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  bf16_to_f32(reinterpret_cast<const __nv_bfloat162*>(&t), o);
}

// One tile row's probabilities for the block's query rows (GM f32, on
// GM * 4 bytes).
template <int GM>
__device__ inline void load_p(const float* p, float (&o)[GM]) {
  if constexpr (GM == 1) {
    o[0] = p[0];
  } else if constexpr (GM == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < GM / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = t.x; o[4 * i + 1] = t.y;
      o[4 * i + 2] = t.z; o[4 * i + 3] = t.w;
    }
  }
}

__device__ inline unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ inline void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

// c += A (16 x 16, row; rows 8-15 zero) * B (16 x 8, col), bf16 in, f32
// sums: a0 holds A[g][2j, 2j + 1] and a2 A[g][8 + 2j, 9 + 2j] of lane
// 4g + j, b0 and b1 the halves of B's k from ldmatrix.
__device__ inline void mma_bf16(float (&c)[4], unsigned a0, unsigned a2,
                                unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// Wait until at most `pending` (1-3) of this thread's copy groups are in
// flight.
__device__ inline void wait_ring(int pending) {
  if (pending <= 1) repro_cp_async_wait<1>();
  else if (pending == 2) repro_cp_async_wait<2>();
  else repro_cp_async_wait<3>();
}

// GM: the block's query rows, at most DECODE_MAX_G, rounded up to a power
// of two (the register arrays' size); the rows gi >= g_n of the arrays
// hold zeros or unused values and are never written.  PVEC: elements of a
// row one lane holds in p v (8 or 16 bytes of the cache's type).  MMA:
// the scores on the tensor cores (bf16 q and cache, GM >= 2).  The launch
// bounds ask an SM to hold 2 blocks of DECODE_MAX_WARPS warps where GM is
// 4 or 8 (at most 128 registers a thread: acc alone takes GM x PVEC), 3
// below (at most 80, 85 in the register file's grain of 8).
template <typename TQ, typename TKV, int GM, int PVEC, bool MMA>
__global__ void __launch_bounds__(32 * DECODE_MAX_WARPS, GM >= 4 ? 2 : 3)
flash_decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                          const TKV* __restrict__ v,
                          const int* __restrict__ lengths,
                          TQ* __restrict__ out, float* __restrict__ part,
                          DecodeArgs a) {
  constexpr int VEC = 16 / sizeof(TKV);      // elements of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d_n = a.d, tile = a.tile, stages = a.stages;
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nch = d_n / VEC;                 // 16-byte chunks of a row
  const int swz = (nch & 7) == 0 ? 7 : 0;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / a.groups;
  const int g0 = (blockIdx.y - kvh * a.groups) * DECODE_MAX_G;
  const int g_n = min(DECODE_MAX_G, a.g - g0);   // this block's query rows
  const int length = lengths[b];
  const int range = a.s / a.splits;
  const int row0 = split * range;
  const int end = (length >= 1 && length < row0 + range) ? length
                                                          : row0 + range;
  const int tiles = end > row0 ? (end - row0 + tile - 1) / tile : 0;
  const int mine = tiles > warp ? (tiles - warp + nw - 1) / nw : 0;

  // [warps][tile][GM] f32 scores, with the tensor-core scores the query
  // rows (8 x D bf16, rows past g_n zero), then the rings [warps][stages]
  // [K | V] of tile x D each; at the end the rings' space holds the
  // warps' merge.
  float* sb = reinterpret_cast<float*>(smem_raw) + warp * tile * GM;
  TKV* qs = reinterpret_cast<TKV*>(smem_raw + static_cast<size_t>(nw)
                                   * tile * GM * sizeof(float));
  TKV* rings = qs + (MMA ? DECODE_MAX_G * d_n : 0);
  const int slot = 2 * tile * d_n;
  TKV* ring = rings + static_cast<size_t>(warp) * stages * slot;
  float* merge = reinterpret_cast<float*>(rings);
  // the element where chunk c of a tile's row r starts
  auto at = [&](int r, int c) { return (r * nch + (c ^ (r & swz))) * VEC; };

  const long long kv_base = b * a.kv_sb + kvh * a.kv_sh;
  const TQ* q_b = q + b * a.q_sb
                  + (static_cast<long long>(kvh) * a.g + g0) * a.q_sh;
  const int lpr = a.lpr;
  const int lpr_shift = __ffs(lpr) - 1;

  // a4: the rows below `end` of this warp's t-th tile, K and V, into its
  // ring slot t % stages; lpr lanes a row, a 16-byte chunk each.
  auto fetch = [&](int t) {
    const int first = row0 + (warp + t * nw) * tile;
    const int rows = min(tile, end - first);
    TKV* ks = ring + (t % stages) * slot;
    TKV* vs = ks + tile * d_n;
    for (int c = lane; c < rows * lpr; c += 32) {
      const int r = c >> lpr_shift;
      const int col = c & (lpr - 1);
      if (col >= nch) continue;
      const long long src = kv_base + (first + r) * a.kv_ss + col * VEC;
      repro_cp_async16(ks + at(r, col), k + src);
      repro_cp_async16(vs + at(r, col), v + src);
    }
  };

  // The query rows (the paper's resident Λ), in registers: for the tensor
  // cores bf16 and unscaled, as the MMA's A fragments (staged once through
  // shared memory for ldmatrix), or this lane's chunk in f32, pre-scaled.
  constexpr int QV = MMA ? 1 : VEC;
  float qr[MMA ? 1 : GM][QV];
  unsigned qa[MMA ? PVEC : 1][4];
  const int d0 = (lane & (lpr - 1)) * VEC;   // CUDA-core scores: the chunk
  const bool active = d0 < d_n;
  if constexpr (MMA) {
    for (int e = threadIdx.x; e < DECODE_MAX_G * d_n; e += blockDim.x) {
      const int r = e / d_n, col = e - r * d_n;
      qs[at(r, col / VEC) + col % VEC] =
          r < g_n ? q_b[r * a.q_sh + col] : from_f32<TQ>(0.0f);
    }
    __syncthreads();
    // A's fragments for every pair of k-steps: rows 0-7 of chunks 4 kp ..
    // 4 kp + 3 (rows 8-15 are zero); D is at most 32 PVEC, so PVEC pairs
    // cover it
#pragma unroll
    for (int kp = 0; kp < PVEC; ++kp) {
      if (4 * kp + 2 < nch) {
        ldmatrix_x4(qa[kp], qs + at(lane & 7, 4 * kp + (lane >> 3)));
      } else if (4 * kp < nch) {
        unsigned half[2];
        ldmatrix_x2(half, qs + at(lane & 7, 4 * kp + ((lane >> 3) & 1)));
        qa[kp][0] = half[0];
        qa[kp][1] = half[1];
      }
    }
  } else {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[gi][e] = gi < g_n && active
                        ? to_f32(q_b[gi * a.q_sh + d0 + e]) * a.scale : 0.0f;
  }

  // Lane l carries the running max and a share of the running sum of
  // query row l % GM; p v's lanes carry acc for every query row.
  const int gl = lane & (GM - 1);
  float m_run = DECODE_MASKED, l_run = 0.0f;
  const int plpr = a.plpr;
  const int pshift = __ffs(plpr) - 1;
  const int prpp = 32 >> pshift;             // rows p v takes at a time
  const int pgrp = lane >> pshift;
  const int pd0 = (lane & (plpr - 1)) * PVEC;
  const bool pactive = pd0 < d_n;
  const int pc = pd0 / VEC, poff = pd0 - pc * VEC;
  float acc[GM][PVEC];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi)
#pragma unroll
    for (int e = 0; e < PVEC; ++e) acc[gi][e] = 0.0f;

  for (int t = 0; t < stages - 1; ++t) {
    if (t < mine) fetch(t);
    repro_cp_async_commit();              // empty groups keep the count
  }
  for (int t = 0; t < mine; ++t) {
    // its slot was last read at t - 1, ended by a __syncwarp
    if (t + stages - 1 < mine) fetch(t + stages - 1);
    repro_cp_async_commit();
    wait_ring(stages - 1);                // tile t has landed ...
    __syncwarp();                         // ... for every lane of the warp
    const int first = row0 + (warp + t * nw) * tile;
    const int rows = min(tile, end - first);
    const TKV* ks = ring + (t % stages) * slot;
    const TKV* vs = ks + tile * d_n;

    // 1. The tile's scores into sb[row][query row].
    if constexpr (MMA) {
      const int gq = lane >> 2, j = lane & 3;
      for (int n0 = 0; n0 < rows; n0 += 8) {   // warp-uniform
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const int r = n0 + (lane & 7);        // the row this lane points at
        // k-steps of 16 two at a time: chunks 4 kp .. 4 kp + 3 of the 8
        // cache rows against the query rows' fragments
#pragma unroll
        for (int kp = 0; kp < PVEC; ++kp) {
          if (4 * kp + 2 < nch) {
            unsigned bf[4];
            ldmatrix_x4(bf, ks + at(r, 4 * kp + (lane >> 3)));
            mma_bf16(c, qa[kp][0], qa[kp][1], bf[0], bf[1]);
            mma_bf16(c, qa[kp][2], qa[kp][3], bf[2], bf[3]);
          } else if (4 * kp < nch) {
            unsigned bf[2];
            ldmatrix_x2(bf, ks + at(r, 4 * kp + ((lane >> 3) & 1)));
            mma_bf16(c, qa[kp][0], qa[kp][1], bf[0], bf[1]);
          }
        }
        if (gq < GM) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = n0 + 2 * j + h;
            sb[rr * GM + gq] = first + rr < length ? c[h] * a.scale
                                                   : DECODE_MASKED;
          }
        }
      }
    } else {
      const int grp = lane >> lpr_shift;
      const int rpp = 32 >> lpr_shift;
      for (int r0 = 0; r0 < rows; r0 += rpp) {   // warp-uniform
        const int r = r0 + grp;
        const bool valid = r < rows;
        float kf[VEC];
        if (valid && active) {
          load_f32(ks + at(r, d0 / VEC), kf);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[e] = 0.0f;
        }
        float sc[GM];
#pragma unroll
        for (int gi = 0; gi < GM; ++gi) {
          float s = 0.0f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) s = fmaf(qr[gi][e], kf[e], s);
          sc[gi] = s;
        }
        for (int o = 1; o < lpr; o <<= 1)
#pragma unroll
          for (int gi = 0; gi < GM; ++gi)
            sc[gi] += __shfl_xor_sync(DECODE_FULL, sc[gi], o);
        if (valid && (lane & (lpr - 1)) == 0) {
          const bool in = first + r < length;
#pragma unroll
          for (int gi = 0; gi < GM; ++gi)
            sb[r * GM + gi] = in ? sc[gi] : DECODE_MASKED;
        }
      }
    }
    __syncwarp();

    // 2. One softmax update for the tile: each exp once a (row, query row).
    float tmax = -__int_as_float(0x7f800000);   // -inf
    for (int r = lane / GM; r < rows; r += 32 / GM)
      tmax = fmaxf(tmax, sb[r * GM + gl]);
    for (int o = GM; o < 32; o <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(DECODE_FULL, tmax, o));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = __expf(m_run - m_new);
    float lsum = 0.0f;
    for (int r = lane / GM; r < rows; r += 32 / GM) {
      const float p = __expf(sb[r * GM + gl] - m_new);
      sb[r * GM + gl] = p;
      lsum += p;
    }
    l_run = fmaf(l_run, alpha, lsum);
    m_run = m_new;
    __syncwarp();

    // 3. acc rescaled once, then p v in f32.
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      const float al = __shfl_sync(DECODE_FULL, alpha, gi);
#pragma unroll
      for (int e = 0; e < PVEC; ++e) acc[gi][e] *= al;
    }
    if (pactive) {
      // two rows at a time where acc is small (GM <= 2), one where acc's
      // 8 x PVEC registers leave no room for a second row's loads
#pragma unroll (GM >= 4 ? 1 : 2)
      for (int r = pgrp; r < rows; r += prpp) {
        float vf[PVEC], p[GM];
        load_f32(vs + at(r, pc) + poff, vf);
        load_p<GM>(sb + r * GM, p);
#pragma unroll
        for (int gi = 0; gi < GM; ++gi)
#pragma unroll
          for (int e = 0; e < PVEC; ++e)
            acc[gi][e] = fmaf(p[gi], vf[e], acc[gi][e]);
      }
    }
    __syncwarp();                         // the slot and sb may be rewritten
  }
  repro_cp_async_wait<0>();

  // The warp's row groups share one m a query row: their acc add, in a
  // fixed order, and so do the lanes' shares of l.
  for (int o = plpr; o < 32; o <<= 1)
#pragma unroll
    for (int gi = 0; gi < GM; ++gi)
#pragma unroll
      for (int e = 0; e < PVEC; ++e)
        acc[gi][e] += __shfl_xor_sync(DECODE_FULL, acc[gi][e], o);
  for (int o = GM; o < 32; o <<= 1)
    l_run += __shfl_xor_sync(DECODE_FULL, l_run, o);
  // The warps merge once, through the rings' space: [warp][g][acc | m | l].
  __syncthreads();
  if (pgrp == 0 && pactive) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi >= g_n) break;
      float* row = merge + (warp * g_n + gi) * (d_n + 2);
#pragma unroll
      for (int e = 0; e < PVEC; ++e) row[pd0 + e] = acc[gi][e];
    }
  }
  if (lane < g_n) {
    float* row = merge + (warp * g_n + lane) * (d_n + 2);
    row[d_n] = m_run;
    row[d_n + 1] = l_run;
  }
  __syncthreads();
  const int pitch = g_n * (d_n + 2);
  for (int e = threadIdx.x; e < g_n * d_n; e += blockDim.x) {
    const int gi = e / d_n;
    const int di = e - gi * d_n;
    const float* row = merge + gi * (d_n + 2);
    float mx = row[d_n];
    for (int w = 1; w < nw; ++w) mx = fmaxf(mx, row[w * pitch + d_n]);
    float sum_l = 0.0f, sum_a = 0.0f;
    for (int w = 0; w < nw; ++w) {
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

// The split kernel's instance for one launch: the tensor-core scores only
// where they exist (bf16 q and cache, GM >= 2).
template <typename TQ, typename TKV, int GM, int PVEC>
const void* split_kernel(bool mma) {
  if constexpr (std::is_same_v<TQ, __nv_bfloat16>
                && std::is_same_v<TKV, __nv_bfloat16> && GM >= 2) {
    if (mma)
      return reinterpret_cast<const void*>(
          flash_decode_split_kernel<TQ, TKV, GM, PVEC, true>);
  }
  if (mma) return nullptr;
  return reinterpret_cast<const void*>(
      flash_decode_split_kernel<TQ, TKV, GM, PVEC, false>);
}

template <typename TQ, typename TKV, int GM>
const void* split_kernel(bool wide, bool mma) {
  constexpr int NARROW = 8 / sizeof(TKV), WIDE = 16 / sizeof(TKV);
  return wide ? split_kernel<TQ, TKV, GM, WIDE>(mma)
              : split_kernel<TQ, TKV, GM, NARROW>(mma);
}

template <typename TQ, typename TKV>
const void* split_kernel(int gm, bool wide, bool mma) {
  switch (gm) {
    case 1: return split_kernel<TQ, TKV, 1>(wide, mma);
    case 2: return split_kernel<TQ, TKV, 2>(wide, mma);
    case 4: return split_kernel<TQ, TKV, 4>(wide, mma);
    default: return split_kernel<TQ, TKV, 8>(wide, mma);
  }
}

static int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// The block's query rows rounded up to a power of two: the kernel's GM.
static int query_rows_pow2(int g) {
  return pow2_at_least(g < DECODE_MAX_G ? g : DECODE_MAX_G);
}

// p v holds 16 bytes of a row a lane where 8 bytes a lane would need more
// than a warp.
static bool wide_rows(int d, int kv_bytes) { return d > 32 * 8 / kv_bytes; }

// What a launch picks: null for a combination the source does not build.
static const void* split_kernel_of(int q_dtype, int kv_dtype, int g, int d,
                                   int mma) {
  const int gm = query_rows_pow2(g);
  const bool wide = wide_rows(d, kv_dtype == 0 ? 4 : 2);
  if (q_dtype == 0 && kv_dtype == 0)
    return split_kernel<float, float>(gm, wide, mma != 0);
  if (q_dtype == 0 && kv_dtype == 1)
    return split_kernel<float, __nv_bfloat16>(gm, wide, mma != 0);
  if (q_dtype == 1 && kv_dtype == 0)
    return split_kernel<__nv_bfloat16, float>(gm, wide, mma != 0);
  if (q_dtype == 1 && kv_dtype == 1)
    return split_kernel<__nv_bfloat16, __nv_bfloat16>(gm, wide, mma != 0);
  return nullptr;
}

// Whether the shape lets the split kernel score on the tensor cores (a
// bf16 cache, G >= 2, D a multiple of 16, tiles of 8 rows); a launch does
// where the query is bf16 too.
static bool mma_shape(int g, int d, int tile, int kv_bytes) {
  return kv_bytes == 2 && g >= 2 && d % 16 == 0 && tile % 8 == 0;
}

}  // namespace

// Shared memory one block of the split kernel allocates: each warp's
// (tile, G') f32 scores (G' = min(G, 8) rounded up to a power of two);
// where the shape lets it score on the tensor cores, 8 query rows of D
// bf16; then each warp's ring of `stages` slots of K and V, tile x D
// each, unswizzled in size; the warps' merge buffer, (min(G, 8), D + 2)
// f32 a warp, reuses the rings' space.
extern "C" long long flash_decode_smem_bytes(int g, int d, int tile,
                                             int stages, int warps,
                                             int kv_bytes) {
  const int rows = g < DECODE_MAX_G ? g : DECODE_MAX_G;
  const long long ring = 2LL * warps * stages * tile * d * kv_bytes;
  const long long merge = 4LL * warps * rows * (d + 2);
  return 4LL * warps * tile * query_rows_pow2(g)
         + (mma_shape(g, d, tile, kv_bytes) ? 2LL * DECODE_MAX_G * d : 0)
         + (ring > merge ? ring : merge);
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

// The ring the kernel takes: tiles of 4 to 32 rows in steps of 4, 2 to 4
// slots, 1 to 8 warps; the tensor-core scores need a bf16 q and cache,
// G >= 2, D a multiple of 16 and tiles of 8 rows.  Returns 0 when it takes
// them.
extern "C" int flash_decode_ring_ok(int q_dtype, int kv_dtype, int g, int d,
                                    int tile, int stages, int warps,
                                    int mma) {
  const bool ring = tile >= 4 && tile <= 32 && tile % 4 == 0
                    && stages >= 2 && stages <= 4 && warps >= 1
                    && warps <= DECODE_MAX_WARPS;
  const bool mma_ok = !mma || (q_dtype == 1 && mma_shape(g, d, tile,
                                                        kv_dtype == 0 ? 4
                                                                      : 2));
  return ring && mma_ok ? 0 : 1;
}

// q (B, H_q, D) and out (same shape and strides), k and v (B, S, H_kv, D)
// with the strides given (16-byte aligned rows), lengths (B,) int32 and
// part (B, H_kv, splits, G, D + 2) f32 on the card or null.  With part
// null (one split only) the kernel writes acc / l to out; otherwise it
// writes every split's partial to part and does not write out (the
// combine does).  q_dtype and kv_dtype: 0 = float32, 1 = bfloat16; tile,
// stages and warps the ring (core.planner.decode_ring); mma 1 for the
// tensor-core scores.  Returns the cudaError_t of the launch (0 on
// success); does not synchronise.
extern "C" int flash_decode_split_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part, int q_dtype, int kv_dtype, int batch, int s,
    int h_kv, int g, int d, int bkv, int splits, int tile, int stages,
    int warps, int mma, long long q_sb, long long q_sh, long long kv_sb,
    long long kv_ss, long long kv_sh, float scale, void* stream) {
  const int kv_bytes = kv_dtype == 0 ? 4 : 2;
  if (flash_decode_shape_ok(s, g, d, bkv, splits, kv_bytes) != 0
      || flash_decode_ring_ok(q_dtype, kv_dtype, g, d, tile, stages, warps,
                              mma) != 0
      || (part == nullptr && splits != 1))
    return cudaErrorInvalidValue;
  const long long smem = flash_decode_smem_bytes(g, d, tile, stages, warps,
                                                 kv_bytes);
  const void* fn = split_kernel_of(q_dtype, kv_dtype, g, d, mma);
  if (smem > REPRO_SMEM_LIMIT_BYTES || fn == nullptr)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int plvec = wide_rows(d, kv_bytes) ? 16 / kv_bytes : 8 / kv_bytes;
  DecodeArgs a{s, h_kv, g, d, splits,
               (g + DECODE_MAX_G - 1) / DECODE_MAX_G, tile, stages,
               pow2_at_least(d / (16 / kv_bytes)),
               pow2_at_least((d + plvec - 1) / plvec), q_sb, q_sh, kv_sb,
               kv_ss, kv_sh, scale};
  const dim3 grid(splits, h_kv * a.groups, batch);
  void* args[] = {const_cast<void**>(&q), const_cast<void**>(&k),
                  const_cast<void**>(&v), const_cast<void**>(&lengths),
                  &out, &part, &a};
  const cudaError_t launched = cudaLaunchKernel(
      fn, grid, dim3(32 * warps), args, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

// The split kernel's instance for a launch of these arguments, on the
// current device: out[0] its blocks resident an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor with the launch's
// threads and shared memory), out[1] its registers a thread, out[2] its
// local memory a thread in bytes (spills).  Returns a cudaError_t.
extern "C" int flash_decode_occupancy(int q_dtype, int kv_dtype, int g,
                                      int d, int tile, int stages, int warps,
                                      int mma, int* out) {
  const int kv_bytes = kv_dtype == 0 ? 4 : 2;
  const void* fn = split_kernel_of(q_dtype, kv_dtype, g, d, mma);
  if (fn == nullptr || flash_decode_ring_ok(q_dtype, kv_dtype, g, d, tile,
                                            stages, warps, mma) != 0)
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(
      flash_decode_smem_bytes(g, d, tile, stages, warps, kv_bytes));
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn,
                                                      32 * warps, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
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
