// L2's ceiling for the block GeMM's tile pattern (tools/l2_probe.py).
//
// Every block of the launch fetches K3's A boxes (128 rows x 64 bf16,
// swizzled 128 bytes, as `bf16_tensor_map` builds them) from a bf16
// buffer, by TMA, into a ring of slots of one or more boxes, as K3's
// producer does, and a consumer thread frees each slot as soon as it has
// landed (no product).  In a cluster of g ranks (g = 1, 2, 4) the ranks
// fetch the same box: each issues its g-th of the box's rows with
// `.multicast::cluster` to all g ranks, each rank's `full` barrier expects
// the whole slot, and a slot's `empty` barrier collects one arrival from
// every rank's consumer before its issuer refills it (K3's multicast
// ring).  L2 serves each box once a cluster; it lands g times.
#include "block_matmul.cu"

namespace {

constexpr int kBoxRows = 128, kBoxCols = 64;
constexpr int kBoxBytes = kBoxRows * kBoxCols * 2;

// SEM 0: the K4 ring's barriers (release.cluster arrivals on every
// rank's `empty`, acquire.cluster waits); SEM 1: K3's (default-semantics
// arrivals through shared::cluster, CTA-scope waits).
template <int SEM>
__global__ void __launch_bounds__(64, 1)
l2_probe_kernel(const __grid_constant__ CUtensorMap tm, int g, int stages,
                int iters, int box_cols, int boxes, int per_slot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t slot_bytes = per_slot * kBoxBytes;
  const uint32_t bars = base + stages * slot_bytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  const int rank = cluster_rank();
  const int cluster = blockIdx.x / g;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), g);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync_all();
  const int share = kBoxRows / g;
  if (threadIdx.x == 32) {   // the producer
    for (int i = 0; i < iters; ++i) {
      const int s = i % stages;
      const uint32_t ph = (i / stages) & 1;
      if (SEM) mbar_wait_cta(empty(s), ph ^ 1);
      else mbar_wait(empty(s), ph ^ 1);
      mbar_expect_tx(full(s), slot_bytes);
      for (int j = 0; j < per_slot; ++j) {
        const int box = (cluster * iters * per_slot + i * per_slot + j) % boxes;
        const int col = (box % box_cols) * kBoxCols;
        const int row = (box / box_cols) * kBoxRows + rank * share;
        const uint32_t dst = base + s * slot_bytes + j * kBoxBytes
                             + rank * share * kBoxCols * 2;
        if (g == 1)
          tma_load(dst, &tm, full(s), col, row);
        else
          tma_load_multicast(dst, &tm, full(s), col, row,
                             static_cast<uint16_t>((1u << g) - 1));
      }
    }
  } else if (threadIdx.x == 0) {   // the consumer
    for (int i = 0; i < iters; ++i) {
      const int s = i % stages;
      if (SEM) mbar_wait_cta(full(s), (i / stages) & 1);
      else mbar_wait(full(s), (i / stages) & 1);
      for (int q = 0; q < g; ++q) {
        if (SEM) mbar_arrive_remote(empty(s), q);
        else mbar_arrive_at(empty(s), q);
      }
    }
  }
  cluster_sync_all();
}

}  // namespace

// Shared memory the probe asks for with `stages` slots.
extern "C" int l2_probe_smem(int stages, int per_slot) {
  return 1024 + stages * per_slot * kBoxBytes + 16 * stages;
}

// Clusters of g blocks the probe fits at once; a negative cudaError_t on
// error.
extern "C" int l2_probe_clusters(int g, int stages, int per_slot) {
  return clusters_that_fit(l2_probe_kernel<1>, 64, g,
                           l2_probe_smem(stages, per_slot));
}

// One launch of `blocks` blocks in clusters of g over the bf16 buffer at
// `buf` (rows x cols, row-major; rows a multiple of 128, cols of 64), each
// block filling `iters` slots of `per_slot` boxes.  Returns the cudaError_t of the launch.
extern "C" int l2_probe_launch(const void* buf, int rows, int cols, int g,
                               int stages, int per_slot, int iters,
                               int blocks, int sem, void* stream) {
  if (g != 1 && g != 2 && g != 4) return cudaErrorInvalidValue;
  if (rows % kBoxRows || cols % kBoxCols || blocks % g)
    return cudaErrorInvalidValue;
  CUtensorMap tm;
  if (!bf16_tensor_map(&tm, buf, cols, rows, kBoxCols, kBoxRows / g))
    return cudaErrorInvalidValue;
  const int smem = l2_probe_smem(stages, per_slot);
  const auto kern = sem ? l2_probe_kernel<1> : l2_probe_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Config conf(dim3(blocks), smem, g, static_cast<cudaStream_t>(stream), 64);
  const int box_cols = cols / kBoxCols;
  err = cudaLaunchKernelEx(&conf.cfg, kern, tm, g, stages, iters,
                           box_cols, box_cols * (rows / kBoxRows), per_slot);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The roofline crossover's two rates at one clock (tools/l2_probe.py
// --rates): the tensor cores' and the landing rate, each alone and both
// at once in one block, with the SM clock read inside the window.
//
// A block of CHAIN > 0 runs 384 threads as K3 does at bn 256: two
// consumer warpgroups (setmaxnreg 232) and a third warpgroup (setmaxnreg
// 40) whose warps 0 and 1 produce and whose warp 2 frees the ring.  The
// consumers run K3's own products on a tile that stays put in shared
// memory (A 128 x 64, each warpgroup its 64 rows; B 64 x 256, swizzled
// 128 bytes as K3's descriptors read them): each group is four k16 steps
// of one m64n256k16 (CHAIN 256) or of two m64n128k16 (CHAIN 128, K3's
// two 128-column products), committed without waiting, with up to three
// groups in flight (`wgmma.wait_group 2`).  The ring's producers land
// 64-column boxes of `box_rows` rows (128: K3's A box; 256: its B box at
// bk 256) from a bf16 buffer by TMA, unicast or `.multicast::cluster`
// over clusters of g (with MIX, K3's pair over clusters of 2: boxes 0, 2,
// ... an A box of 128 rows each rank fetches for itself, boxes 1, 3, ... a
// B box of 256 rows multicast to both), producer p issuing boxes p, p + P,
// ... of a slot
// and walking its cluster's boxes without dividing (a few divisions a box
// keep one thread below the rate the card lands at); the freeing warp
// waits for each slot and frees it on every sharer at once, reading
// nothing, so the ring and the products never wait for each other.  With
// PACED a warpgroup issues a group at most every `pace` SM clocks.  A
// block of CHAIN 0 runs the ring alone on 96 threads (warps 0 and 1
// produce, warp 2 frees); two of them fit an SM when their shared memory
// does.
//
// Every block writes LP_REC records: the consumers' window (thread 0:
// %clock64 and %globaltimer before the first group and after the last
// has retired), and the freeing warp's: from its first wait to the first
// slot it frees after the consumers are done (or to its last slot), the
// slots freed in it, and the consumers' group count at both ends, so that
// both rates and the clock come from one window.

namespace {

constexpr int kLpTileA = 128 * 64 * 2;   // the chain's A tile
constexpr int kLpTileB = 64 * 256 * 2;   // its B tile
constexpr int kLpGroupK = 4;             // k16 steps a group
constexpr int kLpPairA = 128 * 64 * 2;   // MIX: an A box, then a B box
constexpr int kLpPair = 3 * kLpPairA;
#define LP_REC 16

struct LpArgs {
  int g, box_rows, box_cols, boxes, stages, per_slot, producers;
  int slots;    // slots each producer fills
  int groups;   // groups each consumer warpgroup runs (0: no chain)
  int pace;     // PACED: SM clocks between a warpgroup's group issues
  int mix;      // K3's pairs: A boxes unicast, B boxes over the cluster
};

__device__ inline long long lp_clock() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c));
  return c;
}

__device__ inline long long lp_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ inline void lp_st(uint32_t addr, uint32_t v) {
  asm volatile("st.volatile.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ inline uint32_t lp_ld(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr)
               : "memory");
  return v;
}

template <int N>
__device__ inline void lp_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int CHAIN, bool PACED>
__global__ void __launch_bounds__(CHAIN ? 384 : 96, 1)
lp_kernel(const __grid_constant__ CUtensorMap tm, LpArgs a, long long* rec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t tiles = base;
  const uint32_t ring = base + (CHAIN ? kLpTileA + kLpTileB : 0);
  const uint32_t box_bytes = 64u * a.box_rows * 2u;
  const uint32_t slot_bytes = a.mix ? a.per_slot / 2 * kLpPair
                                    : a.per_slot * box_bytes;
  // box j of a slot: its offset, its bytes, and whether each rank
  // fetches it for itself alone
  auto unicast = [&](int j) { return a.g == 1 || (a.mix && !(j & 1)); };
  auto box_at = [&](int j) {
    return a.mix ? j / 2 * kLpPair + (j & 1) * kLpPairA : j * box_bytes;
  };
  auto bytes_of = [&](int j) {
    return a.mix ? (j & 1 ? 2 * kLpPairA : kLpPairA) : box_bytes;
  };
  const uint32_t bars = ring + a.stages * slot_bytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (a.stages + s); };
  const uint32_t tcount = bars + 16u * a.stages, tdone = tcount + 4u;
  const int pbase = CHAIN ? 256 : 0;   // producer p: pbase + 32 p
  long long* const r = rec + static_cast<long long>(blockIdx.x) * LP_REC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full(s), a.producers);
      mbar_init(empty(s), a.g);
    }
    lp_st(tcount, 0);
    lp_st(tdone, 0);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (CHAIN && threadIdx.x < 256) {
    // the tile that stays put: bf16 of magnitude 0.5-1, random signs and
    // mantissas, so that the tensor cores draw the power real data makes
    for (int i = threadIdx.x; i < (kLpTileA + kLpTileB) / 4; i += 256) {
      uint32_t h = (i + 1u) * 2654435761u ^ (blockIdx.x * 40503u);
      h ^= h >> 15;
      h *= 2246822519u;
      asm volatile("st.shared.u32 [%0], %1;\n"
                   ::"r"(tiles + 4u * i), "r"((h & 0x807F807Fu) | 0x3F003F00u)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  cluster_sync_all();
  if constexpr (CHAIN > 0) {
    if (threadIdx.x >= 256)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   ::"n"(MM_WG_PRODUCER_REGS));
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   ::"n"(MM_WG_CONSUMER_REGS));
  }

  const int rank = cluster_rank();
  const int cluster = blockIdx.x / a.g;
  const int sub = a.box_rows / a.g;   // rows of a box this rank issues
  const int p = (threadIdx.x - pbase) / 32;
  if (threadIdx.x >= pbase && threadIdx.x % 32 == 0 && p < a.producers) {
    // ---- producer p: the cluster's boxes from its own stretch of the
    // buffer, box (column bc, row br) walked in order with no division
    uint32_t mine = 0;
    for (int j = p; j < a.per_slot; j += a.producers) mine += bytes_of(j);
    const int box_rows_n = a.boxes / a.box_cols;
    const int first = static_cast<int>(
        static_cast<long long>(cluster) * a.slots * a.per_slot % a.boxes);
    int bc = first % a.box_cols, br = first / a.box_cols;
    int s = 0;
    uint32_t ph = 1;
    for (int i = 0; i < a.slots; ++i) {
      mbar_wait_cta(empty(s), ph);
      mbar_expect_tx(full(s), mine);
      const uint32_t slot = ring + s * slot_bytes;
      for (int j = 0; j < a.per_slot; ++j) {
        if (a.producers == 1 || (j & 1) == p) {
          const uint32_t dst =
              slot + box_at(j) + (unicast(j) ? 0u : rank * sub * 128u);
          const int col = bc * 64, row = br * a.box_rows + rank * sub;
          if (unicast(j))
            tma_load(dst, &tm, full(s), col, row);
          else
            tma_load_multicast(dst, &tm, full(s), col, row,
                               static_cast<uint16_t>((1u << a.g) - 1));
        }
        if (++bc == a.box_cols) {
          bc = 0;
          if (++br == box_rows_n) br = 0;
        }
      }
      if (++s == a.stages) {
        s = 0;
        ph ^= 1;
      }
    }
  } else if (threadIdx.x == pbase + 64) {
    // ---- the freeing warp: every slot freed on every sharer as it lands
    const bool watch = CHAIN > 0 && a.groups > 0;
    const long long c0 = lp_clock(), t0 = lp_ns();
    const uint32_t tc0 = CHAIN ? lp_ld(tcount) : 0;
    long long landed = 0;
    bool ended = false;
    auto close = [&](bool by_chain) {
      r[4] = c0;
      r[5] = lp_clock();
      r[6] = t0;
      r[7] = lp_ns();
      r[8] = landed;
      r[9] = tc0;
      r[10] = CHAIN ? lp_ld(tcount) : 0;
      r[11] = by_chain;
      ended = true;
    };
    int s = 0;
    uint32_t ph = 0;
    for (int i = 0; i < a.slots; ++i) {
      mbar_wait_cta(full(s), ph);
      for (int q = 0; q < a.g; ++q) {
        if (a.g == 1) mbar_arrive(empty(s));
        else mbar_arrive_remote(empty(s), q);
      }
      if (!ended) {
        ++landed;
        if (watch && lp_ld(tdone)) close(true);
      }
      if (++s == a.stages) {
        s = 0;
        ph ^= 1;
      }
    }
    if (!ended) close(false);
  }
  if constexpr (CHAIN > 0) {
    if (threadIdx.x < 256 && a.groups > 0) {
      // ---- the consumers: K3's products on the tile that stays put
      const int wg = threadIdx.x / 128;
      const uint32_t a_tile = tiles + wg * 64 * 128;
      const uint32_t b_tile = tiles + kLpTileA;
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.f;
      long long c0 = 0, t0 = 0;
      if (threadIdx.x == 0) {
        c0 = lp_clock();
        t0 = lp_ns();
      }
      fence_regs<128>(d);
      long long due = lp_clock();
      for (int it = 0; it < a.groups; ++it) {
        if constexpr (PACED) {   // a group every `pace` clocks at most
          due += a.pace;
          while (lp_clock() < due) __nanosleep(32);
          __syncwarp();
        }
        wgmma_fence();
        if constexpr (CHAIN == 256) {
#pragma unroll
          for (int q = 0; q < kLpGroupK; ++q)
            wgmma_n256(d, mat_desc(a_tile + 32 * q, 16, 1024, 64),
                       mat_desc(b_tile + 2048 * q, 8192, 1024, 64), 1);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < kLpGroupK; ++q)
              wgmma_n128(d + 64 * h, mat_desc(a_tile + 32 * q, 16, 1024, 64),
                         mat_desc(b_tile + 16384 * h + 2048 * q, 8192, 1024,
                                  64), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        lp_wgmma_wait<2>();
        if (threadIdx.x == 0) lp_st(tcount, it + 1);
      }
      lp_wgmma_wait<0>();
      fence_regs<128>(d);
      if (threadIdx.x == 0) {
        r[0] = c0;
        r[1] = lp_clock();
        r[2] = t0;
        r[3] = lp_ns();
        lp_st(tdone, 1);
      }
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 128; ++i) sum += d[i];
      if (sum == 1234.5f) r[15] = 1;   // keeps the products live
    }
  }
  cluster_sync_all();
}

inline int lp_threads(int chain) { return chain ? 384 : 96; }

using LpFn = void (*)(CUtensorMap, LpArgs, long long*);

inline LpFn lp_kernel_of(int chain, int pace) {
  if (pace) return lp_kernel<256, true>;
  return chain == 256 ? lp_kernel<256, false>
         : chain == 128 ? lp_kernel<128, false> : lp_kernel<0, false>;
}

inline bool lp_valid(int g, int box_rows, int stages, int per_slot,
                     int producers, int chain, int mix) {
  return (g == 1 || g == 2 || g == 4) && (box_rows == 128 || box_rows == 256)
         && stages >= 1 && per_slot >= 1 && producers >= 1 && producers <= 2
         && producers <= per_slot
         && (chain == 0 || chain == 128 || chain == 256)
         && (!mix || (g == 2 && box_rows == 256 && per_slot % 2 == 0));
}

}  // namespace

// Shared memory a block of the rate probe asks for.
static int lp_smem(int chain, int box_rows, int stages, int per_slot,
                   int mix) {
  return 1024 + (chain ? kLpTileA + kLpTileB : 0)
         + stages * (mix ? per_slot / 2 * kLpPair : per_slot * 64 * box_rows * 2)
         + 16 * stages + 16;
}

// Clusters of g blocks of the rate probe that fit at once; a negative
// cudaError_t on error.
extern "C" int lp_clusters(int g, int chain, int box_rows, int stages,
                           int per_slot, int mix) {
  if (!lp_valid(g, box_rows, stages, per_slot, 1, chain, mix))
    return -static_cast<int>(cudaErrorInvalidValue);
  const int smem = lp_smem(chain, box_rows, stages, per_slot, mix);
  if (smem > REPRO_SMEM_LIMIT_BYTES)
    return -static_cast<int>(cudaErrorInvalidValue);
  return clusters_that_fit(lp_kernel_of(chain, 0), lp_threads(chain), g,
                           smem);
}

// One launch of the rate probe: `blocks` blocks in clusters of g over the
// bf16 buffer at `buf` (rows x cols, row-major; rows a multiple of
// box_rows, cols of 64), each producer filling `slots` slots of
// `per_slot` boxes, each consumer warpgroup running `groups` groups of
// the chain of width `chain` (0: no chain, and `groups` must be 0), a
// group at most every `pace` SM clocks (0: as fast as they retire; a pace
// only on the m64n256 chain), with `mix` K3's pairs (box_rows 256, g 2,
// per_slot even).  `rec` holds LP_REC long longs a block.  Returns the
// cudaError_t of the launch.
extern "C" int lp_launch(const void* buf, int rows, int cols, int g,
                         int box_rows, int stages, int per_slot,
                         int producers, int slots, int chain, int groups,
                         int pace, int mix, int blocks, long long* rec,
                         void* stream) {
  if (!lp_valid(g, box_rows, stages, per_slot, producers, chain, mix) ||
      rows % box_rows || cols % 64 || blocks % g || slots < 0 ||
      groups < 0 || (chain == 0 && groups != 0) || pace < 0 ||
      (pace > 0 && chain != 256))
    return cudaErrorInvalidValue;
  CUtensorMap tm;
  if (!bf16_tensor_map(&tm, buf, cols, rows, 64, box_rows / g))
    return cudaErrorInvalidValue;
  const int smem = lp_smem(chain, box_rows, stages, per_slot, mix);
  if (smem > REPRO_SMEM_LIMIT_BYTES) return cudaErrorInvalidValue;
  const LpArgs args{g, box_rows, cols / 64, (cols / 64) * (rows / box_rows),
                    stages, per_slot, producers, slots, groups, pace, mix};
  const LpFn kern = lp_kernel_of(chain, pace);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Config conf(dim3(blocks), smem, g, static_cast<cudaStream_t>(stream),
              lp_threads(chain));
  err = cudaLaunchKernelEx(&conf.cfg, kern, tm, args, rec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
