// S1 convolution, plan-shaped kernel: resident window, per-step I_slice
// deltas fetched ahead of the step and pushed into every block of a
// thread-block cluster, the step's product split over the cluster by
// kernel channel and by output column.
//
// Replaces the Pallas TPU kernel `conv2d_offload_planned` /
// `_conv_planned_kernel` (with the shared `_im2col_dot`) of
// src/repro/kernels/conv2d_offload.py; it is what `EmittedConv.run`
// launches for a solved LayerPlan.
//
// Contract.  Grid step s of the plan's ordered sweep fetches exactly the
// plan's Def-3 I_slice(s) from device memory, once per cluster:
//   full       first step, or no overlap with the previous window: the
//              whole (C_in, H_K, t_in) box;
//   row-delta  a row turn that keeps the column window (zigzag, or one
//              tile per row): only the s_h new rows;
//   col-delta  a within-row move: only the t_run*s_w new columns.
// Which case a step takes is `step_case` of kernels/conv2d_offload.py; the
// host decides `row_delta` and `col_delta` and passes them as flags.
//
// Mapping.  A Pallas-TPU grid runs its steps in order on one core and
// carries the window from step to step; CUDA blocks run in no order.  So
// the ordered sweep is a loop inside the block, run by every block of a
// cluster of cs = cs_n x cs_t blocks on neighbouring SMs
// (conv2d_offload_planned_cluster_shape; `conv_cluster_shape` of
// core/planner.py).  Rank r = g*cs_t + u keeps Λ's kernel channels
// [g*N/cs_n, (g+1)*N/cs_n) in its shared memory for the whole sweep (Def
// 16) and computes output columns [u*T/cs_t, (u+1)*T/cs_t) of each step
// for those channels (T = t_run).  Λ's columns of group g are fetched once
// per cluster: each of the group's cs_t ranks fetches one share and
// writes it into all of them.  Every rank keeps a replica of the whole
// window.  Each step's box is cut into cs disjoint shares (`share_lo`;
// `fetch_shares` in Python) and rank r fetches share r only.
//
// Delivery.  Step 0's shares are written into every rank's window before
// the sweep, between two cluster barriers (the first: every block has
// started and set up its mbarriers; the second publishes Λ and the
// window).  From step 1 on, each rank has a ring of RING slots; a slot
// holds a whole box as cs shares, share q at q * share_cap, and has a
// `full` mbarrier (the service warp's 32 lanes arrive, lane 0 expecting
// the peers' bytes) and an `empty` mbarrier (one arrival from each rank).
// The service warp of rank r, for step s = j + 1 into slot j % RING:
//   waits `empty` of that slot for step s - RING (from j >= RING on),
//   stores its share into its own slot, loaded from device memory element
//   by element (the boxes' rows start anywhere: a 34-column f32 input row
//   is 136 bytes, and a column delta starts two columns into a tile, so
//   neither TMA nor a bulk copy can fetch exactly the box; bfloat16
//   deltas may start at an odd element), the first elements issued before
//   the wait, a step ahead;
//   pushes the share from its slot into the same slot of every peer by a
//   bulk shared-to-shared copy (a share starts on 16 bytes in a slot and
//   is copied in whole 16 bytes), completing on the peer's `full`
//   barrier; and arrives on its own `full` barrier, expecting the peers'
//   bytes.
// The compute warps of every rank, at step s: wait `full`, splice the box
// from their own slot into the window, meet, arrive on every rank's
// `empty` barrier, and run the product.  The producer runs up to RING - 1
// steps ahead.  No cluster barrier and no load from a peer's shared
// memory is left in the step loop; a last cluster barrier before exit
// keeps every block alive while a peer may still arrive on its barriers.
//
// The window is indexed in place: input row h, column w lives in slot
// (h % H_K, w % t_in).  A window always covers H_K consecutive rows and
// t_in consecutive columns, so a delta lands exactly on the slots of the
// rows or columns it replaces and nothing kept ever moves.
//
// Product.  float32: the block's (T/cs_t, N/cs_n) output tile is cut into
// register tiles of 2 output columns x 8 kernel channels; the KS compute
// threads of one register tile (KS a power of two, up to 32, consecutive
// lanes of one warp) each sum a slice of the patch's (c, kh) rows into 16
// independent f32 FMA chains, then halve the tile between them by warp
// shuffles; full f32 on the ordinary units.  bfloat16: the tensor cores'
// mma.sync.m16n8k16 with f32 sums; a 16-row x 8-channel tile of the
// output per warp and step, its k chunks of 16 split over `split` warps
// when there are fewer tiles than warps (`k_split`), each of those warps
// writing its f32 partial tile into shared memory and the compute threads
// adding them in a fixed order (shared memory has no native f32 atomic
// add: a compare-and-swap loop under contention costs more); the sums are
// rounded once at the store.  3x3 and 1x1 kernels are template
// constants, so the inner loops unroll; with stride-1 columns a patch
// row's window values are read once for all taps, and with N/cs_n a
// multiple of 8 a Λ row is two 16-byte loads.
//
// What bounds it on an H100: neither the bytes nor the operations (both
// take well under a microsecond at the card's peak rates for the layers of
// the conv networks here) but the length of the sweep: h_out * tiles
// steps, each a wait on the ring, the splice, two or three barriers of
// the compute warps and the product; the cluster spreads the product over
// up to 8 SMs and the ring keeps the fetch off the step's path.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "conv_common.cuh"

namespace cg = cooperative_groups;

// Phase markers: K1_PHASE(0) starts thread 0's clock, K1_PHASE(k) for k in
// 1..15 closes phase k of its step; K1_PHASE(16) starts the service warp's
// lane 0, K1_PHASE(k) for k in 17..23 closes its phases.  Empty here;
// tools/k1_phase_probe.py defines them to read the SM clock when it builds
// its copy of this kernel.
#ifndef K1_PHASE
#define K1_PHASE(k)
#endif

namespace {

constexpr int CT = 256;               // compute threads: warps 0-7
constexpr int PL_THREADS = CT + 32;   // and the service warp
constexpr int RT = 2;                 // output columns of a register tile
constexpr int RN = 8;                 // kernel channels of a register tile
constexpr unsigned FULL = 0xffffffffu;
// core/planner.py: CONV_RING_DEPTH, CONV_MAX_CLUSTER,
// CONV_MIN_CHANNELS_PER_BLOCK, CONV_MIN_COLUMNS_PER_BLOCK;
// kernels/conv2d_offload.py: SHARE_ALIGN
constexpr int RING = 2;
constexpr int MAX_CLUSTER = 8;
constexpr int MIN_CHANNELS = 8;
constexpr int MIN_COLUMNS = 4;
constexpr int SHARE_ALIGN = 8;

struct PlannedArgs {
  int c_in, h_in, w_in, n, h_k, w_k, s_h, s_w, t_run, h_out, tiles;
  int zigzag, row_delta, col_delta, cs_n, cs_t;
};

// Warps of the bfloat16 product that split one output tile's k chunks:
// with `tiles` 16 x 8 tiles in a block's (ts x nr) part of a step and kc
// chunks of 16 in C_in*H_K*W_K, 1 when the tiles fill the 8 warps, else
// as many as the warps left per tile and the chunks allow.
// `conv_k_split` of kernels/conv2d_offload.py.
__host__ __device__ inline int k_split(int ts, int nr, int k_total) {
  const int tiles = ((ts + 15) / 16) * ((nr + 7) / 8);
  const int kc = (k_total + 15) / 16;
  if (tiles >= 8) return 1;
  const int split = 8 / tiles;
  return split < kc ? split : kc;
}

// One block's shared memory, in elements, in the order it is carved:
// Λ's group columns (from 16 bytes), the window, `pad` (up to the next
// multiple of 8 elements: the ring starts on 16 bytes), the ring (RING
// slots of cs shares of `share` elements, a share rounded up to
// SHARE_ALIGN, so that every share starts on 16 bytes) and the f32
// partial tiles of the bfloat16 product (k_split of T/cs_t x N/cs_n, two
// elements a value; none without a split).  `planned_layout` of
// kernels/conv2d_offload.py.
struct Layout {
  long long share, lam, window, pad, ring, parts;
  __host__ __device__ long long total() const {
    return lam + window + pad + ring + parts;
  }
};

__host__ __device__ inline Layout planned_layout(int c_in, int n, int h_k,
                                                 int w_k, int s_h, int s_w,
                                                 int t_run, int row_delta,
                                                 int cs_n, int cs_t) {
  const long long cs = static_cast<long long>(cs_n) * cs_t;
  const long long t_in = t_in_cols(t_run, s_w, w_k);
  const long long nw = static_cast<long long>(t_run) * s_w;
  const long long col = static_cast<long long>(c_in) * h_k
                        * (nw < t_in ? nw : t_in);
  const long long row = static_cast<long long>(c_in)
                        * (row_delta ? s_h : h_k) * t_in;
  const long long box = col > row ? col : row;
  Layout l;
  l.share = ((box + cs - 1) / cs + SHARE_ALIGN - 1) / SHARE_ALIGN
            * SHARE_ALIGN;
  l.lam = static_cast<long long>(c_in) * h_k * w_k * (n / cs_n);
  l.window = static_cast<long long>(c_in) * h_k * t_in;
  l.pad = (SHARE_ALIGN - (l.lam + l.window) % SHARE_ALIGN) % SHARE_ALIGN;
  l.ring = RING * cs * l.share;
  const int split = k_split(t_run / cs_t, n / cs_n, c_in * h_k * w_k);
  l.parts = split > 1 ? 2LL * split * (t_run / cs_t) * (n / cs_n) : 0;
  return l;
}

// n / d for 0 <= n < 2^22 without an integer division: a float estimate,
// off by at most one, corrected both ways.
struct Div {
  int d;
  float inv;
  __device__ explicit Div(int d_)
      : d(d_), inv(1.0f / static_cast<float>(d_)) {}
  __device__ int quo(int n) const {
    int q = __float2int_rz(static_cast<float>(n) * inv);
    q -= q * d > n ? 1 : 0;
    q += (q + 1) * d <= n ? 1 : 0;
    return q;
  }
  __device__ int rem(int n) const { return n - quo(n) * d; }
};

// The box one step case fetches, C_in x rows x cols, flattened
// e = (c*rows + r)*cols + col, with the divisors that take e apart.
struct Shape {
  int rows, cols, elems;
  Div plane, by_cols, by_rows;
};

__device__ inline Shape make_shape(int c_in, int rows, int cols) {
  const int elems = c_in * rows * cols;
  return Shape{rows, cols, elems, Div(rows * cols), Div(cols), Div(rows)};
}

// Step (i, jt) of the sweep: which box it fetches, and where (all
// channels); `step_fetch_box` of kernels/conv2d_offload.py.  kind: 0 full,
// 1 row delta, 2 column delta.
struct Step {
  int kind, h0, w0;
};

__device__ inline Step step_of(int i, int jt, const PlannedArgs& a, int h_k,
                               int t_in) {
  const int nw = a.t_run * a.s_w;
  const int h0 = i * a.s_h;
  const int w0 = eff_tile(i, jt, a.tiles, a.zigzag) * nw;
  if (i > 0 && jt == 0 && a.row_delta) return {1, h0 + h_k - a.s_h, w0};
  if (jt > 0 && a.col_delta)
    return {2, h0, w0 + (t_in - nw) * moving_right(i, a.zigzag)};
  return {0, h0, w0};
}

// Rank r's share of a box of `elems` elements starts here (cs a power of
// two): `fetch_shares` of kernels/conv2d_offload.py.
__device__ inline int share_lo(int elems, int log_cs, int r) {
  return (r * elems) >> log_cs;
}

// A step's box placed in the input and in the window.  Input row h,
// column w lives in window slot (h % H_K, w % t_in); the box lies inside
// the step's window, so its rows and columns wrap around at most once.
struct Placed {
  Shape sh;
  int h0, w0, rbase, cbase;
  // input offset of box element e; its window slot in `at`
  __device__ long long locate(int e, const PlannedArgs& a, int h_k,
                              int t_in, int& at) const {
    const int c = sh.plane.quo(e);
    const int rem = e - c * sh.plane.d;
    const int r = sh.by_cols.quo(rem);
    const int col = rem - r * sh.cols;
    const int rs = rbase + r >= h_k ? rbase + r - h_k : rbase + r;
    const int cc = cbase + col >= t_in ? cbase + col - t_in : cbase + col;
    at = (c * h_k + rs) * t_in + cc;
    return (static_cast<long long>(c) * a.h_in + h0 + r) * a.w_in + w0 + col;
  }
};

// ------------------------------------------------------------------ PTX
// mbarriers, the cluster's shared-memory window, bulk copies.

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count) : "memory");
}

// arrive (release, this block), and expect `bytes` of pushes this phase
__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(bar) : "memory");
}

// the same shared-memory location in the block of cluster rank `rank`
__device__ inline uint32_t cluster_addr(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// arrive (release, cluster) on the mbarrier `bar` of cluster rank `rank`
__device__ inline void mbar_arrive_at(uint32_t bar, int rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      ::"r"(cluster_addr(bar, rank)) : "memory");
}

// wait until the phase of parity `parity` has completed, acquiring what
// the cluster released into it
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16) of this block's shared memory at `src` to
// the same place in cluster rank `rank`, completing on that block's
// mbarrier `bar` (an address in this block; both 16-byte aligned)
__device__ inline void push_to_rank(uint32_t src, uint32_t bytes,
                                    uint32_t bar, int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n"
      ::"r"(cluster_addr(src, rank)), "r"(src), "r"(bytes),
        "r"(cluster_addr(bar, rank)) : "memory");
}

// this thread's writes to shared memory, before the bulk copies that read
// it (the copies are of the asynchronous proxy)
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one float32 element, device memory -> shared memory (cp.async, 4 bytes)
__device__ inline void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// every cp.async of this thread has landed
__device__ inline void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// every thread of every block of the cluster
__device__ inline void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the eight compute warps only (named barrier 1)
__device__ inline void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
}

__device__ inline int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ inline int log2_pow2(int v) { return __ffs(v) - 1; }

__device__ inline uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Bytes a bulk copy of a share of `len` elements moves: whole 16 bytes.
template <typename T> __device__ inline uint32_t share_bytes(int len) {
  return (static_cast<uint32_t>(len) * sizeof(T) + 15u) & ~15u;
}

// ----------------------------------------------------------- delivery

// The service warp's share of a placed box, elements [lo, hi), from
// device memory: the first PRE elements a lane into registers (`take`,
// issued a step ahead, while the warp waits for the slot), then stored
// into the own slot at `mine` with the rest (`put`, loaded there).
constexpr int PRE = 8;

template <typename T>
struct Share {
  T v[PRE];
  int lo, hi;
};

template <typename T>
__device__ __forceinline__ void take(Share<T>& sh, const T* __restrict__ x,
                                     const PlannedArgs& a, const Placed& p,
                                     int lo, int hi, int lane, int h_k,
                                     int t_in) {
  sh.lo = lo;
  sh.hi = hi;
#pragma unroll
  for (int u = 0; u < PRE; ++u) {
    const int e = lo + lane + u * 32;
    int at;
    if (e < hi) sh.v[u] = x[p.locate(e, a, h_k, t_in, at)];
  }
}

// Returns how many elements this lane fetched.
template <typename T>
__device__ __forceinline__ unsigned put(const Share<T>& sh,
                                        const T* __restrict__ x,
                                        const PlannedArgs& a, const Placed& p,
                                        int lane, T* mine, int h_k,
                                        int t_in) {
  unsigned count = 0;
#pragma unroll
  for (int u = 0; u < PRE; ++u) {
    const int e = sh.lo + lane + u * 32;
    if (e < sh.hi) {
      mine[e - sh.lo] = sh.v[u];
      ++count;
    }
  }
  for (int e = sh.lo + lane + PRE * 32; e < sh.hi; e += 32) {
    int at;
    mine[e - sh.lo] = x[p.locate(e, a, h_k, t_in, at)];
    ++count;
  }
  return count;
}

// The compute threads splice a placed box from their own ring slot (share
// q at q * share_cap) into the window, an element a thread at a time: its
// box row and column by two divisions, its owner by comparing it with the
// shares' starts `lo` (no division).
template <typename T>
__device__ __forceinline__ void splice(T* win, const T* slot, const Placed& p,
                                       const int (&lo)[MAX_CLUSTER], int cs,
                                       int share_cap, int h_k, int t_in) {
  const Shape& sh = p.sh;
  for (int e = threadIdx.x; e < sh.elems; e += CT) {
    const int rr = sh.by_cols.quo(e);     // box row (c, r)
    const int col = e - rr * sh.cols;
    const int c = sh.by_rows.quo(rr);
    const int r = rr - c * sh.rows;
    const int rs = p.rbase + r >= h_k ? p.rbase + r - h_k : p.rbase + r;
    const int cc = p.cbase + col >= t_in ? p.cbase + col - t_in
                                         : p.cbase + col;
    int off = 0;                          // q * share_cap - lo[q]
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q)
      if (q < cs && e >= lo[q]) off = q * share_cap - lo[q];
    win[(c * h_k + rs) * t_in + cc] = slot[e + off];
  }
}

// --------------------------------------------------- float32 product

// How one step's product is cut: register tiles of RT output columns x
// RN kernel channels, KS compute threads (a power of two up to 32,
// consecutive lanes of one warp) per register tile, each summing a slice
// of the patch's (c, kh) rows.
struct Cut {
  int t_groups, n_tiles, ks;
};

__device__ inline Cut product_cut(int t_run, int nr, int units) {
  Cut cut;
  cut.t_groups = (t_run + RT - 1) / RT;
  cut.n_tiles = cut.t_groups * ((nr + RN - 1) / RN);
  int cap = CT / cut.n_tiles;
  cap = cap < 1 ? 1 : (cap > 32 ? 32 : cap);
  cap = cap > units ? units : cap;
  cut.ks = 1;
  while (cut.ks * 2 <= cap) cut.ks *= 2;
  return cut;
}

// RN = 8 Λ values of one row, 16-byte aligned.
__device__ inline void load_row(const float* p, float (&v)[RN]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}
__device__ inline void load_row(const __nv_bfloat16* p, float (&v)[RN]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// Rows of Λ a compute thread keeps in registers for the whole sweep: the
// first KEEP of the (c, kh) rows it sums at every step, read from shared
// memory once instead of at every step.
constexpr int KEEP = 2;

// A (c, kh) row's WK x RN Λ values of one register tile.  VEC: N/cs is a
// multiple of RN, and the row's RN values are 16-byte loads; otherwise
// nn[] holds the (clamped) channels.
template <typename T, int WK, bool VEC>
__device__ __forceinline__ void load_lam(float (&lv)[WK][RN], const T* lrow,
                                         int nr, int n0,
                                         const int (&nn)[RN]) {
#pragma unroll
  for (int kw = 0; kw < WK; ++kw) {
    if (VEC) {
      load_row(lrow + kw * nr + n0, lv[kw]);
    } else {
#pragma unroll
      for (int n = 0; n < RN; ++n) lv[kw][n] = to_f32(lrow[kw * nr + nn[n]]);
    }
  }
}

// Add one (c, kh) row of the patch times its Λ values to a register tile.
// col[t][kw] is the window slot column of output column t0 + t, tap kw;
// with S1 (stride-1 columns) col[0][j] serves tap kw of column t as
// j = t + kw, so the row's RT + WK - 1 window values are read once.
template <typename T, int WK, bool S1>
__device__ __forceinline__ void add_row(float (&acc)[RT][RN], const T* wrow,
                                        const float (&lv)[WK][RN],
                                        const int (&col)[RT][WK + RT]) {
  if (S1) {
    float wv[RT + WK - 1];
#pragma unroll
    for (int j = 0; j < RT + WK - 1; ++j) wv[j] = to_f32(wrow[col[0][j]]);
#pragma unroll
    for (int kw = 0; kw < WK; ++kw)
#pragma unroll
      for (int t = 0; t < RT; ++t)
#pragma unroll
        for (int n = 0; n < RN; ++n)
          acc[t][n] = fmaf(wv[t + kw], lv[kw][n], acc[t][n]);
  } else {
#pragma unroll
    for (int kw = 0; kw < WK; ++kw)
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const float wv = to_f32(wrow[col[t][kw]]);
#pragma unroll
        for (int n = 0; n < RN; ++n)
          acc[t][n] = fmaf(wv, lv[kw][n], acc[t][n]);
      }
  }
}

// The sums of the (c, kh) rows u = u0, u0 + du, ... of one register tile,
// for a kernel WK taps wide: the first `keep` rows with the Λ values in
// `kept`, the rest with Λ read from shared memory.
template <typename T, int WK, bool S1, bool VEC>
__device__ __forceinline__ void sum_rows(
    float (&acc)[RT][RN], const T* win, const T* lam,
    const float (&kept)[KEEP][WK][RN], int keep,
    const int (&col)[RT][WK + RT], const int (&nn)[RN], int u0, int du,
    int units, int h_k, int t_in, int rbase, int nr, int n0) {
  auto row_of = [&](int u) {
    const int c = u / h_k;
    const int kh = u - c * h_k;
    const int rs = rbase + kh >= h_k ? rbase + kh - h_k : rbase + kh;
    return win + (c * h_k + rs) * t_in;
  };
#pragma unroll
  for (int j = 0; j < KEEP; ++j) {
    const int u = u0 + j * du;
    if (j < keep && u < units) add_row<T, WK, S1>(acc, row_of(u), kept[j], col);
  }
  for (int u = u0 + keep * du; u < units; u += du) {
    float lv[WK][RN];
    load_lam<T, WK, VEC>(lv, lam + u * WK * nr, nr, n0, nn);
    add_row<T, WK, S1>(acc, row_of(u), lv, col);
  }
}

// The same for a kernel of any width: taps one by one.  cb[t] is the
// slot column of output column t0 + t's first tap.
template <typename T>
__device__ __forceinline__ void sum_rows_any(
    float (&acc)[RT][RN], const T* win, const T* lam, const int (&cb)[RT],
    const int (&nn)[RN], int u0, int du, int units, int h_k, int w_k,
    int t_in, int rbase, int nr) {
  for (int u = u0; u < units; u += du) {
    const int c = u / h_k;
    const int kh = u - c * h_k;
    const int rs = rbase + kh >= h_k ? rbase + kh - h_k : rbase + kh;
    const T* wrow = win + (c * h_k + rs) * t_in;
    const T* lrow = lam + u * w_k * nr;
    for (int kw = 0; kw < w_k; ++kw) {
      float lv[RN];
#pragma unroll
      for (int n = 0; n < RN; ++n) lv[n] = to_f32(lrow[kw * nr + nn[n]]);
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int cc = cb[t] + kw >= t_in ? cb[t] + kw - t_in : cb[t] + kw;
        const float wv = to_f32(wrow[cc]);
#pragma unroll
        for (int n = 0; n < RN; ++n) acc[t][n] = fmaf(wv, lv[n], acc[t][n]);
      }
    }
  }
}

// One halving exchange over lanes `off` apart: of the first M values a
// lane holds, it keeps the upper half if (ks & off), else the lower, and
// adds its partner's copy of that half; `base` follows the kept half.
template <int M>
__device__ __forceinline__ void halve(float (&v)[RT * RN], int ks, int off,
                                      int& base) {
  const bool up = (ks & off) != 0;
#pragma unroll
  for (int j = 0; j < M / 2; ++j) {
    const float lo = v[j];
    const float hi = v[j + M / 2];
    v[j] = (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, off);
  }
  base += up ? M / 2 : 0;
}

// Sum a register tile over its KS lanes (halving exchanges: 16 values over
// 32 lanes take 8 + 4 + 2 + 1 + 1 shuffles) and store it: afterwards a
// lane holds 16 / KS values (1 from KS = 16 on) from flat index `base`
// (t * RN + n) of the tile; with KS = 32 two lanes hold each value and only
// one stores it.  One instance per KS, so a step runs straight-line code
// with exactly the stores it makes.  o: the tile's first output (nullptr:
// no tile); t_left, n_left: its columns and channels inside the block.
template <int KS, typename T>
__device__ __forceinline__ void finish(float (&v)[RT * RN], int ks, T* o,
                                       int t_left, int n_left,
                                       long long plane_out) {
  static_assert(RT * RN == 16, "four halvings and one plain exchange");
  int base = 0;
  if (KS >= 2) halve<16>(v, ks, KS / 2, base);
  if (KS >= 4) halve<8>(v, ks, KS / 4, base);
  if (KS >= 8) halve<4>(v, ks, KS / 8, base);
  if (KS >= 16) halve<2>(v, ks, KS / 16, base);
  if (KS >= 32) {
    v[0] += __shfl_xor_sync(FULL, v[0], 1);
    if (ks & 1) return;
  }
  if (o == nullptr) return;
  constexpr int HELD = KS >= 16 ? 1 : 16 / KS;
#pragma unroll
  for (int j = 0; j < HELD; ++j) {
    const int t = (base + j) / RN;
    const int n = (base + j) % RN;
    if (t < t_left && n < n_left) o[n * plane_out + t] = from_f32<T>(v[j]);
  }
}

// A compute thread's place in the product, fixed for the sweep: lane ks
// of the KS that share a register tile, register tile `tile_id` of each
// pass of CT / KS tiles.
struct Lane {
  int ks, tile_id, per_pass;
  Div by_t_groups;
};

// Read into registers, once, the Λ values of the first KEEP (c, kh) rows
// a compute thread sums for its first pass's register tile.
template <typename T, int WK>
__device__ __forceinline__ void load_kept(float (&kept)[KEEP][WK][RN],
                                          const T* lam, const Cut& cut,
                                          const Lane& ln, int units, int nr) {
  const int rt = ln.tile_id;
  if (rt >= cut.n_tiles) return;
  const int n0 = ln.by_t_groups.quo(rt) * RN;
  int nn[RN];
#pragma unroll
  for (int n = 0; n < RN; ++n) nn[n] = n0 + n < nr ? n0 + n : nr - 1;
#pragma unroll
  for (int j = 0; j < KEEP; ++j) {
    const int u = ln.ks + j * cut.ks;
    if (u >= units) continue;
    if (nr % RN == 0)
      load_lam<T, WK, true>(kept[j], lam + u * WK * nr, nr, n0, nn);
    else
      load_lam<T, WK, false>(kept[j], lam + u * WK * nr, nr, n0, nn);
  }
}


// One step's float32 product of the window with this rank's Λ columns,
// for its ts = T/cs_t output columns, by the compute threads:
//   out[o_base + n*plane_out + t] =
//     sum_{c,kh,kw} win[c][(h0+kh) % h_k][(w0 + t*s_w + kw) % t_in]
//                   * lam[(c*h_k + kh)*w_k + kw][n]
// with h0 the step's first input row and w0 the rank's first input
// column; rbase = h0 % h_k and wbase = w0 % t_in are their window slots.
// HK, WK: the kernel's size as template constants (0: read from `a`).
template <typename T, int HK, int WK>
__device__ __forceinline__ void step_product(
    const T* __restrict__ win, const T* __restrict__ lam, T* __restrict__ out,
    const PlannedArgs& a, const Cut& cut, const Lane& ln, int t_in, int nr,
    int ts, long long o_base, long long plane_out, int rbase, int wbase,
    const float (&kept)[KEEP][WK > 0 ? WK : 1][RN]) {
  const int h_k = HK > 0 ? HK : a.h_k;
  const int w_k = WK > 0 ? WK : a.w_k;
  constexpr int WKA = WK > 0 ? WK : 1;
  const int units = a.c_in * h_k;
  for (int first = 0; first < cut.n_tiles; first += ln.per_pass) {
    // the kept Λ rows are those of the first pass's register tile
    const int keep = first == 0 ? KEEP : 0;
    const int rt = first + ln.tile_id;
    const bool live = rt < cut.n_tiles;
    const int tq = ln.by_t_groups.quo(live ? rt : 0);
    const int t0 = live ? (rt - tq * cut.t_groups) * RT : 0;
    const int n0 = tq * RN;
    float acc[RT][RN];
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int n = 0; n < RN; ++n) acc[t][n] = 0.0f;
    if (live) {
      int nn[RN];
#pragma unroll
      for (int n = 0; n < RN; ++n) nn[n] = n0 + n < nr ? n0 + n : nr - 1;
      // slot column of each output column's first tap (columns past
      // t_run are clamped: computed, never stored); every column of the
      // window lies less than t_in past its first
      int cb[RT];
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int tt = t0 + t < ts ? t0 + t : ts - 1;
        const int cc = wbase + tt * a.s_w;
        cb[t] = cc >= t_in ? cc - t_in : cc;
      }
      if (WK > 0) {
        int col[RT][WKA + RT];
        const bool s1 = a.s_w == 1 && t0 + RT <= ts;
        if (s1) {
#pragma unroll
          for (int j = 0; j < RT + WKA - 1; ++j) {
            const int cc = wbase + t0 + j;
            col[0][j] = cc >= t_in ? cc - t_in : cc;
          }
        } else {
#pragma unroll
          for (int t = 0; t < RT; ++t)
#pragma unroll
            for (int kw = 0; kw < WKA; ++kw)
              col[t][kw] = cb[t] + kw >= t_in ? cb[t] + kw - t_in
                                              : cb[t] + kw;
        }
        const bool vec = nr % RN == 0;
        if (s1 && vec)
          sum_rows<T, WKA, true, true>(acc, win, lam, kept, keep, col, nn,
                                       ln.ks, cut.ks, units, h_k, t_in, rbase,
                                       nr, n0);
        else if (s1)
          sum_rows<T, WKA, true, false>(acc, win, lam, kept, keep, col, nn,
                                        ln.ks, cut.ks, units, h_k, t_in,
                                        rbase, nr, n0);
        else if (vec)
          sum_rows<T, WKA, false, true>(acc, win, lam, kept, keep, col, nn,
                                        ln.ks, cut.ks, units, h_k, t_in,
                                        rbase, nr, n0);
        else
          sum_rows<T, WKA, false, false>(acc, win, lam, kept, keep, col, nn,
                                         ln.ks, cut.ks, units, h_k, t_in,
                                         rbase, nr, n0);
      } else {
        sum_rows_any<T>(acc, win, lam, cb, nn, ln.ks, cut.ks, units, h_k,
                        w_k, t_in, rbase, nr);
      }
    }
    float v[RT * RN];
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int n = 0; n < RN; ++n) v[t * RN + n] = acc[t][n];
    T* o = live ? out + o_base + n0 * plane_out + t0 : nullptr;
    const int t_left = ts - t0, n_left = nr - n0;
    switch (cut.ks) {   // the same for the whole launch
      case 1: finish<1>(v, ln.ks, o, t_left, n_left, plane_out); break;
      case 2: finish<2>(v, ln.ks, o, t_left, n_left, plane_out); break;
      case 4: finish<4>(v, ln.ks, o, t_left, n_left, plane_out); break;
      case 8: finish<8>(v, ln.ks, o, t_left, n_left, plane_out); break;
      case 16: finish<16>(v, ln.ks, o, t_left, n_left, plane_out); break;
      default: finish<32>(v, ln.ks, o, t_left, n_left, plane_out); break;
    }
  }
}


// -------------------------------------------------- bfloat16 product

// Where tap k = (c*h_k + kh)*w_k + kw of the patch lies in the window:
// the slot row's offset and kw.
template <int HK, int WK>
__device__ __forceinline__ void tap(int k, int h_k, int w_k, const Div& by_w,
                                    const Div& by_h, int rbase, int t_in,
                                    int& roff, int& kw) {
  const int u = WK > 0 ? k / WK : by_w.quo(k);
  kw = k - u * w_k;
  const int c = HK > 0 ? u / HK : by_h.quo(u);
  const int kh = u - c * h_k;
  const int rs = rbase + kh >= h_k ? rbase + kh - h_k : rbase + kh;
  roff = (c * h_k + rs) * t_in;
}

// One step's bfloat16 product on the tensor cores: the rank's (ts x K) x
// (K x nr) product as 16 x 8 tiles of mma.sync.m16n8k16 (rows: output
// columns, padded with zeros past ts; columns: kernel channels), f32
// sums.  Warp w takes tile w % tiles and the k chunks w / tiles, w / tiles
// + split, ...; without a split it stores its tile, rounded once, at
// `o` (the block's first output of the step), else it writes its partial
// into part[w / tiles] (channel-major, nr x ts each) for add_parts.
template <int HK, int WK>
__device__ __forceinline__ void step_product_mma(
    const __nv_bfloat16* __restrict__ win,
    const __nv_bfloat16* __restrict__ lam, float* part,
    __nv_bfloat16* __restrict__ o, long long plane_out, const PlannedArgs& a,
    int t_in, int nr, int ts, int split, int rbase, int wbase) {
  const int h_k = HK > 0 ? HK : a.h_k;
  const int w_k = WK > 0 ? WK : a.w_k;
  const int k_total = a.c_in * h_k * w_k;
  const Div by_w(w_k), by_h(h_k);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ntl = (nr + 7) >> 3;
  const int tiles = ((ts + 15) >> 4) * ntl;
  const int kc = (k_total + 15) >> 4;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int unit = warp; unit < tiles * split; unit += 8) {
    const int tile = unit % tiles, kg = unit / tiles;
    const int m0 = (tile / ntl) * 16, n0 = (tile % ntl) * 8;
    // the lane's two rows (output columns) and their first taps' slots
    int rows[2], cols[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rows[h] = m0 + gq + 8 * h;
      live[h] = rows[h] < ts;
      const int cc = wbase + (live[h] ? rows[h] : 0) * a.s_w;
      cols[h] = cc >= t_in ? cc - t_in : cc;
    }
    const int nb = n0 + gq;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kk = kg; kk < kc; kk += split) {
      uint32_t af[4], bf[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        __nv_bfloat16 av[2][2], bv[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int k = kk * 16 + 8 * half + 2 * t4 + p;
          const bool in_k = k < k_total;
          int roff = 0, kw = 0;
          if (in_k) tap<HK, WK>(k, h_k, w_k, by_w, by_h, rbase, t_in, roff, kw);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cc = cols[h] + kw >= t_in ? cols[h] + kw - t_in
                                                : cols[h] + kw;
            av[h][p] = in_k && live[h] ? win[roff + cc] : zero;
          }
          bv[p] = in_k && nb < nr ? lam[k * nr + nb] : zero;
        }
        af[2 * half] = pack2(av[0][0], av[0][1]);
        af[2 * half + 1] = pack2(av[1][0], av[1][1]);
        bf[half] = pack2(bv[0], bv[1]);
      }
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(bf[0]),
            "r"(bf[1]));
    }
    // c[2h + q]: row m0 + gq + 8h, channel n0 + 2*t4 + q
    float* mine = part + kg * nr * ts;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + 2 * t4 + q;
        if (!live[h] || n >= nr) continue;
        if (split == 1)
          o[n * plane_out + rows[h]] = __float2bfloat16_rn(c[2 * h + q]);
        else
          mine[n * ts + rows[h]] = c[2 * h + q];
      }
  }
}

// Add the `split` partial tiles of a step in a fixed order, round once and
// store at `o` (the block's first output of the step).
__device__ __forceinline__ void add_parts(const float* part,
                                          __nv_bfloat16* __restrict__ o,
                                          int nr, int ts, int split,
                                          long long plane_out) {
  const Div by_ts(ts);
  for (int idx = threadIdx.x; idx < nr * ts; idx += CT) {
    float sum = part[idx];
    for (int g = 1; g < split; ++g) sum += part[g * nr * ts + idx];
    const int n = by_ts.quo(idx);
    o[n * plane_out + idx - n * ts] = __float2bfloat16_rn(sum);
  }
}

// ------------------------------------------------------------- kernel

template <typename T, int HK, int WK>
__global__ void __launch_bounds__(PL_THREADS, 1)
conv2d_offload_planned_kernel(const T* __restrict__ x,
                              const T* __restrict__ lam_g,
                              T* __restrict__ out,
                              unsigned long long* fetched, PlannedArgs a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bars[2 * RING];
  __shared__ unsigned long long block_fetched;
  K1_PHASE(0);
  const int h_k = HK > 0 ? HK : a.h_k;
  const int w_k = WK > 0 ? WK : a.w_k;
  const int rank = cluster_rank();
  const int cs = a.cs_n * a.cs_t;
  const int log_cs = log2_pow2(cs), log_cs_t = log2_pow2(a.cs_t);
  const int grp = rank >> log_cs_t;          // channel group
  const int cgrp = rank - (grp << log_cs_t); // column group
  const int tid = threadIdx.x;
  const bool service = tid >= CT;
  const int t_in = t_in_cols(a.t_run, a.s_w, w_k);
  const int nr = a.n / a.cs_n;
  const int ts = a.t_run / a.cs_t;
  const int k_total = a.c_in * h_k * w_k;
  const Layout lay = planned_layout(a.c_in, a.n, h_k, w_k, a.s_h, a.s_w,
                                    a.t_run, a.row_delta, a.cs_n, a.cs_t);
  const int share_cap = static_cast<int>(lay.share);
  const int slot_elems = cs * share_cap;
  T* lam = reinterpret_cast<T*>(smem_raw);            // (k_total, nr)
  T* win = lam + lay.lam;                             // (C_in, H_K, t_in)
  T* ring = win + lay.window + lay.pad;               // from 16 bytes
  float* part = reinterpret_cast<float*>(ring + lay.ring);  // split x (nr, ts)
  const int split = k_split(ts, nr, k_total);
  const uint32_t full0 = smem_u32(&bars[0]);          // full[d]: + 8 d
  const uint32_t empty0 = smem_u32(&bars[RING]);      // empty[d]: + 8 d
  const Div by_h_k(h_k), by_t_in(t_in);
  const Shape full = make_shape(a.c_in, h_k, t_in);
  const Shape row = make_shape(a.c_in, a.s_h, t_in);
  const Shape col = make_shape(a.c_in, h_k, a.t_run * a.s_w);
  auto place = [&](const Step& st) {
    return Placed{st.kind == 0 ? full : (st.kind == 1 ? row : col), st.h0,
                  st.w0, by_h_k.rem(st.h0), by_t_in.rem(st.w0)};
  };
  if (tid == 0) {
    for (int d = 0; d < RING; ++d) {
      mbar_init(full0 + 8 * d, 32);   // the service warp's lanes
      mbar_init(empty0 + 8 * d, cs);  // one thread of each rank
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    block_fetched = 0;
  }
  // every block of the cluster has started (before any write into a
  // peer's shared memory), and its barriers are set up
  cluster_sync_all();

  // Before the sweep, by the compute threads: Λ's columns of this rank's
  // group (a (k_total, nr) block, flattened), the group's cs_t ranks each
  // fetching one share of it and writing it into all of them; and this
  // rank's share of step 0's box, into every rank's window.
  unsigned my_fetched = 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_steps = a.h_out * a.tiles;
  if (!service) {
    const int le = k_total * nr;
    const int lo = (cgrp * le) >> log_cs_t;
    const int hi = ((cgrp + 1) * le) >> log_cs_t;
    const Div by_nr(nr);
    const Placed b0 = place(step_of(0, 0, a, h_k, t_in));
    const int lo0 = share_lo(b0.sh.elems, log_cs, rank);
    const int hi0 = share_lo(b0.sh.elems, log_cs, rank + 1);
    // into the own block first, all of a thread's copies in flight at
    // once (float32: cp.async; bfloat16, 2 bytes: below its smallest
    // copy, ordinary loads, UP in flight), then from there to the peers
    if constexpr (F32) {
      for (int e = lo + tid; e < hi; e += CT) {
        const int k = by_nr.quo(e);
        copy_async(lam + e, lam_g + static_cast<long long>(k) * a.n
                                + grp * nr + (e - k * nr));
      }
      for (int e = lo0 + tid; e < hi0; e += CT) {
        int at;
        const long long src = b0.locate(e, a, h_k, t_in, at);
        copy_async(win + at, x + src);
      }
      copy_wait_all();
    } else {
      constexpr int UP = 8;
      for (int base = lo + tid; base < hi; base += UP * CT) {
        T v[UP];
#pragma unroll
        for (int u = 0; u < UP; ++u) {
          const int e = base + u * CT;
          const int k = by_nr.quo(e);
          if (e < hi)
            v[u] = lam_g[static_cast<long long>(k) * a.n + grp * nr
                         + (e - k * nr)];
        }
#pragma unroll
        for (int u = 0; u < UP; ++u)
          if (base + u * CT < hi) lam[base + u * CT] = v[u];
      }
      for (int base = lo0 + tid; base < hi0; base += UP * CT) {
        T v[UP];
        int at[UP];
#pragma unroll
        for (int u = 0; u < UP; ++u) {
          const int e = base + u * CT;
          if (e < hi0) v[u] = x[b0.locate(e, a, h_k, t_in, at[u])];
        }
#pragma unroll
        for (int u = 0; u < UP; ++u)
          if (base + u * CT < hi0) win[at[u]] = v[u];
      }
    }
    // each thread passes on the elements it fetched itself
    for (int e = lo + tid; e < hi; e += CT) {
      const T v = lam[e];
      for (int q = 1; q < a.cs_t; ++q)
        cluster.map_shared_rank(lam, (grp << log_cs_t)
                                         + ((cgrp + q) & (a.cs_t - 1)))[e] = v;
      ++my_fetched;
    }
    for (int e = lo0 + tid; e < hi0; e += CT) {
      int at;
      b0.locate(e, a, h_k, t_in, at);
      const T v = win[at];
      for (int q = 1; q < cs; ++q)
        cluster.map_shared_rank(win, (rank + q) & (cs - 1))[at] = v;
      ++my_fetched;
    }
  }
  // Λ and step 0's window are whole in every rank
  cluster_sync_all();
  K1_PHASE(1);

  if (service) {
    // the producer: steps 1.. into the ring, RING - 1 steps ahead at most;
    // each step's loads are issued before the wait for its slot
    K1_PHASE(16);
    const int lane = tid - CT;
    int i = 0, jt = 0;
    auto next = [&]() {
      if (++jt == a.tiles) {
        jt = 0;
        ++i;
      }
      return place(step_of(i, jt, a, h_k, t_in));
    };
    Share<T> sh;
    Placed p = place(step_of(0, 0, a, h_k, t_in));
    if (n_steps > 1) {
      p = next();
      take(sh, x, a, p, share_lo(p.sh.elems, log_cs, rank),
           share_lo(p.sh.elems, log_cs, rank + 1), lane, h_k, t_in);
    }
    for (int j = 0; j + 1 < n_steps; ++j) {
      const int d = j % RING;
      if (j >= RING) mbar_wait(empty0 + 8 * d, ((j / RING) - 1) & 1);
      K1_PHASE(17);
      T* mine = ring + d * slot_elems + rank * share_cap;
      my_fetched += put(sh, x, a, p, lane, mine, h_k, t_in);
      fence_proxy_async();
      __syncwarp();
      K1_PHASE(18);
      // lane q pushes the share into rank q; the own share is in
      // (release), the peers' pushes are expected
      const uint32_t bar = full0 + 8 * d;
      const int elems = p.sh.elems;
      if (lane < cs && lane != rank && sh.hi > sh.lo)
        push_to_rank(smem_u32(mine), share_bytes<T>(sh.hi - sh.lo), bar,
                     lane);
      if (lane == 0) {
        uint32_t bytes = 0;
        for (int q = 0; q < cs; ++q)
          if (q != rank)
            bytes += share_bytes<T>(share_lo(elems, log_cs, q + 1)
                                    - share_lo(elems, log_cs, q));
        mbar_expect_tx(bar, bytes);
      } else {
        mbar_arrive(bar);
      }
      if (j + 2 < n_steps) {
        p = next();
        take(sh, x, a, p, share_lo(p.sh.elems, log_cs, rank),
             share_lo(p.sh.elems, log_cs, rank + 1), lane, h_k, t_in);
      }
      K1_PHASE(19);
    }
    K1_PHASE(20);
  } else {
    // the float32 product's cut, and the Λ rows it keeps in registers
    float kept[KEEP][WK > 0 ? WK : 1][RN] = {};
    const Cut cut = product_cut(ts, nr, a.c_in * h_k);
    const int log_ks = __ffs(cut.ks) - 1;
    const Lane ln{tid & (cut.ks - 1), tid >> log_ks, CT >> log_ks,
                  Div(cut.t_groups)};
    if (F32 && WK > 0)  // Λ has landed
      load_kept<T, (WK > 0 ? WK : 1)>(kept, lam, cut, ln, a.c_in * h_k, nr);
    const long long plane_out =
        static_cast<long long>(a.h_out) * a.tiles * a.t_run;
    int i = 0, jt = 0;  // step s = i * tiles + jt
    for (int s = 0; s < n_steps; ++s) {
      if (s > 0) {
        const int j = s - 1, d = j % RING;
        mbar_wait(full0 + 8 * d, (j / RING) & 1);
        K1_PHASE(2);
        const Placed p = place(step_of(i, jt, a, h_k, t_in));
        int lo[MAX_CLUSTER];
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q)
          lo[q] = share_lo(p.sh.elems, log_cs, q);
        splice<T>(win, ring + d * slot_elems, p, lo, cs, share_cap, h_k,
                  t_in);
        K1_PHASE(3);
        compute_sync();             // the window is whole, the slot read
        K1_PHASE(4);
        // lanes of the last compute warp, which stores no output at the
        // layers here: a release has no stores of its own to wait for
        const int q = tid - (CT - 32);
        if (q >= 0 && q < cs) mbar_arrive_at(empty0 + 8 * d, q);
        K1_PHASE(5);
      }
      const int tile = eff_tile(i, jt, a.tiles, a.zigzag);
      const int w0 = (tile * a.t_run + cgrp * ts) * a.s_w;
      const long long o_base = grp * nr * plane_out
          + (static_cast<long long>(i) * a.tiles + tile) * a.t_run
          + cgrp * ts;
      const int rbase = by_h_k.rem(i * a.s_h), wbase = by_t_in.rem(w0);
      if constexpr (F32) {
        step_product<T, HK, WK>(win, lam, out, a, cut, ln, t_in, nr, ts,
                                o_base, plane_out, rbase, wbase, kept);
      } else {
        step_product_mma<HK, WK>(win, lam, part, out + o_base, plane_out, a,
                                 t_in, nr, ts, split, rbase, wbase);
        if (split > 1) {
          compute_sync();           // every warp's partial is in
          add_parts(part, out + o_base, nr, ts, split, plane_out);
        }
      }
      K1_PHASE(6);
      compute_sync();               // done with the window (and the parts)
      K1_PHASE(7);
      if (++jt == a.tiles) {
        jt = 0;
        ++i;
      }
    }
  }
  // no block leaves while a peer may still arrive on its barriers
  cluster_sync_all();
  K1_PHASE(15);
  K1_PHASE(23);

  // this block's fetches, added to the counter once
  unsigned long long mine = my_fetched;
  for (int off = 16; off > 0; off /= 2)
    mine += __shfl_down_sync(FULL, mine, off);
  if ((tid & 31) == 0) atomicAdd(&block_fetched, mine);
  __syncthreads();
  if (tid == 0) atomicAdd(fetched, block_fetched);
}

// A launch of cs blocks as one cluster along x.
struct Config {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  Config(int cs, int smem, cudaStream_t stream) {
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(PL_THREADS);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T>
using KernelFn = void (*)(const T*, const T*, T*, unsigned long long*,
                          PlannedArgs);

// 3x3 and 1x1 kernels have their own instances, every other size the
// generic one.
template <typename T>
KernelFn<T> kernel_for(int h_k, int w_k) {
  if (h_k == 3 && w_k == 3) return conv2d_offload_planned_kernel<T, 3, 3>;
  if (h_k == 1 && w_k == 1) return conv2d_offload_planned_kernel<T, 1, 1>;
  return conv2d_offload_planned_kernel<T, 0, 0>;
}

template <typename T>
cudaError_t launch(const void* x, const void* lam, void* out,
                   unsigned long long* fetched, const PlannedArgs& a,
                   int smem, cudaStream_t stream) {
  auto kern = kernel_for<T>(a.h_k, a.w_k);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Config conf(a.cs_n * a.cs_t, smem, stream);
  err = cudaLaunchKernelEx(&conf.cfg, kern, static_cast<const T*>(x),
                           static_cast<const T*>(lam), static_cast<T*>(out),
                           fetched, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int max_active_clusters(int h_k, int w_k, int cs, int smem) {
  auto kern = kernel_for<T>(h_k, w_k);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  Config conf(cs, smem, nullptr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kern, &conf.cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return count;
}

bool pow2_upto_8(int v) { return v >= 1 && v <= 8 && (v & (v - 1)) == 0; }

}  // namespace

// The cluster for n kernel channels and t_run output columns a step:
// cs_n the largest power of two up to 8 that divides n and leaves every
// channel group at least 8 channels; cs_t the largest power of two that
// divides t_run, leaves every block at least 4 columns and keeps
// cs_n * cs_t <= 8.  `conv_cluster_shape` of core/planner.py is the same
// rule.  Returns 0.
extern "C" int conv2d_offload_planned_cluster_shape(int n, int t_run,
                                                    int* cs_n, int* cs_t) {
  int cn = MAX_CLUSTER;
  while (cn > 1 && (n % cn != 0 || n / cn < MIN_CHANNELS)) cn /= 2;
  int ct = 1;
  while (cn * ct * 2 <= MAX_CLUSTER && t_run % (ct * 2) == 0
         && t_run / (ct * 2) >= MIN_COLUMNS)
    ct *= 2;
  *cs_n = cn;
  *cs_t = ct;
  return 0;
}

// Shared memory one block of a cluster of cs_n x cs_t allocates, in
// elements (Layout: its Λ columns, the window, the partial tiles, the
// ring).
// kernels/conv2d_offload.py's planned_smem_elements is this formula in
// Python (with the cluster of conv_cluster_shape).
extern "C" long long conv2d_offload_planned_smem_elements(
    int c_in, int n, int h_k, int w_k, int s_h, int s_w, int t_run,
    int row_delta, int cs_n, int cs_t) {
  return planned_layout(c_in, n, h_k, w_k, s_h, s_w, t_run, row_delta, cs_n,
                        cs_t).total();
}

// How many clusters of cs blocks with `smem` bytes of shared memory each
// fit on the card at once (cudaOccupancyMaxActiveClusters) for the kernel
// of an h_k x w_k layer; a negative cudaError_t on error.
extern "C" int conv2d_offload_planned_max_active_clusters(int dtype, int h_k,
                                                          int w_k, int cs,
                                                          int smem) {
  if (dtype == 0) return max_active_clusters<float>(h_k, w_k, cs, smem);
  if (dtype == 1)
    return max_active_clusters<__nv_bfloat16>(h_k, w_k, cs, smem);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16.  cs_n, cs_t: the cluster (powers of
// two, cs_n * cs_t <= 8, cs_n dividing n, cs_t dividing t_run); the
// wrapper passes conv2d_offload_planned_cluster_shape(n, t_run).  fetched:
// one int64 on the card, to which every block adds the elements it
// fetched.  Returns the cudaError_t of the launch (0 on success); a launch
// that is refused never runs, and only this code says so.  Does not
// synchronise.
extern "C" int conv2d_offload_planned_launch(
    const void* x, const void* lam, void* out, void* fetched, int dtype,
    int c_in, int h_in, int w_in, int n, int h_k, int w_k, int s_h, int s_w,
    int t_run, int h_out, int tiles, int zigzag, int row_delta,
    int col_delta, int cs_n, int cs_t, void* stream) {
  if (!pow2_upto_8(cs_n) || !pow2_upto_8(cs_t) || cs_n * cs_t > 8
      || n % cs_n != 0 || t_run % cs_t != 0)
    return cudaErrorInvalidValue;
  PlannedArgs a{c_in, h_in, w_in, n, h_k, w_k, s_h, s_w, t_run, h_out, tiles,
                zigzag, row_delta, col_delta, cs_n, cs_t};
  const int dtype_bytes = dtype == 0 ? 4 : 2;
  const long long smem =
      dtype_bytes * conv2d_offload_planned_smem_elements(
                        c_in, n, h_k, w_k, s_h, s_w, t_run, row_delta, cs_n,
                        cs_t);
  if (smem > REPRO_SMEM_LIMIT_BYTES) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* count = static_cast<unsigned long long*>(fetched);
  if (dtype == 0)
    return launch<float>(x, lam, out, count, a, static_cast<int>(smem), st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, lam, out, count, a,
                                 static_cast<int>(smem), st);
  return cudaErrorInvalidValue;
}
