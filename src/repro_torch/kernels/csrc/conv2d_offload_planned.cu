// S1 convolution, plan-shaped kernel: resident window, per-step I_slice
// deltas prefetched one step ahead, the sweep shared by a thread-block
// cluster over kernel-channel groups.
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
// the ordered sweep is a loop inside the block, and the one piece of the
// plan that splits cleanly, the kernel set Λ by output channel, is spread
// over a cluster of cs = conv_cluster_size(N) blocks on neighbouring SMs.
// Rank r keeps Λ's columns [r*N/cs, (r+1)*N/cs) in its shared memory for
// the whole sweep (Def 16), fetched once by itself, and writes those
// output channels.  Every rank needs the whole window, so each step's box
// is cut into cs disjoint shares (`share_lo`; `fetch_shares` in Python):
// rank r fetches share r with cp.async, on the first step straight into
// its own window, later into its own staging buffer (two, by step
// parity), and every rank assembles its replica of the window by reading
// its peers' shares through distributed shared memory.
//
// The window is indexed in place: input row h, column w lives in slot
// (h % H_K, w % t_in).  A window always covers H_K consecutive rows and
// t_in consecutive columns, so a delta lands exactly on the slots of the
// rows or columns it replaces and nothing kept ever moves.
//
// Warps.  Eight compute warps assemble the window and run the product;
// a ninth, the service warp, fetches this rank's share of the next step.
// One cluster barrier per step, split around the product:
//   wait      all shares of step s have landed; every peer has finished
//             reading the staging buffer this rank is about to refill
//   prefetch  (service warp) this rank's share of step s+1 into
//             staging[(s+1) & 1], while the compute warps assemble step s
//             into the own window; then __syncthreads
//   arrive    compute warps: relaxed, at once; service warp: after its
//             prefetch has landed and a cluster-scope fence, which
//             releases the whole block's writes and reads of the step
//   product   step s, while the fetch, the fence and the barrier complete
// A last wait before exit keeps every block alive while a peer may still
// read its shared memory.
//
// Product.  The block's (t_run, N/cs) output tile is cut into register
// tiles of 2 output columns x 8 kernel channels; the KS compute threads of
// one register tile (KS a power of two, up to 32, consecutive lanes of
// one warp) each sum a slice of the patch's (c, kh) rows into 16
// independent f32 FMA chains, then halve the tile between them by warp
// shuffles.  3x3 and 1x1 kernels are template constants, so the inner
// loops unroll; with stride-1 columns a patch row's window values are read
// once for all taps, and with N/cs a multiple of 8 a Λ row is two 16-byte
// loads.  Inputs are upcast to f32, the sum is f32, the store rounds once.
// The product runs on the ordinary f32 units, not on the tensor cores.
//
// What bounds it on an H100: neither the bytes nor the operations (both
// take well under a microsecond at the card's peak rates for the layers of
// the conv networks here) but the length of the sweep: h_out * tiles
// steps, each a cluster barrier, two block barriers, the window's
// assembly from the peers and the product, on cs of the card's 132 SMs.
//
// bfloat16 deltas may start at an odd element, which cp.async (4, 8 or 16
// aligned bytes) cannot copy: bfloat16 uses ordinary loads (in the service
// warp, so they stay off the compute warps' path).
#include <cooperative_groups.h>

#include "conv_common.cuh"

namespace cg = cooperative_groups;

// Phase markers: K1_PHASE(0) starts the clock, K1_PHASE(k) closes phase k
// of thread 0's step.  Empty here; tools/k1_phase_probe.py defines them to
// read the SM clock when it builds its copy of this kernel.
#ifndef K1_PHASE
#define K1_PHASE(k)
#endif

namespace {

constexpr int CT = 256;               // compute threads: warps 0-7
constexpr int PL_THREADS = CT + 32;   // and the service warp
constexpr int RT = 2;                 // output columns of a register tile
constexpr int RN = 8;                 // kernel channels of a register tile
constexpr unsigned FULL = 0xffffffffu;

struct PlannedArgs {
  int c_in, h_in, w_in, n, h_k, w_k, s_h, s_w, t_run, h_out, tiles;
  int zigzag, row_delta, col_delta, cs;
};

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
  Div plane, by_cols, by_elems;
};

__device__ inline Shape make_shape(int c_in, int rows, int cols) {
  const int elems = c_in * rows * cols;
  return Shape{rows, cols, elems, Div(rows * cols), Div(cols), Div(elems)};
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

// One element, device memory -> shared memory.
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
__device__ inline void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ inline void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

// Fetch elements [lo, hi) of a placed box, thread `first` of `stride`:
// into their window slots (stage == nullptr), or packed into `stage`.
// Returns how many this thread fetched.
template <typename T>
__device__ __forceinline__ unsigned fetch_share(
    const T* __restrict__ x, const PlannedArgs& a, const Placed& p, int lo,
    int hi, int first, int stride, T* win, T* stage, int h_k, int t_in) {
  unsigned count = 0;
  for (int e = lo + first; e < hi; e += stride) {
    int at;
    const long long src = p.locate(e, a, h_k, t_in, at);
    fetch_async(stage ? stage + (e - lo) : win + at, x + src);
    ++count;
  }
  return count;
}

// The compute threads splice every rank's share of a placed box into the
// own window: on the first step from the peers' windows (the shares sit
// in their slots there), later from each rank's staging buffer of this
// step's parity.  U elements a thread are read (most from other SMs)
// before any is written, so their latencies overlap.
template <typename T>
__device__ __forceinline__ void assemble(T* win, T* stage, const Placed& p,
                                         bool first, const PlannedArgs& a,
                                         int rank, int log_cs, int h_k,
                                         int t_in) {
  constexpr int U = 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int elems = p.sh.elems;
  for (int base = threadIdx.x; base < elems; base += U * CT) {
    T v[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * CT;
      at[u] = -1;
      if (e < elems) {
        int slot_e;
        p.locate(e, a, h_k, t_in, slot_e);
        const int q = p.sh.by_elems.quo((e + 1) * a.cs - 1);  // the owner
        if (!(first && q == rank)) {
          const T* src =
              first ? cluster.map_shared_rank(win, q) + slot_e
                    : (q == rank ? stage : cluster.map_shared_rank(stage, q))
                          + (e - share_lo(elems, log_cs, q));
          v[u] = *src;
          at[u] = slot_e;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (at[u] >= 0) win[at[u]] = v[u];
  }
}

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

// Sum a register tile over its KS lanes: halving exchanges, so 16 values
// over 32 lanes take 8 + 4 + 2 + 1 + 1 shuffles.  Afterwards the lane
// holds `held` values starting at flat index `base` (t * RN + n) of the
// tile; with KS = 32 two lanes hold each value and only the one with
// `dup` false stores it.
__device__ __forceinline__ void reduce_tile(float (&v)[RT * RN], int ks,
                                            int nks, int& base, int& held,
                                            bool& dup) {
  static_assert(RT * RN == 16, "four halvings and one plain exchange");
  base = 0;
  held = RT * RN;
  dup = false;
  if (nks >= 2) { halve<16>(v, ks, nks / 2, base); held = 8; }
  if (nks >= 4) { halve<8>(v, ks, nks / 4, base); held = 4; }
  if (nks >= 8) { halve<4>(v, ks, nks / 8, base); held = 2; }
  if (nks >= 16) { halve<2>(v, ks, nks / 16, base); held = 1; }
  if (nks >= 32) {
    v[0] += __shfl_xor_sync(FULL, v[0], 1);
    dup = (ks & 1) != 0;
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

// Step (i, tile)'s product of the window with this rank's Λ columns, by
// the compute threads:
//   out[ch0 + n][i][tile*t_run + t] =
//     sum_{c,kh,kw} win[c][(h0+kh) % h_k][(w0 + t*s_w + kw) % t_in]
//                   * lam[(c*h_k + kh)*w_k + kw][n]
// with h0 = i*s_h and w0 = tile*t_run*s_w; rbase = h0 % h_k and
// wbase = w0 % t_in are the window's first slot row and column.
// HK, WK: the kernel's size as template constants (0: read from `a`).
template <typename T, int HK, int WK>
__device__ __forceinline__ void step_product(
    const T* __restrict__ win, const T* __restrict__ lam, T* __restrict__ out,
    const PlannedArgs& a, const Cut& cut, const Lane& ln, int t_in, int nr,
    int ch0, int i, int tile, int rbase, int wbase,
    const float (&kept)[KEEP][WK > 0 ? WK : 1][RN]) {
  const int h_k = HK > 0 ? HK : a.h_k;
  const int w_k = WK > 0 ? WK : a.w_k;
  constexpr int WKA = WK > 0 ? WK : 1;
  const int units = a.c_in * h_k;
  const int plane_out = a.h_out * a.tiles * a.t_run;
  const int at_step = i * a.tiles * a.t_run + tile * a.t_run;
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
        const int tt = t0 + t < a.t_run ? t0 + t : a.t_run - 1;
        const int cc = wbase + tt * a.s_w;
        cb[t] = cc >= t_in ? cc - t_in : cc;
      }
      if (WK > 0) {
        int col[RT][WKA + RT];
        const bool s1 = a.s_w == 1 && t0 + RT <= a.t_run;
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
    int base, held;
    bool dup;
    reduce_tile(v, ln.ks, cut.ks, base, held, dup);
    if (live && !dup) {
      T* o = out + (ch0 + n0) * plane_out + at_step + t0;
      if (held == 1) {
        const int t = base / RN;
        const int n = base % RN;
        if (t0 + t < a.t_run && n0 + n < nr)
          o[n * plane_out + t] = from_f32<T>(v[0]);
      } else {
#pragma unroll
        for (int j = 0; j < RT * RN; ++j) {
          const int t = (base + j) / RN;
          const int n = (base + j) % RN;
          if (j < held && t0 + t < a.t_run && n0 + n < nr)
            o[n * plane_out + t] = from_f32<T>(v[j]);
        }
      }
    }
  }
}

// Elements of one of a block's two staging buffers: its share of the
// largest box a step after the first fetches.
__host__ __device__ inline long long staging_elements(
    int c_in, int h_k, int w_k, int s_h, int s_w, int t_run, int row_delta,
    int cs) {
  const long long t_in = t_in_cols(t_run, s_w, w_k);
  const long long nw = static_cast<long long>(t_run) * s_w;
  const long long col = static_cast<long long>(c_in) * h_k
                        * (nw < t_in ? nw : t_in);
  const long long row = static_cast<long long>(c_in)
                        * (row_delta ? s_h : h_k) * t_in;
  const long long box = col > row ? col : row;
  return (box + cs - 1) / cs;
}

template <typename T, int HK, int WK>
__global__ void __launch_bounds__(PL_THREADS, 1)
conv2d_offload_planned_kernel(const T* __restrict__ x,
                              const T* __restrict__ lam_g,
                              T* __restrict__ out,
                              unsigned long long* fetched, PlannedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long block_fetched;
  const int h_k = HK > 0 ? HK : a.h_k;
  const int w_k = WK > 0 ? WK : a.w_k;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x;
  const bool service = tid >= CT;
  const int t_in = t_in_cols(a.t_run, a.s_w, w_k);
  const int nr = a.n / a.cs;
  const int k_total = a.c_in * h_k * w_k;
  const int log_cs = a.cs == 8 ? 3 : (a.cs == 4 ? 2 : (a.cs == 2 ? 1 : 0));
  const int stage_elems = static_cast<int>(staging_elements(
      a.c_in, h_k, w_k, a.s_h, a.s_w, a.t_run, a.row_delta, a.cs));

  T* lam = reinterpret_cast<T*>(smem_raw);  // (k_total, nr)
  T* win = lam + k_total * nr;              // (C_in, H_K, t_in) slots
  T* stage = win + a.c_in * h_k * t_in;     // two of stage_elems each
  const Cut cut = product_cut(a.t_run, nr, a.c_in * h_k);
  const int log_ks = __ffs(cut.ks) - 1;
  const Lane ln{tid & (cut.ks - 1), tid >> log_ks, CT >> log_ks,
                Div(cut.t_groups)};
  const Div by_h_k(h_k), by_t_in(t_in);
  const Shape full = make_shape(a.c_in, h_k, t_in);
  const Shape row = make_shape(a.c_in, a.s_h, t_in);
  const Shape col = make_shape(a.c_in, h_k, a.t_run * a.s_w);
  auto place = [&](const Step& st) {
    return Placed{st.kind == 0 ? full : (st.kind == 1 ? row : col), st.h0,
                  st.w0, by_h_k.rem(st.h0), by_t_in.rem(st.w0)};
  };
  if (tid == 0) block_fetched = 0;

  // K_sub of the first step: this rank's columns of Λ, once; and this
  // rank's share of the first box, into its window slots.
  unsigned my_fetched = 0;
  K1_PHASE(0);
  const Div by_nr(nr);
  for (int e = tid; e < k_total * nr; e += PL_THREADS) {
    const int k = by_nr.quo(e);
    fetch_async(lam + e, lam_g + static_cast<long long>(k) * a.n
                             + rank * nr + (e - k * nr));
    ++my_fetched;
  }
  const int n_steps = a.h_out * a.tiles;
  Placed box = place(step_of(0, 0, a, h_k, t_in));
  my_fetched += fetch_share<T>(
      x, a, box, share_lo(box.sh.elems, log_cs, rank),
      share_lo(box.sh.elems, log_cs, rank + 1), tid, PL_THREADS, win, nullptr,
      h_k, t_in);
  fetch_commit();
  fetch_wait();
  cluster_arrive_release();
  K1_PHASE(1);

  float kept[KEEP][WK > 0 ? WK : 1][RN] = {};
  int i = 0, jt = 0;  // step s = i * tiles + jt
  for (int s = 0; s < n_steps; ++s) {
    const int i_next = jt + 1 == a.tiles ? i + 1 : i;
    const int jt_next = jt + 1 == a.tiles ? 0 : jt + 1;
    // every share of step s has landed; every peer is done with the
    // staging buffer refilled below, and this block with its last product
    cluster_wait();
    __syncthreads();
    K1_PHASE(2);
    if (WK > 0 && s == 0 && !service)  // Λ has landed
      load_kept<T, (WK > 0 ? WK : 1)>(kept, lam, cut, ln, a.c_in * h_k, nr);
    if (service) {
      // the service warp prefetches this rank's share of step s+1 while
      // the compute warps assemble step s
      if (s + 1 < n_steps) {
        const Placed nb = place(step_of(i_next, jt_next, a, h_k, t_in));
        my_fetched += fetch_share<T>(
            x, a, nb, share_lo(nb.sh.elems, log_cs, rank),
            share_lo(nb.sh.elems, log_cs, rank + 1), tid - CT, 32, win,
            stage + ((s + 1) & 1) * stage_elems, h_k, t_in);
        fetch_commit();
      }
    } else {
      assemble<T>(win, stage + (s & 1) * stage_elems, box, s == 0, a, rank,
                  log_cs, h_k, t_in);
      K1_PHASE(3);
    }
    __syncthreads();
    K1_PHASE(4);
    if (service) {
      // release for the whole block: its prefetched share has landed, and
      // (ordered by the barrier above) its reads of the peers' shares are
      // done; the compute warps go on to the product meanwhile
      fetch_wait();
      fence_cluster();
      cluster_arrive_relaxed();
    } else {
      cluster_arrive_relaxed();
      K1_PHASE(5);
      const int tile = eff_tile(i, jt, a.tiles, a.zigzag);
      step_product<T, HK, WK>(win, lam, out, a, cut, ln, t_in, nr, rank * nr,
                              i, tile, by_h_k.rem(i * a.s_h),
                              by_t_in.rem(tile * a.t_run * a.s_w), kept);
      K1_PHASE(6);
    }
    if (s + 1 < n_steps) box = place(step_of(i_next, jt_next, a, h_k, t_in));
    i = i_next;
    jt = jt_next;
  }
  // no block leaves while a peer may still read its shared memory
  cluster_wait();
  K1_PHASE(7);

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
  Config conf(a.cs, smem, stream);
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

}  // namespace

// Blocks of a cluster for n kernel channels: the largest power of two up
// to 8 that divides n and leaves every block at least 8 channels.
// `conv_cluster_size` of core/planner.py is the same rule.
extern "C" int conv2d_offload_planned_cluster_size(int n) {
  int cs = 8;
  while (cs > 1 && (n % cs != 0 || n / cs < 8)) cs /= 2;
  return cs;
}

// Shared memory one block of a cluster of cs allocates, in elements: its
// n/cs columns of Λ, the window, and two staging buffers for its share of
// a step's box.  kernels/conv2d_offload.py's planned_smem_elements is this
// formula in Python (with cs = conv_cluster_size(n)).
extern "C" long long conv2d_offload_planned_smem_elements(
    int c_in, int n, int h_k, int w_k, int s_h, int s_w, int t_run,
    int row_delta, int cs) {
  const long long t_in = t_in_cols(t_run, s_w, w_k);
  return static_cast<long long>(c_in) * h_k * w_k * n / cs    // Λ share
         + static_cast<long long>(c_in) * h_k * t_in          // window
         + 2 * staging_elements(c_in, h_k, w_k, s_h, s_w, t_run, row_delta,
                                cs);
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

// dtype: 0 = float32, 1 = bfloat16.  cs: blocks of the cluster (1, 2, 4
// or 8, dividing n); the wrapper passes conv2d_offload_planned_cluster_size
// (n).  fetched: one int64 on the card, to which every block adds the
// elements it fetched.  Returns the cudaError_t of the launch (0 on
// success); a launch that is refused never runs, and only this code says
// so.  Does not synchronise.
extern "C" int conv2d_offload_planned_launch(
    const void* x, const void* lam, void* out, void* fetched, int dtype,
    int c_in, int h_in, int w_in, int n, int h_k, int w_k, int s_h, int s_w,
    int t_run, int h_out, int tiles, int zigzag, int row_delta,
    int col_delta, int cs, void* stream) {
  if (cs < 1 || cs > 8 || (cs & (cs - 1)) != 0 || n % cs != 0)
    return cudaErrorInvalidValue;
  PlannedArgs a{c_in, h_in, w_in, n, h_k, w_k, s_h, s_w, t_run, h_out, tiles,
                zigzag, row_delta, col_delta, cs};
  const int dtype_bytes = dtype == 0 ? 4 : 2;
  const long long smem =
      dtype_bytes * conv2d_offload_planned_smem_elements(
                        c_in, n, h_k, w_k, s_h, s_w, t_run, row_delta, cs);
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
