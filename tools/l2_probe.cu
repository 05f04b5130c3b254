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
