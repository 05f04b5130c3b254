#!/usr/bin/env python3
"""Where a step of the planned conv kernel (K1) spends its time, on the card.

    python3 tools/k1_phase_probe.py [--runs N]

Builds a copy of ``src/repro_torch/kernels/csrc/conv2d_offload_planned.cu``
with its ``K1_PHASE`` markers defined (the source in the repo is not
touched): thread 0 of rank 0 reads ``clock64()`` at each marker and adds
the differences up, and so does lane 0 of its service warp.  Then it
launches the copy at each ResNet-8 layer's planned shape, in float32 and
bfloat16, through the wrapper's launch path, once as the cluster the
wrapper launches and once as a single block, checks the output against
the plain version, and prints the SM cycles per step of each phase of
the compute warps' step:

  wait      the wait on the ring slot's full barrier
  splice    the compute warps splice the step's box into the window
  bar       their barrier after the splice
  arrive    the arrivals on every rank's empty barrier (threads 0..cs-1)
  product   the step's product and its stores (bfloat16: the tensor-core
            tiles, a barrier, the rounded stores)
  end_bar   the barrier after the product

and of the service warp's fill of a ring slot:

  empty   the wait on the slot's empty barrier
  fetch   the share's loads from device memory into the own slot
  push    the arrival on the own full barrier and the share's pushes
          into the peers' slots

with `setup` (before the sweep: barriers, Λ and step 0's window, two
cluster barriers) and `final` (the last cluster barrier) per launch, and
the time per launch from CUDA events (Λ's transposition included, as in
the wrapper).  The timings are of thread 0 and of lane 0 of the service
warp of rank 0 only; the other warps run the same phases.  Needs the card
and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# K1_PHASE(k) closes phase k; K1_PHASE(0) starts thread 0's clock and
# K1_PHASE(8) the service warp's
PHASES = {1: "setup", 2: "wait", 3: "splice", 4: "bar", 5: "arrive",
          6: "product", 7: "end_bar", 15: "final", 17: "empty", 18: "fetch",
          19: "push", 23: "service_final"}
PER_LAUNCH = ("setup", "final", "service_final")
# the gpu tests' tolerances: f32 sums in another order; one bf16 rounding
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1.6e-2, 1e-2)}
PROBE = """
#include <cooperative_groups.h>
__device__ unsigned long long g_phase[24];
__device__ __forceinline__ void k1_phase(int k) {
  __shared__ long long acc[24];
  __shared__ long long last[2];
  const int role = k < 16 ? 0 : 1;
  if (threadIdx.x != (role ? 256 : 0)
      || cooperative_groups::this_cluster().block_rank())
    return;
  const long long t = clock64();
  if (k == 0 || k == 16)
    for (int q = k; q < k + 8 + 8 * (1 - role); ++q) acc[q] = 0;
  else
    acc[k] += t - last[role];
  last[role] = t;
  if (k == 15 || k == 23)   // each role adds its own phases up
    for (int q = role ? 17 : 1; q <= k; ++q)
      atomicAdd(&g_phase[q], static_cast<unsigned long long>(acc[q]));
}
#define K1_PHASE(k) k1_phase(k)
#include "conv2d_offload_planned.cu"

extern "C" int probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  unsigned long long zero[24] = {0};
  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=20)
    runs = parser.parse_args().runs

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on the card only")
    from repro_torch.configs.networks import NETWORKS
    from repro_torch.core import planner
    from repro_torch.core.cost_model import H100_SXM
    from repro_torch.kernels import _build
    from repro_torch.kernels import conv2d_offload as conv
    from repro_torch.kernels.emit import (emit_layer_kernel,
                                          plan_emitable_network)

    csrc = ROOT / "src/repro_torch/kernels/csrc"
    work = pathlib.Path(tempfile.mkdtemp(prefix="k1_probe_"))
    src = work / "k1_probe.cu"
    src.write_text(PROBE)
    lib_path = work / "libk1_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    launch = lib.conv2d_offload_planned_launch
    launch.argtypes = conv.PLANNED_ARGTYPES
    launch.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * 24)()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; SM cycles per step of thread 0 and of the "
          f"service warp's lane 0 of rank 0 (setup and final: per launch), "
          f"{runs} launches each")

    plan = plan_emitable_network(list(NETWORKS["resnet8"]),
                                 H100_SXM.as_hardware_model(dtype_bytes=4),
                                 name="resnet8")
    count = torch.zeros(1, dtype=torch.int64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for lp in plan.layers:
            em = emit_layer_kernel(lp)
            s = em.spec
            x = torch.randn(s.c_in, s.h_in, s.w_in, device="cuda",
                            generator=gen).to(dtype)
            k = torch.randn(s.c_out, s.c_in, s.h_k, s.w_k, device="cuda",
                            generator=gen).to(dtype)
            steps = s.h_out * (s.w_out // em.t_run)
            for cluster in (planner.conv_cluster_shape(s.c_out, em.t_run),
                            (1, 1)):
                want = conv.conv2d_offload_planned_plain(
                    x, k, t_run=em.t_run, s_h=s.s_h, s_w=s.s_w,
                    order=em.order, cluster=cluster)

                def run():
                    return conv.planned_launch(
                        x, k, t_run=em.t_run, s_h=s.s_h, s_w=s.s_w,
                        order=em.order, cluster=cluster, counter=count,
                        launch=launch).run(x, k, conv._lambda_matrix)
                out = run()
                torch.cuda.synchronize()
                rtol, atol = TOL[str(dtype)[6:]]
                err = (out.float() - want.float()).abs()
                if bool((err > atol + rtol * want.float().abs()).any()):
                    raise SystemExit(f"layer {em.layer_index} {cluster}: "
                                     f"max abs err {err.max().item()} "
                                     f"against the plain version")
                lib.probe_read(sums)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(runs):
                    run()
                end.record()
                torch.cuda.synchronize()
                lib.probe_read(sums)
                ms = start.elapsed_time(end) / runs
                per = {p: sums[q] / runs / (1 if p in PER_LAUNCH else steps)
                       for q, p in PHASES.items()}
                print(f"L{em.layer_index} {s.c_in}x{s.h_in}x{s.w_in}->"
                      f"{s.c_out} {str(dtype)[6:]} t_run={em.t_run} "
                      f"cluster={cluster[0]}x{cluster[1]} steps={steps}: "
                      f"{ms:.4f} ms a launch, {ms * 1e3 / steps:.2f} us a "
                      f"step; cycles "
                      + " ".join(f"{p}={v:.0f}" for p, v in per.items()),
                      flush=True)


if __name__ == "__main__":
    main()
