#!/usr/bin/env python3
"""Where a step of the planned conv kernel (K1) spends its time, on the card.

    python3 tools/k1_phase_probe.py [--runs N]

Builds a copy of ``src/repro_torch/kernels/csrc/conv2d_offload_planned.cu``
with its ``K1_PHASE`` markers defined (the source in the repo is not
touched): thread 0 of rank 0 reads ``clock64()`` at each marker and adds
the differences up.  Then it launches the copy at each ResNet-8 layer's
planned shape (float32) through the wrapper's launch path, once as the
cluster the wrapper launches and once as a single block, checks the output
against the plain version, and prints the SM cycles per step of each phase:

  wait      the cluster barrier at the top of the step (and __syncthreads)
  assemble  the compute warps splice the step's shares into the window
  sync      the __syncthreads after the splice
  arrive    the compute warps' relaxed cluster arrive
  product   the step's product, reduction and stores

and the time per launch from CUDA events (Λ's transposition included, as
in the wrapper).  The timings are of warp 0 only; the other warps of the
block run the same phases.  Needs the card and ``nvcc``; imports nothing
of JAX.
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

# K1_PHASE(k) closes phase k; K1_PHASE(0) starts the clock
PHASES = (None, "setup", "wait", "assemble", "sync", "arrive", "product",
          "final")
PROBE = """
#include <cooperative_groups.h>
__device__ unsigned long long g_phase[8];
__device__ __forceinline__ void k1_phase(int k) {
  __shared__ long long acc[8];
  __shared__ long long last;
  if (threadIdx.x != 0 || cooperative_groups::this_cluster().block_rank())
    return;
  const long long t = clock64();
  if (k == 0)
    for (int q = 0; q < 8; ++q) acc[q] = 0;
  else
    acc[k] += t - last;
  last = t;
  if (k == 7)
    for (int q = 1; q < 8; ++q)
      atomicAdd(&g_phase[q], static_cast<unsigned long long>(acc[q]));
}
#define K1_PHASE(k) k1_phase(k)
#include "conv2d_offload_planned.cu"

extern "C" int probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  unsigned long long zero[8] = {0};
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
    sums = (ctypes.c_ulonglong * 8)()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; SM cycles per step of thread 0 of rank 0, "
          f"{runs} launches each")

    plan = plan_emitable_network(list(NETWORKS["resnet8"]),
                                 H100_SXM.as_hardware_model(dtype_bytes=4),
                                 name="resnet8")
    count = torch.zeros(1, dtype=torch.int64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for lp in plan.layers:
        em = emit_layer_kernel(lp)
        s = em.spec
        x = torch.randn(s.c_in, s.h_in, s.w_in, device="cuda",
                        generator=gen)
        k = torch.randn(s.c_out, s.c_in, s.h_k, s.w_k, device="cuda",
                        generator=gen)
        want = conv.conv2d_offload_planned_plain(x, k, t_run=em.t_run,
                                                 s_h=s.s_h, s_w=s.s_w,
                                                 order=em.order)
        steps = s.h_out * (s.w_out // em.t_run)
        for cs in sorted({planner.conv_cluster_size(s.c_out), 1},
                         reverse=True):
            def run():
                return conv._launch_planned(
                    x, k, t_run=em.t_run, s_h=s.s_h, s_w=s.s_w,
                    order=em.order, cs=cs, counter=count, launch=launch)
            out = run()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if err > 1e-3:
                raise SystemExit(f"layer {em.layer_index} cs={cs}: max abs "
                                 f"err {err} against the plain version")
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
            per = {p: sums[q] / runs / (1 if p in ("setup", "final")
                                        else steps)
                   for q, p in enumerate(PHASES) if p}
            print(f"L{em.layer_index} {s.c_in}x{s.h_in}x{s.w_in}->{s.c_out} "
                  f"t_run={em.t_run} cs={cs} steps={steps}: {ms:.4f} ms a "
                  f"launch, {ms * 1e3 / steps:.2f} us a step; cycles "
                  + " ".join(f"{p}={v:.0f}" for p, v in per.items()))


if __name__ == "__main__":
    main()
