#!/usr/bin/env python3
"""Where a step of the block GeMM kernels' wgmma core (K3, K4) spends its
time, on the card.

    python3 tools/k34_phase_probe.py [--runs N] [--square] [--push]
                                     [--picks FILE] [--json PATH]

At TinyLlama-1.1B's four prefill projections (m = 4 x 480, bfloat16, the
planner's tiles and K3 cluster) it times K3 (order mnk) and K4 (the
planner's order, or mkn where the planner picks K3, on the planner's tiles
where K4 fits them and 128 x 128 x 128 where it does not) through
``kernels.block_matmul`` with CUDA events, beside ``torch.matmul``.  With
``--square`` it adds K3 at 8192^3 on the planner's plan and on 64-deep
tiles, clustered and not.  Then it builds a copy of
``src/repro_torch/kernels/csrc/block_matmul.cu`` with its ``MM_PHASE``
markers defined (the source in the repo is not touched), loads it in the
wrapper's place, checks the output against the plain version's, and
prints the SM cycles per step of each phase of a consumer step, read by
thread 0 of every block (warp 0 of warpgroup 0) with ``clock64()``:

  wait A   the full barrier of the step's new A tile (in K4's cluster
           at n innermost, the tile rank 0 pushes)
  wait B   the full barrier of the step's new B tile
  product  the warpgroup products over bk (issue and wait)
  partial  K4: the wait for the partial C tile fetched one step ahead,
           and its add; K3: the add to the accumulator
  store    the stores (f32 partial or the cast C tile) and, in K4, the
           next step's partial fetch issued

beside the SM clock the steps ran at: the phases' ``clock64()`` cycles
over their ``%globaltimer`` nanoseconds.  ``--push`` adds K4 at
1920 x 2048 -> 256 on 64 x 32 x 512 ``mkn`` tiles in a cluster of 8,
where a step waits for rank 0's 64 KB A tile pushed to its 7 peers, and
prints the bytes a second one SM pushes (``GpuChipModel.push_bw``): the
pushed bytes over the wait, turned into seconds at that clock.

``--picks FILE`` times the block GeMM kernel on ``plan_matmul``'s pick
beside another pick of the same product, in turns (this, other, other,
this; the kernel's device time by ``torch.profiler``, or CUDA events
where the trace has none), with A and B padded to the tiles as
``ops.matmul`` pads them: FILE is a JSON list of ``{"shape": [m, n, k],
"tiles": {...}, "order": ..., "cluster": [cm, cn]}`` (bf16, or
``"dtype_bytes": 4``), e.g. a parent checkout's picks::

    PYTHONPATH=_parent/src python3 -c "import json; from repro_torch.core \
      import planner as P; print(json.dumps([dict(shape=s, tiles=p.tiles, \
      order=p.order, cluster=p.cluster) for s in ([1920, 2048, 2048],) \
      for p in [P.plan_matmul(*s, 2)]]))" > _parent/picks.json

Needs the card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("wait A", "wait B", "product", "partial", "store")
PREFILL_M = 4 * 480
PREFILL_KN = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]
# MM_PHASE(0) opens a step (and counts it), MM_PHASE(k) closes phase k
# and its %globaltimer nanoseconds beside its cycles
PROBE = """
__device__ unsigned long long g_phase[12];
__device__ __forceinline__ void mm_phase(int k) {
  __shared__ long long last, last_ns;
  if (threadIdx.x != 0) return;
  const long long t = clock64();
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  if (k) {
    atomicAdd(&g_phase[k], static_cast<unsigned long long>(t - last));
    atomicAdd(&g_phase[6 + k], static_cast<unsigned long long>(ns - last_ns));
  } else {
    atomicAdd(&g_phase[0], 1ull);
  }
  last = t;
  last_ns = ns;
}
#define MM_PHASE(k) mm_phase(k)
#include "block_matmul.cu"

extern "C" int probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  unsigned long long zero[12] = {0};
  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""
# --push: K4 where rank 0 pushes a 64 KB A tile to 7 peers (k, n; tiles)
PUSH_KN, PUSH_TILES = (2048, 256), {"bm": 64, "bn": 32, "bk": 512}


def pad_to(x, rows: int, cols: int):
    """``x`` padded with zeros to multiples of ``rows`` x ``cols``."""
    import torch.nn.functional as F
    return F.pad(x, (0, -x.shape[1] % cols, 0, -x.shape[0] % rows)
                 ).contiguous()


def device_ms(fn, calls: int, ms_of) -> tuple[float, str]:
    """Device time a call of the block GeMM kernels that ``fn`` launches,
    from ``torch.profiler`` over ``calls`` calls; CUDA-event time a call
    where the trace shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if "block_matmul" in ev.key and "kernel" in ev.key:
            total += us
    if total > 0:
        return total / 1e3 / calls, "device"
    return ms_of(fn), "events"


def time_picks(path: str, ms_of, calls: int) -> list[dict]:
    """The block GeMM kernel on ``plan_matmul``'s pick and on the pick in
    ``path`` of each product there, in turns (this, other, other,
    this)."""
    import torch
    from repro_torch.core import planner
    from repro_torch.kernels import block_matmul as bmm
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for other in json.loads(pathlib.Path(path).read_text()):
        m, n, k = other["shape"]
        eb = other.get("dtype_bytes", 2)
        dtype = torch.bfloat16 if eb == 2 else torch.float32
        a = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
        b = (torch.randn(k, n, device="cuda", generator=gen)
             / k ** 0.5).to(dtype)
        p = planner.plan_matmul(m, n, k, eb)
        picks = {"this": (p.tiles, p.order, tuple(p.cluster)),
                 "other": (other["tiles"], other["order"],
                           tuple(other["cluster"]))}
        same = picks["this"] == picks["other"]
        runs = {}
        for which, (t, order, cl) in picks.items():
            pa, pb = pad_to(a, t["bm"], t["bk"]), pad_to(b, t["bk"], t["bn"])
            want = torch.matmul(a.float(), b.float())
            got = bmm.block_matmul(pa, pb, order=order, cluster=cl,
                                   **t)[:m, :n].float()
            err = (got - want).abs().max().item()
            if err > 1e-2 + 1.6e-2 * want.abs().max().item():
                raise SystemExit(f"K3 {m}x{k}x{n} on {picks[which]}: max "
                                 f"abs err {err}")
            runs[which] = (lambda pa=pa, pb=pb, t=t, o=order, c=cl:
                           bmm.block_matmul(pa, pb, order=o, cluster=c, **t))
        ms = {"this": [], "other": []}
        for which in ("this", "other", "other", "this"):
            t_ms, how = device_ms(runs[which], calls, ms_of)
            ms[which].append(t_ms)
        rows.append({"shape": [m, n, k], "dtype_bytes": eb, "same": same,
                     "ms": ms, "timed_by": how, "this": picks["this"],
                     "other": picks["other"]})
        print(f"{m}x{k}x{n} {dtype}: the plan {p.tiles} {p.order} "
              f"cluster {p.cluster}: "
              + ", ".join(f"{x:.4f}" for x in ms["this"])
              + f" ms; the other pick {other['tiles']} {other['order']} "
              f"cluster {tuple(other['cluster'])}"
              + (" (the same)" if same else "") + ": "
              + ", ".join(f"{x:.4f}" for x in ms["other"])
              + f" ms ({'kernel alone' if how == 'device' else 'a call'})")
        del a, b
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--square", action="store_true")
    parser.add_argument("--push", action="store_true")
    parser.add_argument("--picks")
    parser.add_argument("--json")
    args = parser.parse_args()
    runs = args.runs

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on the card only")
    from repro_torch.core import planner
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_matmul as bmm

    def ms_of(fn) -> float:
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / runs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    report: dict = {"card": card, "runs": runs}
    if args.picks:
        print(f"card: {card}; ms a launch from CUDA events over {runs} "
              f"calls")
        report["picks"] = time_picks(args.picks, ms_of, runs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for k, n in PREFILL_KN:
        a = torch.randn(PREFILL_M, k, device="cuda", generator=gen).bfloat16()
        b = (torch.randn(k, n, device="cuda", generator=gen)
             / k ** 0.5).bfloat16()
        p = planner.plan_matmul(PREFILL_M, n, k, dtype_bytes=2)
        k4 = p.order if p.order[2] != "k" else "mkn"
        k4_tiles = p.tiles if planner.matmul_smem_bytes(
            *p.tiles.values(), 2, rmw=True) <= planner.H100_SXM \
            .smem_bytes_per_block else {"bm": 128, "bn": 128, "bk": 128}
        cases.append((f"{PREFILL_M}x{k}x{n}", "K3", "mnk",
                      dict(p.tiles, cluster=p.cluster), a, b))
        cases.append((f"{PREFILL_M}x{k}x{n}", "K4", k4, k4_tiles, a, b))
    if args.square:
        sq = 8192
        a = torch.randn(sq, sq, device="cuda", generator=gen).bfloat16()
        b = (torch.randn(sq, sq, device="cuda", generator=gen)
             / sq ** 0.5).bfloat16()
        p = planner.plan_matmul(sq, sq, sq, 2)
        for tiles in (dict(p.tiles, cluster=p.cluster),
                      dict(p.tiles, cluster=(1, 1)),
                      dict(p.tiles, bk=64, cluster=p.cluster),
                      {"bm": 128, "bn": 128, "bk": 128}):
            cases.append((f"{sq}^3", "K3", "mnk", tiles, a, b))
    if args.push:
        k, n = PUSH_KN
        a = torch.randn(PREFILL_M, k, device="cuda", generator=gen).bfloat16()
        b = (torch.randn(k, n, device="cuda", generator=gen)
             / k ** 0.5).bfloat16()
        cases.append((f"{PREFILL_M}x{k}x{n}", "K4 push", "mkn", PUSH_TILES,
                      a, b))

    print(f"card: {card}; ms a launch from CUDA events over {runs} calls")
    total = {"K3": 0.0, "K4": 0.0, "torch.matmul": 0.0}
    for shape, name, order, tiles, a, b in cases:
        ms = ms_of(lambda: bmm.block_matmul(a, b, order=order, **tiles))
        if shape.startswith(str(PREFILL_M)) and name in total:
            total[name] += ms
        line = f"{name} {shape} tiles {tiles} order {order}: {ms:.4f} ms"
        if name == "K3" and shape.startswith(str(PREFILL_M)):
            lib_ms = ms_of(lambda: a @ b)
            total["torch.matmul"] += lib_ms
            line += f"  (torch.matmul {lib_ms:.4f} ms)"
        print(line + f", core {bmm.LAST_LAUNCH['core']}")
    print("summed over the four shapes: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in total.items()))

    csrc = ROOT / "src/repro_torch/kernels/csrc"
    work = pathlib.Path(tempfile.mkdtemp(prefix="k34_probe_"))
    src = work / "k34_probe.cu"
    src.write_text(PROBE)
    lib_path = work / "libk34_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _build._libs["block_matmul"] = lib   # the wrapper now launches the copy
    for launch in bmm._LAUNCH.values():
        launch.c = None                   # bound again, from the copy
    sums = (ctypes.c_ulonglong * 12)()
    report["steps"] = []
    print(f"SM cycles per step of thread 0 of each block, instrumented "
          f"copy; ms a launch of the copy")
    for shape, name, order, tiles, a, b in cases:
        out = bmm.block_matmul(a, b, order=order, **tiles)
        torch.cuda.synchronize()
        want = bmm.block_matmul_plain(a, b, order=order, **tiles) \
            if a.shape[0] < 8192 else torch.matmul(a.float(), b.float())
        err = (out.float() - want.float()).abs().max().item()
        if err > 1e-2 + 1.6e-2 * want.float().abs().max().item():
            raise SystemExit(f"{name} {shape}: max abs err {err} against "
                             f"the plain version")
        lib.probe_read(sums)
        ms = ms_of(lambda: bmm.block_matmul(a, b, order=order, **tiles))
        lib.probe_read(sums)
        steps = sums[0]
        per = {ph: sums[q + 1] / max(1, steps)
               for q, ph in enumerate(PHASES)}
        clock = sum(sums[1:6]) / max(1, sum(sums[7:12])) * 1e9
        row = {"shape": shape, "kernel": name, "order": order,
               "tiles": {x: v for x, v in tiles.items()}, "ms": ms,
               "steps": steps // (runs + 1), "cycles": per,
               "clock_hz": clock}
        line = (f"{name} {shape} tiles {tiles} order {order}: {ms:.4f} ms, "
                f"{steps // (runs + 1)} block steps a launch; cycles "
                + " ".join(f"{ph.replace(' ', '_')}={v:.0f}"
                           for ph, v in per.items())
                + f"; SM clock {clock / 1e9:.3f} GHz")
        if name == "K4 push":
            trips = {"m": a.shape[0] // tiles["bm"],
                     "n": b.shape[1] // tiles["bn"],
                     "k": a.shape[1] // tiles["bk"]}
            cs = planner.gemm_cluster_size(order, trips)
            pushed = (cs - 1) * tiles["bm"] * tiles["bk"] * 2
            row["push_bw"] = pushed / (per["wait A"] / clock)
            line += (f"; rank 0 pushes {pushed} B to {cs - 1} peers a step: "
                     f"{row['push_bw'] / 1e9:.2f} GB/s")
        report["steps"].append(row)
        print(line)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(report, indent=1,
                                                      default=str))


if __name__ == "__main__":
    main()
