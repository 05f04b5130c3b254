#!/usr/bin/env python3
"""L2's ceiling for the block GeMM's tile pattern, on the card.

    python3 tools/l2_probe.py [--iters N] [--reps N] [--gemm] [--k3-sweep]
                              [--no-probe] [--src DIR] [--json PATH]

Every SM fetches K3's own A boxes (128 rows x 64 bf16, swizzled 128
bytes) by TMA from a bf16 buffer into a ring of shared-memory slots
(``tools/l2_probe.cu``), in three cases: (a) unicast, (b)
``.multicast::cluster`` over clusters of 2, (c) over clusters of 4.  For each it prints two rates: the bytes that
land in shared memory a second, and the bytes L2 serves a second (a
multicast box is served once and lands on every rank of the cluster).
It also prints the SM clock (``torch.cuda._sleep`` cycles over CUDA-event
time) and the card's name and power limit.  With ``--gemm`` it times K3
(``kernels.block_matmul``) at 8192^3 bf16 on the planner's plan and
``ops.matmul`` over TinyLlama-1.1B's four prefill projections, each beside
``torch.matmul`` on the same inputs; ``--src`` runs them from another
checkout's ``src/`` (a parent's, unpacked by ``git archive``), so that two
trees are timed in one call on one card.  ``--k3-sweep`` times K3 at
8192^3 on the tiles and clusters of ``SWEEP``.

Every SM fetches the boxes of its cluster's own stretch of the buffer; the
16 MB buffer is read over and over from L2, the 1 GB one from device
memory.  Rings of one box a slot (12 slots) and of three (4 slots) hold
192 KB a block; the barriers are K4's (cluster scope) or K3's (CTA
scope).

Needs the card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

COLS = 1024
ROWS = {"l2": 8192,               # 16 MB of bf16: fits the 50 MB L2
        "dram": 524288}           # 1 GB: device memory
BOX_BYTES = 128 * 64 * 2
# (boxes a slot, slots): 192 KB in flight a block, as K3's rings hold
RINGS = ((1, 12), (3, 4))
CASES = (("a", 1), ("b", 2), ("c", 4))
# the ring's barrier semantics: K4's (release/acquire at cluster scope)
# and K3's (default-semantics remote arrivals, CTA-scope waits)
SEMS = (0, 1)
SEM_NAMES = ("cluster-scope", "cta-scope")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sm_clock_hz(torch) -> float:
    """The SM clock under a spinning kernel: cycles over event time."""
    cycles = 50_000_000
    ms = _ms(torch, lambda: torch.cuda._sleep(cycles), 3)
    return cycles / (ms * 1e-3)


def build(work: pathlib.Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out = work / "libl2_probe.so"
    log = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-o", str(out), str(ROOT / "tools/l2_probe.cu")],
        capture_output=True, text=True)
    if log.returncode != 0:
        raise SystemExit(f"nvcc failed on tools/l2_probe.cu:\n{log.stdout}"
                         f"{log.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.l2_probe_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    lib.l2_probe_clusters.argtypes = [ctypes.c_int] * 3
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def measure(iters: int = 4000, reps: int = 5, buffers=tuple(ROWS),
            rings=RINGS, sems=SEMS) -> dict:
    """Each case's rates, in bytes a second, for a buffer that fits L2
    and one that does not, in rings of one box a slot and of three, with
    either barriers' semantics (or the ``buffers``, ``rings`` and
    ``sems`` named); and the SM clock."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on the card only")
    work = pathlib.Path(tempfile.mkdtemp(prefix="l2_probe_"))
    lib = build(work)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out: dict = {"card": card_line(), "box_bytes": BOX_BYTES,
                 "iters": iters, "runs": []}
    for where in buffers:
        rows = ROWS[where]
        buf = torch.randn(rows, COLS, device="cuda", generator=gen
                          ).bfloat16()
        for (per_slot, stages), sem, (name, g) in itertools.product(
                rings, sems, CASES):
            if True:
                fit = lib.l2_probe_clusters(g, stages, per_slot)
                if fit <= 0:
                    raise SystemExit(f"case ({name}): no cluster of {g} "
                                     f"fits ({fit})")
                blocks = min(fit * g, sms // g * g)

                def launch():
                    code = lib.l2_probe_launch(buf.data_ptr(), rows, COLS, g,
                                               stages, per_slot, iters,
                                               blocks, sem, stream)
                    if code:
                        raise SystemExit(
                            f"case ({name}) launch: CUDA error {code} "
                            f"({lib.repro_cuda_error_string(code).decode()})")

                ms = _ms(torch, launch, reps)
                landed = blocks * iters * per_slot * BOX_BYTES
                out["runs"].append({
                    "buffer": where, "buffer_bytes": rows * COLS * 2,
                    "case": name, "cluster": g, "boxes_a_slot": per_slot,
                    "barriers": SEM_NAMES[sem],
                    "slots": stages, "blocks": blocks, "ms": ms,
                    "landed_bytes_per_s": landed / (ms * 1e-3),
                    "l2_bytes_per_s": landed / g / (ms * 1e-3)})
        del buf
    out["sm_clock_hz"] = sm_clock_hz(torch)
    return out


PREFILL_M = 4 * 480        # TinyLlama-1.1B's prefill projections (k, n)
PREFILL_KN = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]


def gemm_times(reps: int = 10) -> dict:
    """K3 at 8192^3 bf16 on the planner's plan and ``ops.matmul`` over
    TinyLlama-1.1B's four prefill projections (the plans' tiles, order and
    cluster), each beside ``torch.matmul`` on the same inputs, in turns
    (kernel, library, kernel, library)."""
    import torch
    from repro_torch.core import planner
    from repro_torch.kernels import block_matmul as bmm
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(m, n, k):
        a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        b = (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
             ).bfloat16()
        return a, b

    n = 8192
    a, b = inputs(n, n, n)
    p = planner.plan_matmul(n, n, n, 2)
    kw = dict(p.tiles, order=p.order)
    if hasattr(p, "cluster"):
        kw["cluster"] = p.cluster
    k3 = [_ms(torch, lambda: bmm.block_matmul(a, b, **kw), reps)
          for _ in range(2)]
    lib = [_ms(torch, lambda: torch.matmul(a, b), reps) for _ in range(2)]
    got = bmm.block_matmul(a, b, **kw).float()
    err = (got - torch.matmul(a.float(), b.float())).abs().max().item()
    del a, b, got
    flops = 2 * n ** 3
    out = {"shape": [n, n, n], "plan": {**kw}, "k3_ms": min(k3),
           "k3_tflops": flops / min(k3) * 1e-9, "torch_matmul_ms": min(lib),
           "torch_matmul_tflops": flops / min(lib) * 1e-9,
           "max_abs_err_vs_f32": err, "launch": dict(bmm.LAST_LAUNCH),
           "prefill": []}
    for k, n_ in PREFILL_KN:
        a, b = inputs(PREFILL_M, n_, k)
        ops.matmul(a, b)
        launch = dict(bmm.LAST_LAUNCH)
        mine = [_ms(torch, lambda: ops.matmul(a, b), reps) for _ in range(2)]
        lib = [_ms(torch, lambda: torch.matmul(a, b), reps) for _ in range(2)]
        out["prefill"].append({"shape": [PREFILL_M, n_, k],
                               "plan": ops._planned_matmul(PREFILL_M, n_, k,
                                                           2),
                               "launch": launch, "ms": min(mine),
                               "torch_matmul_ms": min(lib)})
    out["prefill_ms"] = sum(r["ms"] for r in out["prefill"])
    out["prefill_torch_matmul_ms"] = sum(r["torch_matmul_ms"]
                                         for r in out["prefill"])
    return out


# K3 at 8192^3 on tiles and clusters beside the plan's: (bm, bn, bk, cluster)
SWEEP = [(128, 256, 128, (2, 1)), (128, 256, 64, (2, 1)),
         (128, 256, 64, (1, 2)), (128, 256, 64, (2, 2)),
         (128, 256, 64, (1, 1)), (128, 128, 128, (1, 1)),
         (128, 128, 64, (2, 2)), (128, 256, 32, (2, 1))]


def k3_sweep(reps: int = 5) -> list[dict]:
    """K3 at 8192^3 bf16 over ``SWEEP``, in milliseconds."""
    import torch
    from repro_torch.kernels import block_matmul as bmm
    n = 8192
    gen = torch.Generator(device="cuda").manual_seed(2)
    a = torch.randn(n, n, device="cuda", generator=gen).bfloat16()
    b = (torch.randn(n, n, device="cuda", generator=gen) / n ** 0.5
         ).bfloat16()
    out = []
    for bm_, bn_, bk_, cluster in SWEEP:
        ms = _ms(torch, lambda: bmm.block_matmul(
            a, b, bm=bm_, bn=bn_, bk=bk_, cluster=cluster), reps)
        out.append({"tiles": [bm_, bn_, bk_], "cluster": list(cluster),
                    "ms": ms, "tflops": 2 * n ** 3 / ms * 1e-9})
    return out


def summary(res: dict) -> str:
    parts = [f"{r['buffer']} {r['case']} {r['barriers']} (cluster "
             f"{r['cluster']}, "
             f"{r['boxes_a_slot']} x {r['slots']} slots, {r['blocks']} "
             f"blocks): landed {r['landed_bytes_per_s'] / 1e12:.3f} TB/s, "
             f"served {r['l2_bytes_per_s'] / 1e12:.3f} TB/s"
             for r in res["runs"]]
    return "\n  ".join(parts) + \
        f"\n  SM clock {res['sm_clock_hz'] / 1e9:.3f} GHz"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--gemm", action="store_true",
                    help="also time K3 at 8192^3 and the prefill GeMMs")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the L2 probe (with --gemm: the GeMMs alone)")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch the GeMMs run (another "
                         "checkout's src/ to time it beside this one)")
    ap.add_argument("--k3-sweep", action="store_true",
                    help="also time K3 at 8192^3 on the tiles of SWEEP")
    ap.add_argument("--json")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    res: dict = {"card": card_line(), "src": args.src}
    print(f"card: {res['card']}")
    if not args.no_probe:
        res.update(measure(args.iters, args.reps))
        print(f"L2 probe, boxes of {res['box_bytes']} B:\n  "
              + summary(res))
    if args.gemm:
        res["gemm"] = gemm_times()
        gm = res["gemm"]
        print(f"8192^3 bf16: K3 {gm['k3_ms']:.4f} ms "
              f"({gm['k3_tflops']:.1f} TFLOP/s) on {gm['plan']}, "
              f"launch {gm['launch']}; torch.matmul "
              f"{gm['torch_matmul_ms']:.4f} ms "
              f"({gm['torch_matmul_tflops']:.1f} TFLOP/s); K3 max abs err "
              f"against f32 {gm['max_abs_err_vs_f32']:.3e}")
        for r in gm["prefill"]:
            print(f"  prefill {r['shape']}: {r['ms']:.4f} ms on {r['plan']}"
                  f" {r['launch']}; torch.matmul "
                  f"{r['torch_matmul_ms']:.4f} ms")
        print(f"  prefill sum: {gm['prefill_ms']:.4f} ms; torch.matmul "
              f"{gm['prefill_torch_matmul_ms']:.4f} ms")
    if args.k3_sweep:
        res["k3_sweep"] = k3_sweep()
        for r in res["k3_sweep"]:
            print(f"  K3 8192^3 tiles {r['tiles']} cluster {r['cluster']}: "
                  f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s)")
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
