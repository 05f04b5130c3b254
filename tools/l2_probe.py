#!/usr/bin/env python3
"""L2's ceiling for the block GeMM's tile pattern, on the card.

    python3 tools/l2_probe.py [--iters N] [--reps N] [--gemm] [--k3-sweep]
                              [--no-probe] [--src DIR] [--json PATH]
                              [--rates] [--seconds S] [--turns N] [--quick]
                              [--gemm-clocks] [--sass]

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

``--rates`` measures the two rates the planner's roofline crossover
divides, at one clock, in the second kernel of ``tools/l2_probe.cu``:
(a) the tensor cores alone, every SM running K3's own m64n256k16 (or two
m64n128k16) chains on a tile that stays in shared memory, two consumer
warpgroups, up to three committed groups in flight; (b) landing alone,
the ring above and its variants (K3's B box of 256 rows, 6-8 slots, the
TMA issues spread over two producer warps, two blocks an SM, K3's pair:
an A box each rank fetches for itself beside a B box multicast to both);
(c) both in one block, a producer landing boxes into a ring that a third
warp frees as each lands (unicast or multicast over clusters of 2 or 4)
while the consumers run (a)'s chain; (d) (c) with the chain paced to
fewer groups a second, the trade between the two rates.  The planner's
three rates (``GpuChipModel.tensor_flops``, ``smem_fill_bw``, ``l2_bw``)
are the medians over the turns of one variant of (c), K3's own ring
(``K3_RING``: a pair a slot, 3 slots, one producer thread), each turn
one window that gives all three.  Thread 0 of every block
reads ``%clock64``
and ``%globaltimer`` at both ends of its window, so each rate comes with
the SM clock it ran at; ``nvidia-smi`` samples the SM clock, power and
temperature every 100 ms beside every window.  A warm-up runs (a) until
the clock settles; the cases run in turns (``--turns``), (a) and (c) for
``--seconds`` each.  ``--gemm-clocks`` samples the same while K3 on the
planner's plan and ``torch.matmul`` run at 8192^3 bf16 for ``--seconds``
each, in turns; ``--sass`` counts the probe's wgmma instructions and
the waits the compiler put between them (``cuobjdump -sass``).

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
import time

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


_BUILT: dict = {}


def build() -> ctypes.CDLL:
    """``tools/l2_probe.cu`` built once a process; ``_BUILT`` keeps the
    library, its path and the compiler's output."""
    if "lib" in _BUILT:
        return _BUILT["lib"]
    from repro_torch.kernels import _build
    out = pathlib.Path(tempfile.mkdtemp(prefix="l2_probe_")) / \
        "libl2_probe.so"
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
    lib.lp_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 13 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    lib.lp_clusters.argtypes = [ctypes.c_int] * 6
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _BUILT.update(lib=lib, path=out, log=log.stdout + log.stderr)
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
    lib = build()
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


# ------------------------------------------------------------- --rates
# The chain's FLOPs a group a block: two warpgroups, four k16 steps of a
# 64 x 256 product each.
GROUP_FLOPS = 2 * 4 * 2 * 64 * 256 * 16
TENSOR_CORES_PER_SM = 4
# K3's A box (128 x 64), its B box at bk 256, and "K", K3's pair: an A box
# each rank of a cluster of 2 fetches for itself beside a B box multicast
# to both, as K3 runs its 128 x 256 tiles in 2 x 1 clusters
BOX_ROWS = {"A": 128, "B": 256, "K": 256}
PAIR_BYTES = {"landed": (128 + 256) * 64 * 2, "served": (128 + 128) * 64 * 2}
SMI_FIELDS = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu")


def _variant(box="A", per_slot=3, stages=4, producers=1, per_sm=1, g=1,
             chain=0, pace=0) -> dict:
    return dict(box=box, per_slot=per_slot, stages=stages,
                producers=producers, per_sm=per_sm, g=g, chain=chain,
                pace=pace)


# (a) the tensor cores alone: K3's m64n256k16 chain, and its two
# m64n128k16 products
TENSOR = [_variant(chain=256, per_slot=1, stages=1),
          _variant(chain=128, per_slot=1, stages=1)]
# (c)'s variant the planner's rates come from, each the median over the
# turns of one window: K3's own ring (a pair a slot, 3 slots, one
# producer thread) beside K3's m64n256k16 chain
K3_RING = _variant("K", 2, 3, g=2, chain=256)
# (b) landing alone: today's ring (3 A boxes a slot, 4 slots) unicast and
# over clusters of 2 and 4, then variants of it
LANDING = [_variant(g=1), _variant(g=2), _variant(g=4),
           _variant(per_slot=1, stages=8, g=1),
           _variant(per_slot=1, stages=8, g=2),
           _variant(per_slot=2, stages=6, g=2),
           _variant("B", 1, 6, g=1), _variant("B", 1, 6, g=2),
           _variant("B", 2, 3, g=2),
           _variant(producers=2, g=1), _variant(producers=2, g=2),
           _variant("B", 2, 3, producers=2, g=2),
           _variant(per_slot=3, stages=2, per_sm=2, g=1),
           _variant(per_slot=3, stages=2, per_sm=2, g=2),
           _variant(per_slot=1, stages=6, per_sm=2, g=2),
           _variant("B", 1, 3, per_sm=2, g=2),
           {**K3_RING, "chain": 0}]
# (c) landing under the chain's load: rings that fit beside its 48 KB tile
UNDER_LOAD = [_variant(per_slot=3, stages=3, g=1, chain=256),
              _variant(per_slot=3, stages=3, g=2, chain=256),
              _variant(per_slot=1, stages=8, g=2, chain=256),
              _variant(per_slot=2, stages=5, g=2, chain=256),
              _variant("B", 1, 5, g=1, chain=256),
              _variant("B", 1, 5, g=2, chain=256),
              _variant("B", 2, 2, producers=2, g=1, chain=256),
              _variant("B", 2, 2, producers=2, g=2, chain=256),
              _variant(per_slot=2, stages=5, producers=2, g=2, chain=256),
              _variant(per_slot=3, stages=3, producers=2, g=2, chain=256),
              _variant(per_slot=3, stages=3, g=4, chain=256),
              _variant(per_slot=3, stages=3, g=2, chain=128),
              K3_RING, _variant("K", 2, 3, producers=2, g=2, chain=256),
              _variant("K", 2, 2, g=2, chain=256)]
# (d) the frontier: (c)'s ring under the m64n256 chain paced to a group
# every `pace` SM clocks a warpgroup (1024 when the two warpgroups share
# the tensor cores at full rate): how much landing a lighter tensor load
# leaves
FRONTIER = [_variant(per_slot=3, stages=3, g=2, chain=256, pace=pace)
            for pace in (1138, 1280, 1463, 2048)]
# chip_smoke.py's phase 1 and the `gpu` test: one of each, (b) today's
# ring over clusters of 2, (c) the planner's variant
QUICK = {"a": TENSOR[:1], "b": [_variant(g=2)], "c": [K3_RING]}


def variant_name(v: dict) -> str:
    chain = f"m64n{v['chain']} chain, " if v["chain"] else ""
    boxes = (f"{v['per_slot'] // 2} K3 pair{'s' if v['per_slot'] > 2 else ''}"
             f" (A box each, B box to both)" if v["box"] == "K" else
             f"{v['per_slot']} {v['box']} box"
             f"{'es' if v['per_slot'] > 1 else ''}")
    ring = (f"{boxes} x {v['stages']} slots, {v['producers']} producer"
            f"{'s' if v['producers'] > 1 else ''}")
    if v["chain"] and v["per_slot"] == 1 and v["stages"] == 1:
        return f"m64n{v['chain']} chain"
    if v.get("pace"):
        chain = f"m64n{v['chain']} chain paced to {v['pace']} clocks, "
    per_sm = ", 2 blocks an SM" if v["per_sm"] > 1 else ""
    return f"{chain}{ring}, cluster {v['g']}{per_sm}"


class Smi:
    """``nvidia-smi`` sampling the SM clock, power draw, power limit and
    temperature every 100 ms while the ``with`` body runs (one query a
    tick from a thread, so no sample waits in a pipe's buffer)."""

    def __enter__(self):
        import threading
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        cmd = ["nvidia-smi", "--query-gpu=" + ",".join(SMI_FIELDS),
               "--format=csv,noheader,nounits", "-i", "0"]
        while not self._stop.is_set():
            tick = time.perf_counter()
            try:
                line = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=10).stdout.strip()
            except (OSError, subprocess.TimeoutExpired):
                line = ""
            vals = []
            for f in line.split(","):
                try:
                    vals.append(float(f))
                except ValueError:
                    vals.append(None)
            if len(vals) == len(SMI_FIELDS):
                self.samples.append(vals)
            self._stop.wait(max(0.0, 0.1 - (time.perf_counter() - tick)))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False

    def summary(self) -> dict:
        import statistics

        def col(i):
            return [r[i] for r in self.samples if r[i] is not None]

        out = {"samples": len(self.samples)}
        for i, key in enumerate(("sm_mhz", "power_w", "limit_w", "temp_c")):
            vals = col(i)
            if vals:
                out[key] = statistics.median(vals)
                out[key + "_range"] = [min(vals), max(vals)]
        return out


def _rate_launch(torch, lib, buf, rows, v, slots, groups, blocks):
    """One launch of the rate probe; the blocks' records (LP_REC each)
    and the launch's CUDA-event time in ms."""
    rec = torch.zeros(blocks, 16, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    code = lib.lp_launch(buf.data_ptr(), rows, COLS, v["g"],
                         BOX_ROWS[v["box"]], v["stages"], v["per_slot"],
                         v["producers"], slots, v["chain"], groups,
                         v.get("pace", 0), int(v["box"] == "K"), blocks,
                         rec.data_ptr(), stream)
    if code:
        raise SystemExit(f"rate probe ({variant_name(v)}): CUDA error {code}"
                         f" ({lib.repro_cuda_error_string(code).decode()})")
    end.record()
    torch.cuda.synchronize()
    return rec.cpu().numpy(), start.elapsed_time(end)


def _blocks(lib, v, sms) -> int:
    fit = lib.lp_clusters(v["g"], v["chain"], BOX_ROWS[v["box"]],
                          v["stages"], v["per_slot"], int(v["box"] == "K"))
    if fit <= 0:
        raise SystemExit(f"rate probe ({variant_name(v)}): no cluster "
                         f"fits ({fit})")
    return min(fit * v["g"], sms * v["per_sm"] // v["g"] * v["g"])


def _read(rec, v, blocks, groups, ms) -> dict:
    """Rates from the blocks' records: each block's work over its own
    window, summed over the blocks (all run at once), and the SM clock,
    the mean over blocks of %clock64 cycles over %globaltimer ns."""
    import numpy as np
    slot_bytes = v["per_slot"] * 64 * BOX_ROWS[v["box"]] * 2
    served_share = 1 / v["g"]
    if v["box"] == "K":
        slot_bytes = v["per_slot"] // 2 * PAIR_BYTES["landed"]
        served_share = PAIR_BYTES["served"] / PAIR_BYTES["landed"]
    sms = blocks // v["per_sm"]
    out = {"name": variant_name(v), **v, "blocks": blocks, "sms": sms,
           "event_ms": ms}
    if v["chain"] and not v["slots"]:
        dc, dt = rec[:, 1] - rec[:, 0], rec[:, 3] - rec[:, 2]
        work = np.full(blocks, groups * GROUP_FLOPS, dtype=np.float64)
        out["window_s"] = float(dt.mean()) * 1e-9
        out["tensor_flops"] = float((work / dt).sum()) * 1e9
    else:
        dc, dt = rec[:, 5] - rec[:, 4], rec[:, 7] - rec[:, 6]
        landed = rec[:, 8].astype(np.float64) * slot_bytes
        out["window_s"] = float(dt.mean()) * 1e-9
        out["landed_bytes_per_s"] = float((landed / dt).sum()) * 1e9
        out["served_bytes_per_s"] = out["landed_bytes_per_s"] * served_share
        if v["chain"]:
            work = (rec[:, 10] - rec[:, 9]).astype(np.float64) * GROUP_FLOPS
            out["tensor_flops"] = float((work / dt).sum()) * 1e9
            out["closed_by_chain"] = int(rec[:, 11].sum())
    clock = float((dc / dt).mean()) * 1e9
    out["clock_hz"] = clock
    if "tensor_flops" in out:
        out["flops_per_sm_clock"] = out["tensor_flops"] / (sms * clock)
        out["flops_per_tensor_core_clock"] = \
            out["flops_per_sm_clock"] / TENSOR_CORES_PER_SM
    if "landed_bytes_per_s" in out:
        out["landed_bytes_per_sm_clock"] = \
            out["landed_bytes_per_s"] / (sms * clock)
    return out


def measure_rates(seconds: float = 1.0, turns: int = 2, quick: bool = False,
                  warmup_max_s: float = 12.0) -> dict:
    """Cases (a)-(c) of the rate probe (and, unless ``quick``, (d), the
    paced chain's frontier) in turns after a warm-up, with today's ring
    run once before it on the idle card (``cold``); each run's rates, SM
    clock (in the kernel and by ``nvidia-smi``), power and temperature,
    and for (a)-(c) the highest rates any variant reached (``best``; for
    (c) both rates of the run that landed most)."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on the card only")
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = ROWS["l2"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = torch.randn(rows, COLS, device="cuda", generator=gen).bfloat16()
    cases = QUICK if quick else {"a": TENSOR, "b": LANDING, "c": UNDER_LOAD,
                                 "d": FRONTIER}
    out: dict = {"card": card_line(), "seconds": seconds, "turns": turns,
                 "sms": sms, "warmup": [], "runs": []}
    chain_rate: dict = {}   # groups a second a warpgroup, by chain
    slot_rate: dict = {}    # slots a second a producer, by ring alone

    def calibrate(v):
        """Groups (or slots) a second of a short run of ``v``."""
        blocks = _blocks(lib, v, sms)
        if v["chain"]:
            g0 = 20000
            rec, _ = _rate_launch(torch, lib, buf, rows, v, 0, g0, blocks)
            return g0 / (float((rec[:, 3] - rec[:, 2]).mean()) * 1e-9)
        s0 = 2000
        rec, _ = _rate_launch(torch, lib, buf, rows, v, s0, 0, blocks)
        return s0 / (float((rec[:, 7] - rec[:, 6]).mean()) * 1e-9)

    def run(case, v, turn):
        blocks = _blocks(lib, v, sms)
        slots = groups = 0
        if v["chain"]:
            if v["chain"] not in chain_rate:
                chain_rate[v["chain"]] = calibrate(
                    {**v, "per_slot": 1, "stages": 1, "g": 1, "pace": 0})
            rate = chain_rate[v["chain"]]
            if v["pace"]:
                rate = min(rate, out["settled_clock_hz"] / v["pace"])
            groups = max(1, int(rate * seconds))
        if case != "a":
            alone = {**v, "chain": 0, "pace": 0}
            key = tuple(sorted(alone.items()))
            if key not in slot_rate:
                slot_rate[key] = calibrate(alone)
            span = seconds * (1.1 if v["chain"] else 0.25)
            slots = max(2 * v["stages"], int(slot_rate[key] * span))
        with Smi() as smi:
            rec, ms = _rate_launch(torch, lib, buf, rows, v, slots, groups,
                                   blocks)
        r = _read(rec, {**v, "slots": slots}, blocks, groups, ms)
        r.update(case=case, turn=turn, slots=slots, groups=groups,
                 smi=smi.summary())
        out["runs"].append(r)

    for v in cases["b"][:3]:
        run("b", v, "cold")
    warm = TENSOR[0]
    chain_rate[256] = calibrate(warm)
    blocks = _blocks(lib, warm, sms)
    t_end = time.perf_counter() + warmup_max_s
    prev = None
    while time.perf_counter() < t_end:
        groups = int(chain_rate[256] * 0.5)
        with Smi() as smi:
            rec, ms = _rate_launch(torch, lib, buf, rows, warm, 0, groups,
                                   blocks)
        r = _read(rec, {**warm, "slots": 0}, blocks, groups, ms)
        out["warmup"].append({"clock_hz": r["clock_hz"],
                              "tensor_flops": r["tensor_flops"],
                              "smi": smi.summary()})
        if prev is not None and abs(r["clock_hz"] - prev) < 0.005 * prev:
            break
        prev = r["clock_hz"]
    out["settled_clock_hz"] = out["warmup"][-1]["clock_hz"]
    for turn in range(turns):
        for case, variants in cases.items():
            for v in variants:
                run(case, v, turn)
    del buf
    best: dict = {}
    for case in ("a", "b", "c"):
        runs = [r for r in out["runs"] if r["case"] == case]
        if case == "a":
            top = max(runs, key=lambda r: r["tensor_flops"])
            best[case] = {"tensor_flops": top["tensor_flops"],
                          "clock_hz": top["clock_hz"], "name": top["name"]}
            continue
        top = max(runs, key=lambda r: r["landed_bytes_per_s"])
        served = max(runs, key=lambda r: r["served_bytes_per_s"])
        best[case] = {"landed_bytes_per_s": top["landed_bytes_per_s"],
                      "clock_hz": top["clock_hz"], "name": top["name"],
                      "served_bytes_per_s": served["served_bytes_per_s"],
                      "served_name": served["name"]}
        if case == "c":
            best[case]["tensor_flops"] = top["tensor_flops"]
            best[case]["crossover_flops_per_byte"] = \
                top["tensor_flops"] / top["landed_bytes_per_s"]
    out["best"] = best
    mine = [r for r in out["runs"] if r["case"] == "c"
            and r["name"] == variant_name(K3_RING)]
    import numpy as np
    out["planner"] = {"name": variant_name(K3_RING), "turns": len(mine),
                      **{x: float(np.median([r[x] for r in mine]))
                         for x in ("tensor_flops", "landed_bytes_per_s",
                                   "served_bytes_per_s", "clock_hz")}}
    return out


def rates_lines(res: dict) -> list[str]:
    """One line a run of :func:`measure_rates`, then the warm-up and the
    best of each case."""
    lines = []
    w = res["warmup"]
    lines.append(
        f"warm-up: {len(w)} runs of the m64n256 chain, SM clock "
        + " -> ".join(f"{x['clock_hz'] / 1e9:.3f}" for x in w) + " GHz")
    for r in res["runs"]:
        parts = [f"({r['case']}) turn {r['turn']}: {r['name']} on "
                 f"{r['sms']} SMs, {r['window_s']:.3f} s"]
        if "tensor_flops" in r:
            parts.append(f"{r['tensor_flops'] / 1e12:.1f} TFLOP/s "
                         f"({r['flops_per_sm_clock']:.0f} FLOP an SM-clock, "
                         f"{r['flops_per_tensor_core_clock']:.0f} a tensor "
                         f"core)")
        if "landed_bytes_per_s" in r:
            parts.append(f"landed {r['landed_bytes_per_s'] / 1e12:.3f} TB/s "
                         f"({r['landed_bytes_per_sm_clock']:.1f} B an "
                         f"SM-clock), served "
                         f"{r['served_bytes_per_s'] / 1e12:.3f} TB/s")
        smi = r["smi"]
        parts.append(f"SM clock {r['clock_hz'] / 1e9:.3f} GHz (nvidia-smi "
                     f"{smi.get('sm_mhz', float('nan')):.0f} MHz, "
                     f"{smi.get('power_w', float('nan')):.1f} W of "
                     f"{smi.get('limit_w', float('nan')):.0f}, "
                     f"{smi.get('temp_c', float('nan')):.0f} C, "
                     f"{smi['samples']} samples)")
        lines.append("; ".join(parts))
    pl = res["planner"]
    lines.append(
        f"the planner's rates, medians of {pl['turns']} turns of (c) "
        f"{pl['name']}: {pl['tensor_flops'] / 1e12:.1f} TFLOP/s, landed "
        f"{pl['landed_bytes_per_s'] / 1e12:.3f} TB/s, served "
        f"{pl['served_bytes_per_s'] / 1e12:.3f} TB/s, at "
        f"{pl['clock_hz'] / 1e9:.3f} GHz")
    for case, b in res["best"].items():
        txt = ", ".join(
            f"{k} {v / 1e9:.3f} GHz" if k == "clock_hz"
            else f"{k} {v / 1e12:.3f}e12" if isinstance(v, float) and v > 1e9
            else f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in b.items())
        lines.append(f"best ({case}): {txt}")
    return lines


def gemm_clocks(seconds: float = 1.0, turns: int = 2) -> list[dict]:
    """The SM clock, power and temperature (``nvidia-smi`` every 100 ms)
    while K3 on the planner's plan and ``torch.matmul`` run at 8192^3
    bf16 for about ``seconds`` each, in turns; each run's ms a call."""
    import torch
    from repro_torch.core import planner
    from repro_torch.kernels import block_matmul as bmm
    n = 8192
    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn(n, n, device="cuda", generator=gen).bfloat16()
    b = (torch.randn(n, n, device="cuda", generator=gen) / n ** 0.5
         ).bfloat16()
    p = planner.plan_matmul(n, n, n, 2)
    kw = dict(p.tiles, order=p.order, cluster=p.cluster)
    fns = {"K3": lambda: bmm.block_matmul(a, b, **kw),
           "torch.matmul": lambda: torch.matmul(a, b)}
    out = []
    for turn in range(turns):
        for name, fn in fns.items():
            once = _ms(torch, fn, 3)
            reps = max(3, int(seconds * 1e3 / once))
            with Smi() as smi:
                ms = _ms(torch, fn, reps)
            out.append({"gemm": name, "turn": turn, "plan": kw, "reps": reps,
                        "ms": ms, "tflops": 2 * n ** 3 / ms * 1e-9,
                        "smi": smi.summary()})
    del a, b
    return out


def sass_counts(lib_path: pathlib.Path | None = None) -> dict:
    """Per kernel of the rate probe (``lp_kernel``): its wgmma
    instructions (``HGMMA``) and the waits between them
    (``WARPGROUP.DEPBAR``, by the groups they leave in flight), from
    ``cuobjdump -sass``: a chain the compiler serialised waits for 0
    after every product."""
    import re
    import shutil
    path = lib_path or _BUILT["path"]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300).stdout
    out: dict = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "lp_kernel" in m.group(1) else None
            if name:
                out[name] = {"HGMMA": 0, "depbar": {}}
            continue
        if name is None:
            continue
        if "HGMMA" in line:
            out[name]["HGMMA"] += 1
        m = re.search(r"WARPGROUP\.DEPBAR\.LE\s+gsb0,\s*(0x[0-9a-f]+)", line)
        if m:
            k = str(int(m.group(1), 16))
            out[name]["depbar"][k] = out[name]["depbar"].get(k, 0) + 1
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
    ap.add_argument("--rates", action="store_true",
                    help="the crossover's two rates at one clock: cases "
                         "(a) tensor cores, (b) landing, (c) both")
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="window of cases (a) and (c), and of each GeMM "
                         "with --gemm-clocks")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--quick", action="store_true",
                    help="with --rates: one variant of each case")
    ap.add_argument("--gemm-clocks", action="store_true",
                    help="sample the clock while K3 and torch.matmul run at "
                         "8192^3")
    ap.add_argument("--sass", action="store_true",
                    help="count the rate probe's wgmma instructions and "
                         "waits (cuobjdump -sass) and print ptxas's lines")
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
    if args.sass:
        build()
        for line in _BUILT["log"].splitlines():
            if "lp_kernel" in line or "wgmma" in line.lower() \
                    or "Potential" in line:
                print(f"ptxas: {line.strip()}")
        res["sass"] = sass_counts()
        for name, c in res["sass"].items():
            print(f"sass {name}: {c['HGMMA']} HGMMA, waits (groups left in "
                  f"flight: count) {c['depbar']}")
    if args.rates:
        res["rates"] = measure_rates(args.seconds, args.turns, args.quick)
        print("rates (tools/l2_probe.py --rates):\n  "
              + "\n  ".join(rates_lines(res["rates"])))
    if args.gemm_clocks:
        res["gemm_clocks"] = gemm_clocks(args.seconds, args.turns)
        for r in res["gemm_clocks"]:
            smi = r["smi"]
            print(f"clocks under {r['gemm']} 8192^3 (turn {r['turn']}, "
                  f"{r['reps']} calls): {r['ms']:.4f} ms "
                  f"({r['tflops']:.1f} TFLOP/s); nvidia-smi SM clock "
                  f"{smi.get('sm_mhz', float('nan')):.0f} MHz "
                  f"{smi.get('sm_mhz_range')}, "
                  f"{smi.get('power_w', float('nan')):.1f} W of "
                  f"{smi.get('limit_w', float('nan')):.0f}, "
                  f"{smi.get('temp_c', float('nan')):.0f} C, "
                  f"{smi['samples']} samples")
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
