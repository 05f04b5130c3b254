#!/usr/bin/env python3
"""Time K5's split kernel at the decode cells' shapes over rings beside the
planner's.

    python3 tools/k5_ring_probe.py [--cells NAME,...] [--turns N]
                                   [--json PATH]

For each cell of ``chip_smoke.K5_CELL_SHAPES`` (bfloat16, every session at
the cell's timed length), every ring the kernel takes and whose block fits
(tiles of ``core.planner.DECODE_TILES`` rows, of 8 or more where the scores
run on the tensor cores, slots of ``DECODE_STAGES``, 4 or 8 warps a block)
at the planner's splits, and the planner's ring at half and twice its
splits: the pair (split kernel into the workspace, then the combine; one
split writes the output itself) as a CUDA graph of ``CALLS`` calls, timed
with CUDA events in ``--turns`` turns, rings taken in turns within a
turn; beside it the byte bound, the split kernel's blocks resident an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), its registers and
spills, and the largest difference from the plan's output.  The planner's
pick is marked.  Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CALLS = 20
HBM_BYTES_PER_S = 3.35e12


def variants(g, d, plan):
    """(tile, stages, warps, splits) to time: every ring at the plan's
    splits, and the plan's ring at half and twice them."""
    from repro_torch.core import planner
    t = plan.tiles
    out = []
    mma = planner.decode_mma(g, d, 2)
    for tile, stages, warps in itertools.product(
            planner.DECODE_TILES, planner.DECODE_STAGES, (4, 8)):
        if mma and tile % 8:
            continue
        if planner.decode_smem_bytes(g, d, tile, stages, warps, 2) > \
                planner.H100_SXM.smem_bytes_per_block:
            continue
        out.append((tile, stages, warps, t["splits"]))
    for splits in (t["splits"] // 2, t["splits"] * 2):
        if splits >= 1:
            out.append((t["tile"], t["stages"], t["warps"], splits))
    return out


def main() -> None:
    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=",".join(chip_smoke.K5_CELL_SHAPES))
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--json", type=pathlib.Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from repro_torch.core import planner
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd

    card = subprocess_card()
    occupancy = _build.bind("flash_decode", "flash_decode_occupancy",
                            [ctypes.c_int] * 8 + [ctypes.c_void_p])
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    rows = []
    for cell in args.cells.split(","):
        b, hq, hkv, d, s, timed = chip_smoke.K5_CELL_SHAPES[cell]
        g = hq // hkv
        q = torch.randn((b, hq, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda"
                            ).to(torch.bfloat16) for _ in range(2))
        lens = torch.full((b,), timed, dtype=torch.int32, device="cuda")
        plan = planner.plan_decode_split(s, d, g, b * hkv, 2)
        pick = (plan.tiles["tile"], plan.tiles["stages"],
                plan.tiles["warps"], plan.tiles["splits"])
        mma = fd.uses_mma(torch.bfloat16, torch.bfloat16, g, d)

        def call(tile, stages, warps, splits):
            out = torch.empty_like(q) if splits == 1 else None
            part = None if splits == 1 else fd._workspace(q, k, splits)
            fd._SPLIT(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lens.data_ptr(),
                      None if out is None else out.data_ptr(),
                      None if part is None else part.data_ptr(), 1, 1, b,
                      s, hkv, g, d, 16, splits, tile, stages, warps,
                      int(mma and tile % 8 == 0), q.stride(0), q.stride(1),
                      k.stride(0), k.stride(1), k.stride(2), d ** -0.5)
            return out if part is None else fd.decode_combine(part, q.dtype)

        want = call(*pick).float()
        cands = []
        for var in variants(g, d, plan):
            occ = (ctypes.c_int * 3)()
            code = occupancy(1, 1, g, d, *var[:3],
                             int(mma and var[0] % 8 == 0), occ)
            if code:
                raise RuntimeError(f"occupancy {var}: CUDA error {code}")
            diff = (call(*var).float() - want).abs().max().item()
            graph = torch.cuda.CUDAGraph()
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                call(*var)
            torch.cuda.current_stream().wait_stream(stream)
            with torch.cuda.graph(graph):
                for _ in range(CALLS):
                    call(*var)
            cands.append({"ring": var, "graph": graph, "ms": [],
                          "blocks": occ[0], "regs": occ[1],
                          "local_bytes": occ[2], "max_diff": diff})
        for _ in range(args.turns):
            for c in cands:
                c["graph"].replay()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                c["graph"].replay()
                end.record()
                end.synchronize()
                c["ms"].append(start.elapsed_time(end) / CALLS)
        bound_ms = (2 * b * hq * d + 2 * b * timed * hkv * d) * 2 \
            / HBM_BYTES_PER_S * 1e3
        print(f"{cell}: B {b} H_q {hq} H_kv {hkv} D {d} rows {s} length "
              f"{timed}, bound {bound_ms:.5f} ms; card: {card}")
        for c in sorted(cands, key=lambda c: statistics.median(c["ms"])):
            ms = statistics.median(c["ms"])
            tile, stages, warps, splits = c["ring"]
            print(f"  tile {tile:2d} stages {stages} warps {warps} splits "
                  f"{splits:2d}: {ms:.5f} ms ({bound_ms / ms * 100:5.1f} %)"
                  f" turns {', '.join(f'{x:.5f}' for x in c['ms'])}; "
                  f"{c['blocks']} blocks = {c['blocks'] * warps} warps an "
                  f"SM, {c['regs']} regs, {c['local_bytes']} B spilled; "
                  f"max diff {c['max_diff']:.2e}"
                  + ("  <- plan" if c["ring"] == pick else ""))
            rows.append({"cell": cell, "ring": c["ring"], "ms": ms,
                         "ms_turns": c["ms"], "bound_ms": bound_ms,
                         "blocks": c["blocks"], "regs": c["regs"],
                         "local_bytes": c["local_bytes"],
                         "max_diff": c["max_diff"],
                         "plan": c["ring"] == pick})
        del cands, q, k, v
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "rows": rows},
                                        indent=1))


def subprocess_card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


if __name__ == "__main__":
    main()
