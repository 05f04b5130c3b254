"""Readings for the limits of ``correct``, on the card, many seeds in one
process: the program's numbers on each seed and, with ``--control``, the
control's (the plain reference computed one precision lower and put in
the program's place: TF32 for the f32 convolutions, fp8 weights for the
bf16 decoder).  The benchmark's own runs never run the control.

    python3 bench/controls.py --workload <name> --seeds 1,2,3 \
        [--seconds 1] [--control] [--out file.jsonl]

Each seed is one run of the cell as ``run.py`` makes it (set-up, a short
window at the cell's load, the check); one JSON line a seed.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run as bench_run  # noqa: E402


def collect(workload: str, seeds: list, seconds: float, control: bool,
            device=None) -> list:
    import torch
    device = device or torch.device("cuda", 0)
    out = []
    for seed in seeds:
        gc.collect()
        if device.type == "cuda" and torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        result = bench_run.run_cell(workload, seed, seconds, False,
                                    device=device,
                                    t_start=time.perf_counter(),
                                    control=control)
        out.append({"seed": seed, "correct": result["correct"],
                    "checks": result["checks"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench_run.prepare_env(bench_run.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = collect(args.workload, seeds, args.seconds, args.control)
    lines = [json.dumps({"workload": args.workload, **r}) for r in rows]
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
