#!/usr/bin/env python3
"""The port's dry run over every (arch x cell) of a mesh: one process per
cell (``python -m repro_torch.launch.dryrun``, which makes its own fake
process group), ``--jobs`` at a time.

    PYTHONPATH=src python3 tools/dryrun_sweep.py [--multi-pod]
        [--shapes train_4k,...] [--archs ID,...] [--jobs 3] [--out DIR]

Prints one line per cell: arch, shape, status, seconds of the run,
argument and peak GB a device, matmul FLOPs a device with their ratio
(x chips) to ``launch.model_flops``, and collective GB a device; the
cells' JSON files are left in ``--out``.  Counts on placeholder ranks,
seconds of the host that ran it.  No card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def run_cell(arch: str, shape: str, multi_pod: bool, out: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    tag = "pod" if multi_pod else "single"
    path = pathlib.Path(out) / f"{arch}_{shape}_{tag}.json"
    if r.returncode != 0 or not path.exists():
        return {"arch": arch, "shape": shape, "status": "error",
                "seconds": seconds, "error": (r.stderr or r.stdout)[-400:]}
    cell = json.loads(path.read_text())
    cell["seconds"] = seconds
    return cell


def row(cell: dict) -> str:
    from repro_torch.launch.model_flops import model_flops
    from repro_torch.models import registry
    from repro_torch.models.common import SHAPES

    head = f"{cell['arch']} {cell['shape']}: {cell['status']}"
    if cell["status"] != "ok":
        return head + f" ({cell.get('reason') or cell.get('error')})"
    m, a = cell["memory"], cell["analyzed"]
    flops = a["matmul_flops_per_device"]
    ratio = flops * cell["chips"] / model_flops(
        registry.get(cell["arch"]), SHAPES[cell["shape"]])
    return (f"{head}; {cell['seconds']:.1f} s; argument "
            f"{m['argument_bytes'] / 1e9:.3f} / peak "
            f"{m['peak_device_bytes'] / 1e9:.2f} GB; matmul FLOPs "
            f"{flops:.3e} (x chips / model_flops {ratio:.2f}); collectives "
            f"{a['collective_bytes_total'] / 1e9:.2f} GB; unknown trip "
            f"loops {a['unknown_trip_loops']}")


def main(argv=None) -> None:
    from repro_torch.models import registry
    from repro_torch.models.common import SHAPES

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default=",".join(registry.ARCH_IDS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default="benchmarks/results/dryrun_torch")
    args = ap.parse_args(argv)
    cells = [(a, s) for s in args.shapes.split(",")
             for a in args.archs.split(",")]
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        futures = [pool.submit(run_cell, a, s, args.multi_pod, args.out)
                   for a, s in cells]
        for f in futures:
            print(row(f.result()), flush=True)


if __name__ == "__main__":
    main()
