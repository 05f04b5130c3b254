#!/usr/bin/env python3
"""Where the port's mesh path gathers: the collective bytes that one
device of a dry-run cell moves inside each place where the port gathers
what the JAX package keeps sharded.

    PYTHONPATH=src python3 tools/dryrun_gather_probe.py --arch ID
        --shape CELL [--multi-pod]

Runs the cell as ``python -m repro_torch.launch.dryrun`` does (a fake
process group of 256 or 512 ranks, in this process: run it in a process
of its own), with these functions wrapped to attribute the collective
bytes issued while they run, as executed (a repeated body once, as the
dry run's raw counts):

  * ``layers.split_last`` (a flat head dim gathered where the heads do
    not divide the devices) and ``merge_last``'s backward;
  * ``decode_attend`` of the transformer, hybrid and encoder-decoder
    models (q gathered over the heads, and over a sequence-split cache
    the decode kernel's partials gathered for the combine);
  * ``moe.moe_ffn`` (all of it: the expert weights gathered over "data",
    the router over "model");
  * ``ssm._split_proj`` (z, x, B C and dt, each ``x`` times its own
    column group of ``in_proj``: nothing gathered; a decode step of one
    row gathers its small projection instead) and ``ssm._in_proj_groups``
    (the weight's groups laid out, gathered over "data" as any weight is
    at use);
  * every model's ``chunked_loss`` (``lm_head`` gathered over "data").

Prints one JSON object: the cell, its raw collective total and the bytes
of each place.  No card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> None:
    from repro_torch.launch import dryrun, hlo_stats
    from repro_torch.models import (encdec, hybrid, layers, mamba_lm, mla,
                                    moe, ssm, transformer)
    from repro_torch.models.registry import ARCH_IDS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    moved = collections.Counter()

    def ran() -> float:
        return hlo_stats._RAN[-1].collective_total if hlo_stats._RAN else 0.0

    def attributed(fn, place):
        def wrapped(*a, **k):
            before = ran()
            try:
                return fn(*a, **k)
            finally:
                moved[place] += ran() - before
        return wrapped

    split = attributed(layers.split_last, "split_last")
    for mod in (layers, transformer, mla, hybrid, encdec):
        mod.split_last = split
    layers._MergeLast.backward = staticmethod(attributed(
        layers._MergeLast.backward, "merge_last backward"))
    attend = attributed(transformer.decode_attend,
                        "decode_attend")
    for mod in (transformer, hybrid, encdec):
        mod.decode_attend = attend
    moe.moe_ffn = attributed(moe.moe_ffn, "moe_ffn")
    ssm._split_proj = attributed(ssm._split_proj, "ssm._split_proj")
    ssm._in_proj_groups = attributed(ssm._in_proj_groups,
                                     "ssm._in_proj_groups")
    loss = attributed(transformer.chunked_loss, "chunked_loss")
    for mod in (transformer, mamba_lm, hybrid, encdec):
        mod.chunked_loss = loss

    cell = dryrun.lower_cell(args.arch, args.shape, args.multi_pod)
    print(json.dumps({
        "cell": f"{args.arch} {args.shape}"
                + (" multi-pod" if args.multi_pod else ""),
        "status": cell["status"],
        "raw_collective_bytes": cell.get(
            "collectives_per_device_bytes_raw", {}).get("total"),
        "places": dict(moved)}))


if __name__ == "__main__":
    main()
