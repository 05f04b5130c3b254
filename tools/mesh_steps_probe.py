#!/usr/bin/env python3
"""Which steps of the mesh path this PyTorch's DTensor runs: four gloo
ranks on the CPU, a (2, 2) ("data", "model") mesh, and for the reduced
TinyLlama (tp), Qwen2-7B (spfsdp), DBRX (MoE) and Mamba2 (SSD) the train
step, the prefill and the decode step at batch 4 and at batch 1, each
through ``launch.steps.dist_*_step``.  A decode step whose meshed prefill
failed starts from the un-meshed prefill's cache.

    PYTHONPATH=src python3 tools/mesh_steps_probe.py [--strict]
        [--archs ID,...]

``--strict`` runs every step under ``launch.view_rule.StrictViews``
(PyTorch 2.11's DTensor rule for views and pads, raised on a later
version too); ``--archs`` probes other ids of the registry than those
four (any but the encoder-decoder, whose batch holds frames).

Prints one JSON object: the torch version and, for each (arch, step),
"ok" or the error with the last frames of the port that raised it.  No
card, no port, no network (a ``FileStore`` in a temporary directory).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("tinyllama-1.1b", "qwen2-7b", "dbrx-132b", "mamba2-2.7b")
BATCH, SEQ, PROMPT = 4, 16, 8


def _where(e: Exception) -> dict:
    frames = [f"{pathlib.Path(f.filename).name}:{f.lineno} {f.line}"
              for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename]
    return {"error": str(e)[-600:], "at": frames[-3:]}


def rank_main(rank: int, store: str, strict: bool, archs) -> None:
    import contextlib

    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.launch.view_rule import StrictViews
    from repro_torch.models import registry
    from repro_torch.models.common import Axes, map_defs
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    mesh = mesh_mod.make_smoke_mesh()
    axes = Axes.for_mesh(mesh)
    res = {"torch": torch.__version__}

    def attempt(name, fn):
        try:
            with StrictViews() if strict else contextlib.nullcontext():
                out = fn()
            res[name] = "ok"
            return out
        except Exception as e:               # noqa: BLE001 (reported)
            res[name] = _where(e)
            return None

    with mesh_mod.enter_mesh(mesh):
        for arch in archs:
            api = registry.get_reduced(arch, **(
                {"capacity_factor": 2.0} if "dbrx" in arch else {}))
            toks = torch.randint(3, api.cfg.vocab, (BATCH, SEQ),
                                 generator=torch.Generator().manual_seed(1))

            def params():
                return map_defs(lambda t: t.float(),
                                api.init_params(0, device="cpu"))

            p = params()
            batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
            attempt(f"{arch} train", lambda: steps.dist_train_step(
                api, axes, num_microbatches=2)(p, adamw.init(p), batch))
            p = params()
            for b in (BATCH, 1):
                prompt = {"tokens": toks[:b, :PROMPT]}
                got = attempt(f"{arch} prefill b{b}",
                              lambda: steps.dist_prefill_step(
                                  api, axes, SEQ)(p, prompt))
                cache = got[1] if got else \
                    steps.make_prefill_step(api, SEQ)(p, prompt)[1]
                cache = map_defs(lambda v: (v.full_tensor() if hasattr(
                    v, "full_tensor") else v).float(), cache)
                attempt(f"{arch} decode b{b}",
                        lambda: steps.dist_decode_step(api, axes)(
                            p, cache, toks[:b, PROMPT:PROMPT + 1], PROMPT))
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(res, indent=1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strict", action="store_true")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args()
    archs = args.archs.split(",")
    if args.rank is not None:
        rank_main(args.rank, args.store, args.strict, archs)
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as d:
        store = str(pathlib.Path(d) / "store")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--store", store,
             "--archs", args.archs] + ["--strict"] * args.strict,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True) for r in range(4)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
    print(outs[0], end="")
    sys.exit(max(p.returncode for p in procs))


if __name__ == "__main__":
    main()
