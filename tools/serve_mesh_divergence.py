#!/usr/bin/env python3
"""Where the published TinyLlama-1.1B served on four cards parts from one
card: the serving launcher's greedy loop (``launch.serve``, ``--full``)
run on the (2, 2) mesh through ``steps.dist_prefill_step`` and
``steps.dist_decode_step``, its logits kept at every step, then on rank
0's card alone through the un-meshed steps from the same weights (seed 0)
and prompts.  For each row it finds the first generated token where the
two runs differ and prints, at the step that chose it: the two largest
logits of each run and their gap, the largest logit difference between
the runs, all relative to the largest logit, beside the mesh's logit
tolerance (``chip_smoke.py``'s ``SERVE_REL_TOL``, 5e-2).  A gap below the
difference is a near-tie the mesh's rounding may flip.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tools/serve_mesh_divergence.py [--batch 4] [--prompt-len 32] \\
        [--gen-len 16] [--reduced --device cpu]

Needs four cards; ``--reduced --device cpu`` runs the reduced config on
four gloo ranks instead, a rehearsal.  Prints one JSON object on rank 0.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SERVE_REL_TOL = 5e-2


def greedy(prefill, decode, prompts, gen_len: int, start: int):
    """The serving loop's tokens (B, gen_len) and each step's logits
    (gen_len, B, V) float32 on the host: step i's logits chose token i."""
    import torch

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    logits, cache = prefill({"tokens": prompts})
    kept, toks = [], []
    tok = whole(logits).argmax(dim=-1)[:, None]
    for i in range(gen_len):
        kept.append(whole(logits).float().cpu())
        toks.append(tok[:, 0].cpu())
        logits, cache = decode(cache, tok, start + i)
        tok = whole(logits).argmax(dim=-1)[:, None]
    return torch.stack(toks, dim=1), torch.stack(kept)


def top2(row):
    v = row.topk(2).values
    return float(v[0]), float(v[1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config, not the published one")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.models.common import Axes

    mesh = mesh_mod.launch_mesh(args.device)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if args.device == "cuda" else torch.device("cpu")
    api = (registry.get_reduced if args.reduced else registry.get)(
        "tinyllama-1.1b")
    b, p_len, gen = args.batch, args.prompt_len, args.gen_len
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        3, api.cfg.vocab, size=(b, p_len))).to(dev)
    axes = Axes.for_mesh(mesh)
    with mesh_mod.enter_mesh(mesh):
        params = api.init_params(0, device=dev)
        prefill = steps.dist_prefill_step(api, axes, max_len=p_len + gen)
        decode = steps.dist_decode_step(api, axes)
        mesh_toks, mesh_logits = greedy(
            lambda batch: prefill(params, batch),
            lambda cache, tok, pos: decode(params, cache, tok, pos),
            prompts, gen, p_len)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rank = dist.get_rank()
    if rank == 0:
        params = api.init_params(0, device=dev)
        prefill = steps.make_prefill_step(api, max_len=p_len + gen)
        decode = steps.make_decode_step(api)
        one_toks, one_logits = greedy(
            lambda batch: prefill(params, batch),
            lambda cache, tok, pos: decode(params, cache, tok, pos),
            prompts, gen, p_len)
        rows = []
        for r in range(b):
            differ = (mesh_toks[r] != one_toks[r]).nonzero()
            row = {"row": r, "first_differing_token": None}
            if len(differ):
                t = int(differ[0])
                one, mine = one_logits[t, r], mesh_logits[t, r]
                scale = float(one.abs().max())
                a1, a2 = top2(one)
                m1, m2 = top2(mine)
                row.update(
                    first_differing_token=t,
                    one_card_token=int(one_toks[r, t]),
                    four_card_token=int(mesh_toks[r, t]),
                    one_card_top2=[a1, a2], four_card_top2=[m1, m2],
                    one_card_gap_rel=(a1 - a2) / scale,
                    four_card_gap_rel=(m1 - m2) / scale,
                    logit_diff_rel=float((one - mine).abs().max()) / scale,
                    tolerance_rel=SERVE_REL_TOL,
                    gap_within_tolerance=(a1 - a2) / scale < SERVE_REL_TOL)
            # the steps before it chose the same tokens: how far apart the
            # two runs' logits are there
            same = gen if row["first_differing_token"] is None else \
                row["first_differing_token"]
            row["logit_diff_rel_before"] = [
                float((one_logits[t, r] - mesh_logits[t, r]).abs().max())
                / float(one_logits[t, r].abs().max()) for t in range(same)]
            rows.append(row)
        print(json.dumps({
            "torch": torch.__version__,
            "card": torch.cuda.get_device_name(0)
            if dev.type == "cuda" else "cpu",
            "mesh": list(mesh.shape), "batch": b, "prompt_len": p_len,
            "gen_len": gen, "four_card_tokens": mesh_toks.tolist(),
            "one_card_tokens": one_toks.tolist(), "rows": rows}, indent=1))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
