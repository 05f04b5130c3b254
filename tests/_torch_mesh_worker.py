"""One rank of the four-rank mesh check (``test_torch_mesh.py``).

    python tests/_torch_mesh_worker.py RANK WORLD STORE_FILE OUT_DIR
    python tests/_torch_mesh_worker.py cuda OUT_DIR [--decode-only]
        (one process a card; RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
        MASTER_PORT set)

Joins a gloo group of WORLD CPU ranks over a ``FileStore`` (no port, no
network), or an NCCL group of one card a rank through
``launch.mesh.init_process_group``, lays a (2, 2) ("data", "model") mesh
over it, and for each reduced arch runs one train step (2 microbatches),
and a prefill with two decode steps at batch 4 (the caches' sequence over
"model": the reduced KV head counts do not divide 16) and at batch 1 (the
sequence over "data"), twice: un-meshed on plain tensors, and through
``launch.steps.dist_*_step`` on the mesh, from the same float32 weights
(seed 0 on every rank) and tokens.  ``--decode-only`` runs the decode
steps alone, from the un-meshed prefill's cache (PyTorch 2.11's DTensor
refuses views that the train step and the prefill make on a mesh of
several devices).  Writes the largest differences to
OUT_DIR/rank{RANK}.json.
"""
from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.models.common import Axes, leaves, map_defs
from repro_torch.optim import adamw

ARCHS = ("tinyllama-1.1b", "qwen2-7b", "dbrx-132b")
BATCH, SEQ, PROMPT = 4, 16, 8


def _f32_params(api, dev):
    return map_defs(lambda t: t.float().to(dev),
                    api.init_params(0, device="cpu"))


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _max_diff(a, b) -> float:
    return max(float((_full(x) - _full(y)).abs().max())
               for x, y in zip(leaves(a), leaves(b), strict=True))


def check(arch: str, axes: Axes, dev: torch.device,
          decode_only: bool = False) -> dict:
    # MoE: capacity for every pair, so that routing block by block (the
    # mesh) and over all tokens (un-meshed) drop nothing and agree
    api = registry.get_reduced(arch, **({"capacity_factor": 2.0}
                                        if "dbrx" in arch else {}))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(3, api.cfg.vocab, (BATCH, SEQ),
                         generator=gen).to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    opt_cfg = adamw.AdamWConfig(lr=5e-3)
    out = {}
    if decode_only:
        p = _f32_params(api, dev)
        out.update(serve(api, axes, p, p, toks, meshed_prefill=False))
        out["batch1"] = serve(api, axes, p, p, toks[:1],
                              meshed_prefill=False)
        return out

    # the train step, un-meshed and on the mesh
    ref_p = _f32_params(api, dev)
    ref_loss, ref_gnorm, ref_p, _ = steps.make_train_step(
        api, opt_cfg, 2)(ref_p, adamw.init(ref_p), batch)
    p = _f32_params(api, dev)
    loss, gnorm, p, _ = steps.dist_train_step(
        api, axes, num_microbatches=2, opt_cfg=opt_cfg)(
        p, adamw.init(p), batch)
    out["loss"] = [float(ref_loss), float(_full(loss))]
    out["gnorm"] = [float(ref_gnorm), float(_full(gnorm))]
    out["params"] = _max_diff(ref_p, p)

    out.update(serve(api, axes, ref_p, p, toks))
    # a batch of one: the cache's sequence over "data" (the cache specs'
    # rule for long_500k), each device's decode kernel over its rows
    out["batch1"] = serve(api, axes, ref_p, p, toks[:1])
    return out


def serve(api, axes: Axes, ref_p, p, toks, meshed_prefill: bool = True
          ) -> dict:
    """A prefill (un-meshed only, without ``meshed_prefill``) and two
    decode steps (the decode layout), un-meshed from ``ref_p`` and on the
    mesh from ``p``: the largest differences."""
    out = {}
    ref_logits, ref_cache = steps.make_prefill_step(api, SEQ)(
        ref_p, {"tokens": toks[:, :PROMPT]})
    if meshed_prefill:
        # the cache is bfloat16, so float32 sums in another order may
        # round an entry to its neighbour
        logits, cache = steps.dist_prefill_step(api, axes, SEQ)(
            p, {"tokens": toks[:, :PROMPT]})
        out["prefill_logits"] = float((_full(logits) - ref_logits)
                                      .abs().max())
        out["cache"] = [_max_diff(ref_cache, cache),
                        max(float(c.float().abs().max())
                            for c in leaves(ref_cache))]
    # two decode steps from one cache: the un-meshed prefill's in float32
    # (so the new rows are not rounded to bfloat16 either), laid out by
    # the cache specs on the mesh
    ref_cache = {k: v.float() for k, v in ref_cache.items()}
    cache = {k: v.clone() for k, v in ref_cache.items()}
    decode = steps.dist_decode_step(api, axes)
    diffs = []
    launches = dict.fromkeys(fd.LAUNCHES, 0)
    for pos in (PROMPT, PROMPT + 1):
        tok = toks[:, pos:pos + 1]
        ref_logits, ref_cache = api.decode_fn(ref_p, ref_cache, tok, pos)
        before = dict(fd.LAUNCHES)
        logits, cache = decode(p, cache, tok, pos)
        for name in launches:
            launches[name] += fd.LAUNCHES[name] - before[name]
        diffs.append(float((_full(logits) - ref_logits).abs().max()))
    out["decode_logits"] = diffs
    out["cache_placements"] = sorted({str(c.placements)
                                      for c in leaves(cache)})
    # the mesh's decode kernel launches (none on the CPU: plain versions)
    out["decode_launches"] = launches
    out["decode_cache"] = _max_diff(ref_cache, cache)
    out["logit_scale"] = float(ref_logits.abs().max())
    return out


def main(argv):
    torch.set_num_threads(1)
    decode_only = False
    if argv[1] == "cuda":
        # one card a rank: NCCL over the launcher's environment (RANK,
        # WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
        out_dir, decode_only = argv[2], argv[3:] == ["--decode-only"]
        mesh_mod.init_process_group("cuda")
        rank = dist.get_rank()
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        rank, world, store_file, out_dir = int(argv[1]), int(argv[2]), \
            argv[3], argv[4]
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_file, world), rank=rank,
            world_size=world)
        dev = torch.device("cpu")
    try:
        mesh = mesh_mod.make_smoke_mesh()
        axes = Axes.for_mesh(mesh)
        result = {"mesh": list(mesh.shape), "device": str(dev)}
        with mesh_mod.enter_mesh(mesh):
            for arch in ARCHS:
                result[arch] = check(arch, axes, dev, decode_only)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main(sys.argv)
