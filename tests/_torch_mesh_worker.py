"""One rank of the four-rank mesh check (``test_torch_mesh.py``).

    python tests/_torch_mesh_worker.py RANK WORLD STORE_FILE OUT_DIR
    python tests/_torch_mesh_worker.py cuda OUT_DIR
        (one process a card; RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
        MASTER_PORT set)

Joins a gloo group of WORLD CPU ranks over a ``FileStore`` (no port, no
network), or an NCCL group of one card a rank through
``launch.mesh.init_process_group``, lays a (2, 2) ("data", "model") mesh
over it, and for each reduced arch runs one train step (2 microbatches),
and a prefill with two decode steps at batch 4 (the attention caches'
sequence over "model": the reduced KV head counts do not divide 16) and
at batch 1 (the sequence over "data"), twice: un-meshed on plain tensors,
and through ``launch.steps.dist_*_step`` on the mesh, from the same
float32 weights (seed 0 on every rank) and tokens.  On the CPU the
meshed steps run under ``launch.view_rule.StrictViews``: the views and
pads that the card machine's PyTorch 2.11 refuses raise here too.
Writes the largest differences to OUT_DIR/rank{RANK}.json.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.launch.view_rule import StrictViews
from repro_torch.models import registry
from repro_torch.models.common import Axes, leaves, map_defs
from repro_torch.optim import adamw

ARCHS = ("tinyllama-1.1b", "qwen2-7b", "dbrx-132b", "mamba2-2.7b",
         "whisper-medium")
BATCH, SEQ, PROMPT = 4, 16, 8


def _frames(api, dev) -> torch.Tensor:
    """An encoder-decoder's stub frames (BATCH, SEQ, d_model) from a seed,
    float32 as the weights are here."""
    gen = torch.Generator().manual_seed(2)
    return torch.randn((BATCH, SEQ, api.cfg.d_model), generator=gen).to(dev)


def _f32_params(api, dev):
    return map_defs(lambda t: t.float().to(dev),
                    api.init_params(0, device="cpu"))


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _max_diff(a, b) -> float:
    return max(float((_full(x) - _full(y)).abs().max())
               for x, y in zip(leaves(a), leaves(b), strict=True))


def check(arch: str, axes: Axes, dev: torch.device, rule) -> dict:
    # MoE: capacity for every pair, so that routing block by block (the
    # mesh) and over all tokens (un-meshed) drop nothing and agree
    api = registry.get_reduced(arch, **({"capacity_factor": 2.0}
                                        if "dbrx" in arch else {}))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(3, api.cfg.vocab, (BATCH, SEQ),
                         generator=gen).to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    if api.cfg.family == "audio":
        batch["frames"] = _frames(api, dev)
    # eps 1e-5: a first AdamW step moves a weight by lr * g / (|g| +
    # eps), so with eps 1e-8 a gradient element near 0 (Mamba2's in_proj
    # has some of 2e-9) turns float32 rounding of 1e-8 into a change of
    # lr; at 1e-5 the step is at most lr / eps = 500 times the gradient's
    # error, and the gradients themselves are held apart ("grads")
    opt_cfg = adamw.AdamWConfig(lr=5e-3, eps=1e-5)
    out = {}
    # the train step, un-meshed and on the mesh
    ref_p = _f32_params(api, dev)
    ref_loss, ref_gnorm, ref_p, ref_state = steps.make_train_step(
        api, opt_cfg, 2)(ref_p, adamw.init(ref_p), batch)
    p = _f32_params(api, dev)
    with rule():
        loss, gnorm, p, state = steps.dist_train_step(
            api, axes, num_microbatches=2, opt_cfg=opt_cfg)(
            p, adamw.init(p), batch)
    out["loss"] = [float(ref_loss), float(_full(loss))]
    out["gnorm"] = [float(ref_gnorm), float(_full(gnorm))]
    out["params"] = _max_diff(ref_p, p)
    # after one step from zeros the first moment is (1 - b1) times the
    # clipped mean gradient
    out["grads"] = _max_diff(ref_state["m"], state["m"]) / (1 - opt_cfg.b1)

    frames = batch.get("frames")
    out.update(serve(api, axes, ref_p, p, toks, frames, rule))
    # a batch of one: the cache's sequence over "data" (the cache specs'
    # rule for long_500k), each device's decode kernel over its rows; an
    # encoder-decoder's cache is not split (its batch of one on no axis)
    out["batch1"] = serve(api, axes, ref_p, p, toks[:1],
                          None if frames is None else frames[:1], rule)
    return out


def serve(api, axes: Axes, ref_p, p, toks, frames, rule) -> dict:
    """A prefill and two decode steps (the decode layout), un-meshed from
    ``ref_p`` and on the mesh from ``p``: the largest differences.  An
    encoder-decoder's prompt is ``frames``, and its decoder starts at
    position 1 (the serving launcher's loop)."""
    out = {}
    if frames is None:
        prompt, first = {"tokens": toks[:, :PROMPT]}, PROMPT
    else:
        prompt, first = {"frames": frames[:, :PROMPT]}, 1
    ref_logits, ref_cache = steps.make_prefill_step(api, SEQ)(ref_p, prompt)
    # the cache is bfloat16, so float32 sums in another order may round
    # an entry to its neighbour
    with rule():
        logits, cache = steps.dist_prefill_step(api, axes, SEQ)(p, prompt)
    out["prefill_logits"] = float((_full(logits) - ref_logits).abs().max())
    out["cache"] = [_max_diff(ref_cache, cache),
                    max(float(c.float().abs().max())
                        for c in leaves(ref_cache) if c.is_floating_point())]
    out["prefill_cache_placements"] = sorted({str(c.placements)
                                              for c in leaves(cache)})
    # two decode steps from one cache: the un-meshed prefill's in float32
    # (so the new rows are not rounded to bfloat16 either), laid out by
    # the cache specs on the mesh
    ref_cache = {k: v.float() if v.is_floating_point() else v
                 for k, v in ref_cache.items()}
    cache = {k: v.clone() for k, v in ref_cache.items()}
    decode = steps.dist_decode_step(api, axes)
    diffs = []
    launches = dict.fromkeys(fd.LAUNCHES, 0)
    for pos in (first, first + 1):
        tok = toks[:, pos:pos + 1]
        ref_logits, ref_cache = api.decode_fn(ref_p, ref_cache, tok, pos)
        before = dict(fd.LAUNCHES)
        with rule():
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
    # the card machine's own PyTorch holds the views to its rules there
    rule = contextlib.nullcontext
    if argv[1] == "cuda":
        # one card a rank: NCCL over the launcher's environment (RANK,
        # WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
        out_dir = argv[2]
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
        rule = StrictViews
    try:
        mesh = mesh_mod.make_smoke_mesh()
        axes = Axes.for_mesh(mesh)
        result = {"mesh": list(mesh.shape), "device": str(dev)}
        with mesh_mod.enter_mesh(mesh):
            for arch in ARCHS:
                result[arch] = check(arch, axes, dev, rule)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main(sys.argv)
