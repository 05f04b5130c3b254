"""Serving launcher: batched prefill + greedy decode loop on one card.

The decode step is the S1 offloading schedule: resident queries stream the
KV cache block by block, through the hand-written decode kernel
(``kernels/csrc/flash_decode.cu``) on every GQA layer of every step.  On
the card the step is one CUDA graph, captured once after the prefill and
replayed every step (``steps.graph_decode_step``, the counterpart of the
JAX package's jitted step); on the CPU it runs eagerly
(``steps.make_decode_step``).

    python -m repro_torch.launch.serve [--full] [--multi-pod] [--arch ID]
        [--batch B] [--prompt-len P] [--gen-len G] [--device cuda|cpu]

``--arch`` takes every id of the JAX package's registry
(``registry.ARCH_IDS``, ten) and the port's own (``registry.PORT_IDS``:
Zamba2-7B and NVIDIA-Nemotron-3-Nano-30B-A3B as published).  A model
without mesh rules (``ModelApi.meshed`` false: those two) is served
un-meshed, with ``--full`` too, on one card.  Without ``--full`` it serves the reduced
config un-meshed; ``--full`` serves the architecture at its published size
(TinyLlama-1.1B: about 2.2 GB of bfloat16 weights, random from seed 0;
the larger ids need a card that holds them) on a mesh, as the training
launcher lays it out: the production mesh when the process group has its
256 (512 with ``--multi-pod``) ranks, else the smoke mesh, (1, 1) on one
card.  The prefill is ``steps.dist_prefill_step``; the decode steps are
``steps.dist_decode_step`` on DTensors, except on a mesh of one device
and a card, where every placement holds the whole tensor: there the CUDA
graph captures the local program (the DTensors' local tensors, the same
tensors), as un-meshed.  The SSM and hybrid ids
(Mamba2, Zamba2) take token prompts as the transformers do.  Whisper
(``whisper-medium``, the audio family) takes ``--prompt-len`` frames of
stub embeddings (B, prompt_len, d_model) in bfloat16, drawn from the
loop's seeded generator; its prefill encodes them and primes the decoder
with one BOS token, and decoding starts at position 1, so ``1 + gen_len``
may not pass ``dec_seq``.  It prints prefill ms, the capture's ms, decode
ms per step and tokens per second.  The default device is the card; there
is no CPU fallback unless ``--device cpu`` is asked for.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import enter_mesh, launch_mesh
from repro_torch.models import registry
from repro_torch.models.common import Axes, map_defs
from repro_torch.models.registry import ModelApi
from repro_torch.reference_io import resolve_device


class ServeConfigError(ValueError):
    """A serving config that cannot run (non-positive batch/lengths, or
    more decoder positions than an encoder-decoder's ``dec_seq``) —
    caught at the entry point instead of surfacing as a shape error or a
    device fault deep inside the model."""


@dataclasses.dataclass(frozen=True)
class ServeRun:
    """One serving run: the generated tokens (B, gen_len) and its times,
    each taken on the host clock around work that ends in a device
    synchronise."""

    tokens: np.ndarray
    prefill_ms: float
    decode_ms_per_step: float
    tokens_per_s: float          # generated tokens of the batch / decode time
    # the CUDA graph's warm-up and capture (None: eager steps); not in the
    # decode time
    capture_ms: float | None = None
    # decode kernel launches one replay makes, by name (None: eager steps)
    launches_per_replay: dict | None = None
    replays: int = 0


def check_serve_config(cfg, batch: int, prompt_len: int, gen_len: int
                       ) -> None:
    """Raise ``ServeConfigError`` for a run that cannot be served.  The
    JAX package's decoder of an encoder-decoder clamps a write past
    ``dec_seq`` to its last row silently; the port's ``index_copy_``
    would fault on the device, so it is refused here."""
    if batch < 1 or prompt_len < 1 or gen_len < 1:
        raise ServeConfigError(
            f"batch, prompt_len and gen_len must all be >= 1, got "
            f"batch={batch} prompt_len={prompt_len} gen_len={gen_len}")
    if cfg.family == "audio" and 1 + gen_len > cfg.dec_seq:
        raise ServeConfigError(
            f"{cfg.name} decodes positions 1..{gen_len}, past its "
            f"dec_seq={cfg.dec_seq} rows; gen_len may be at most "
            f"{cfg.dec_seq - 1}")


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_len: int = 16, multi_pod: bool = False,
          device: str | torch.device = "cuda") -> ServeRun:
    """The reduced config un-meshed (``smoke``), or the published one on
    a mesh (the module's docstring).  A process group is made if there is
    none and left for the caller."""
    api = registry.get_reduced(arch) if smoke else registry.get(arch)
    check_serve_config(api.cfg, batch, prompt_len, gen_len)
    dev = resolve_device(device)
    kw = dict(batch=batch, prompt_len=prompt_len, gen_len=gen_len)
    if smoke or not api.meshed:
        return _serve_loop(api, api.init_params(0, device=dev), **kw)
    m = launch_mesh(dev, multi_pod)
    with enter_mesh(m):
        return _serve_loop(api, api.init_params(0, device=dev),
                           axes=Axes.for_mesh(m), **kw)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _local(tree):
    """The local tensors of a tree of DTensors (plain tensors as they
    are): on a mesh of one device, the whole tensors themselves."""
    return map_defs(lambda t: t.to_local() if isinstance(t, DTensor)
                    else t, tree)


def _serve_loop(api: ModelApi, params, *, batch: int, prompt_len: int,
                gen_len: int, graph: bool | None = None,
                axes: Axes | None = None) -> ServeRun:
    """Prefill the prompts (an encoder-decoder's frames), then ``gen_len``
    greedy decode steps from the position after them (1 for an
    encoder-decoder).  The tokens stay on the device until the end, so no
    step waits on the host.  ``graph``: replay the step as a CUDA graph
    (None: on the card yes, on the CPU no; False on the card runs the
    eager step, for a comparison).  With ``axes`` the steps run on the
    ambient mesh (``steps.dist_*_step``); the graph needs a mesh of one
    device, whose local program it captures."""
    cfg = api.cfg
    check_serve_config(cfg, batch, prompt_len, gen_len)
    dev = params["embed"].device
    max_len = prompt_len + gen_len
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(3, cfg.vocab, size=(batch, prompt_len))).to(dev)
    if cfg.family == "audio":
        frames = torch.from_numpy(rng.standard_normal(
            (batch, prompt_len, cfg.d_model))).to(dev, torch.bfloat16)
        inputs, start_pos = {"frames": frames}, 1
    else:
        inputs, start_pos = {"tokens": prompts}, prompt_len

    one_device = axes is None or dist.get_world_size() == 1
    if graph is None:
        graph = dev.type == "cuda" and one_device
    if axes is None:
        prefill = steps_mod.make_prefill_step(api, max_len=max_len)
    else:
        prefill = steps_mod.dist_prefill_step(api, axes, max_len=max_len)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, inputs)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    if graph:
        if not one_device:
            raise ValueError("the decode graph captures one device's "
                             "program: a mesh of more than one device "
                             "decodes with graph=False")
        logits = _local(logits)
        step = steps_mod.graph_decode_step(api, _local(params),
                                           _local(cache), batch)
    else:
        eager = steps_mod.make_decode_step(api) if axes is None else \
            steps_mod.dist_decode_step(api, axes)

        def step(tok, pos):
            return eager(params, cache, tok, pos)[0]

    out_tokens = []
    tok = logits.argmax(dim=-1)[:, None]
    t0 = time.perf_counter()
    for i in range(gen_len):
        out_tokens.append(tok[:, 0])
        logits = step(tok, start_pos + i)
        tok = logits.argmax(dim=-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen = torch.stack([t.full_tensor() if isinstance(t, DTensor) else t
                       for t in out_tokens], dim=1).cpu().numpy()
    of_graph = dict(capture_ms=step.capture_ms,
                    launches_per_replay=step.launches_per_replay,
                    replays=step.replays) if graph else {}
    run = ServeRun(tokens=gen, prefill_ms=t_prefill * 1e3,
                   decode_ms_per_step=t_decode / gen_len * 1e3,
                   tokens_per_s=batch * gen_len / t_decode, **of_graph)
    how = (f"CUDA graph captured in {run.capture_ms:.1f} ms, "
           if graph else "eager, ")
    print(f"[serve] {cfg.name} on {dev}: batch={batch} prompt={prompt_len} "
          f"prefill {run.prefill_ms:.2f} ms, {how}{gen_len} decode steps "
          f"{run.decode_ms_per_step:.3f} ms/step, "
          f"{run.tokens_per_s:.1f} tokens/s")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=registry.SERVED_IDS)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="serve the published config on a mesh, not the "
                    "reduced one: the production mesh when the process "
                    "group has its ranks, else the smoke mesh, (1, 1) on "
                    "one card (the published config on one card)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --full: the 2 x 16 x 16 mesh (512 ranks)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=None,
                    help="tokens to generate (default 16; for an "
                    "encoder-decoder at most dec_seq - 1)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    gen_len = args.gen_len
    if gen_len is None:
        api = registry.get_reduced(args.arch) if args.smoke \
            else registry.get(args.arch)
        gen_len = min(16, api.cfg.dec_seq - 1) \
            if api.cfg.family == "audio" else 16
    try:
        run = serve(args.arch, smoke=args.smoke, batch=args.batch,
                    prompt_len=args.prompt_len, gen_len=gen_len,
                    multi_pod=args.multi_pod, device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print("[serve] generated token matrix shape:", run.tokens.shape)
    print("[serve] generated tokens:", json.dumps(run.tokens.tolist()))


if __name__ == "__main__":
    main()
