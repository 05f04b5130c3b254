"""Training launcher: mesh, data pipeline, train step, and the
checkpoint/restart loop.

    python -m repro_torch.launch.train [--full] [--multi-pod] [--arch ID]
        [--steps N] [--batch B] [--seq-len S] [--lr LR] [--ckpt-dir DIR]
        [--checkpoint-every K] [--device cuda|cpu]

Without ``--full`` it trains the reduced config of ``--arch`` (any id of
``registry.ARCH_IDS``) un-meshed.  ``--full`` trains the published config
on a mesh: the production mesh (16 x 16, or 2 x 16 x 16 with
``--multi-pod``) when the process group has its 256 (512) ranks
(``torchrun``), else the smoke mesh over the ranks there are, every step
through ``steps.dist_train_step``.  On one card the smoke mesh is (1, 1),
where every placement holds the whole tensor: there each step runs the
local program, the un-meshed step on the same tensors, which is the
published config on one card as before (DTensor's dispatch would add to
every operation and shard nothing).  TinyLlama-1.1B with its AdamW state
and float32 gradient sums takes about 18 GB before activations; the
larger ids need a card that holds them, and the MoE ids at published
width more than one.
``--multi-pod`` without 512 ranks is an error.  The weights are random
from seed 0 and the data is the seeded ``SyntheticLM`` stream (Whisper,
the audio family, takes seeded stub frames beside it).  The default
device is the card; there is no CPU fallback unless ``--device cpu`` is
asked for (a gloo group then).

Fault tolerance: a checkpoint every ``--checkpoint-every`` steps through
the atomic ``CheckpointManager``, and one at the end; on a restart the
latest committed step is restored, and the deterministic pipeline resumes
from it, so no step runs twice and none is skipped.
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

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, Pipeline, SyntheticLM
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import enter_mesh, launch_mesh
from repro_torch.models import registry
from repro_torch.models.common import Axes, map_defs
from repro_torch.models.registry import ModelApi
from repro_torch.optim import adamw
from repro_torch.reference_io import resolve_device


@dataclasses.dataclass
class TrainRun:
    """What a run of the loop did: the steps it ran (``start_step`` + 1
    onwards; none after a restart at the last step), each one's loss,
    pre-clip gradient norm and host milliseconds (synchronised), and the
    parameters and optimizer state it ended with (DTensors on a mesh of
    more than one device)."""

    start_step: int
    losses: list[float]
    gnorms: list[float]
    step_ms: list[float]
    params: dict
    opt_state: dict


def train(arch: str, *, smoke: bool = True, steps: int = 10,
          batch: int = 2, seq_len: int = 128, ckpt_dir: str | None = None,
          checkpoint_every: int = 50, lr: float = 3e-4,
          log_every: int = 10, num_microbatches: int = 1,
          multi_pod: bool = False,
          device: str | torch.device = "cuda") -> TrainRun:
    """The reduced config un-meshed (``smoke``), or the published one on
    a mesh, whose local program runs where the mesh has one device (the
    module's docstring).  A process group is made if there is none
    (``mesh.init_process_group``) and left for the caller."""
    dev = resolve_device(device)
    kw = dict(steps=steps, batch=batch, seq_len=seq_len, ckpt_dir=ckpt_dir,
              checkpoint_every=checkpoint_every, lr=lr, log_every=log_every,
              num_microbatches=num_microbatches)
    if smoke:
        return _train_loop(registry.get_reduced(arch), dev, **kw)
    m = launch_mesh(dev, multi_pod)
    axes = Axes.for_mesh(m) if m.size() > 1 else None
    with enter_mesh(m):
        return _train_loop(registry.get(arch), dev, axes=axes, **kw)


def _batch_tensors(api: ModelApi, batch_np: dict, step: int,
                   dev: torch.device) -> dict:
    """A pipeline batch on ``dev``; for an encoder-decoder the tokens are
    its decoder's, and stub frames (B, S, d) bfloat16 from the step's
    seed go beside them."""
    out = {k: torch.from_numpy(v).to(dev, torch.int64)
           for k, v in batch_np.items()}
    if api.cfg.family == "audio":
        b, s = batch_np["tokens"].shape
        frames = np.random.default_rng([0, step]).standard_normal(
            (b, s, api.cfg.d_model), dtype=np.float32)
        out["frames"] = torch.from_numpy(frames).to(dev, torch.bfloat16)
    return out


def _whole(tree):
    """A tree of DTensors as whole tensors (a gather on a mesh of more than
    one device), for the checkpoint; plain tensors as they are."""
    return map_defs(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def _value(x) -> float:
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def _train_loop(api: ModelApi, dev: torch.device, *, steps, batch, seq_len,
                ckpt_dir, checkpoint_every, lr, log_every,
                num_microbatches, axes: Axes | None = None) -> TrainRun:
    cfg = api.cfg
    # an encoder-decoder's decoder takes dec_seq tokens; its frames the
    # sequence
    tok_len = min(seq_len, cfg.dec_seq) if cfg.family == "audio" \
        else seq_len
    pipe = Pipeline(SyntheticLM(vocab=cfg.vocab, seed=0),
                    DataConfig(global_batch=batch, seq_len=tok_len))
    params = api.init_params(0, device=dev)
    opt_state = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(lr=lr)

    mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    # on a mesh every rank gathers what is saved, and rank 0 writes it
    writer = mgr is not None and (not dist.is_initialized()
                                  or dist.get_rank() == 0)
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state, meta = mgr.restore_latest({"params": params,
                                          "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start_step = meta["step"]
        pipe.restore({"step": start_step, "shard": 0})
        print(f"[train] restored step {start_step}")

    if axes is None:
        step_fn = steps_mod.make_train_step(api, opt_cfg, num_microbatches)
    else:
        step_fn = steps_mod.dist_train_step(api, axes, num_microbatches,
                                            opt_cfg)
    run = TrainRun(start_step, [], [], [], params, opt_state)
    for step in range(start_step, steps):
        inputs = _batch_tensors(api, pipe.next(), step, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, gnorm, params, opt_state = step_fn(params, opt_state, inputs)
        run.losses.append(_value(loss))        # waits for the step
        run.step_ms.append((time.perf_counter() - t0) * 1e3)
        run.gnorms.append(_value(gnorm))
        if (step + 1) % log_every == 0 or step == steps - 1:
            print(f"[train] step {step + 1}/{steps} loss={run.losses[-1]:.4f}"
                  f" gnorm={run.gnorms[-1]:.2f} ({run.step_ms[-1]:.1f} ms)")
        if mgr and (step + 1) % checkpoint_every == 0:
            state = _whole({"params": params, "opt": opt_state})
            if writer:
                mgr.save(step + 1, state)
    if mgr:
        state = _whole({"params": params, "opt": opt_state})
        if writer:
            mgr.save(steps, state, block=True)
    run.params, run.opt_state = params, opt_state
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="train the published config on a mesh, not the "
                    "reduced one: the production mesh when the process "
                    "group has its ranks, else the smoke mesh over the "
                    "ranks there are, (1, 1) on one card, where the "
                    "local program runs (the published config on one "
                    "card)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --full: the 2 x 16 x 16 mesh (512 ranks)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        run = train(args.arch, smoke=args.smoke, steps=args.steps,
                    batch=args.batch, seq_len=args.seq_len, lr=args.lr,
                    ckpt_dir=args.ckpt_dir,
                    checkpoint_every=args.checkpoint_every,
                    multi_pod=args.multi_pod, device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if run.losses:
        print(f"[train] first loss {run.losses[0]:.4f} -> last "
              f"{run.losses[-1]:.4f}")
        print(f"[train] losses {json.dumps(run.losses)}; step ms "
              f"{json.dumps([round(t, 1) for t in run.step_ms])}")
    else:
        print(f"[train] nothing to do: restored step {run.start_step}")


if __name__ == "__main__":
    main()
