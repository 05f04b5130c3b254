"""Training launcher on one card: data pipeline, train step, and the
checkpoint/restart loop.

    python -m repro_torch.launch.train [--full] [--arch ID] [--steps N]
        [--batch B] [--seq-len S] [--lr LR] [--ckpt-dir DIR]
        [--checkpoint-every K] [--device cuda|cpu]

Without ``--full`` it trains the reduced config of ``--arch`` (any id of
``registry.ARCH_IDS``); ``--full`` trains the published config on one
card (TinyLlama-1.1B with its AdamW state and float32 gradient sums takes
about 18 GB before activations; the larger ids need a card that holds
them, and the MoE ids at published width more than one).  The weights are
random from seed 0 and the data is the seeded ``SyntheticLM`` stream
(Whisper, the audio family, takes seeded stub frames beside it).  The
JAX package's production mesh and ``--multi-pod`` have no counterpart
until the port has a mesh.  The default device is the card; there is no
CPU fallback unless ``--device cpu`` is asked for.

Fault tolerance: a checkpoint every ``--checkpoint-every`` steps through
the atomic ``CheckpointManager``, and one at the end; on a restart the
latest committed step is restored, and the deterministic pipeline resumes
from it, so no step runs twice and none is skipped.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, Pipeline, SyntheticLM
from repro_torch.launch import steps as steps_mod
from repro_torch.models import registry
from repro_torch.models.registry import ModelApi
from repro_torch.optim import adamw
from repro_torch.reference_io import resolve_device


@dataclasses.dataclass
class TrainRun:
    """What a run of the loop did: the steps it ran (``start_step`` + 1
    onwards; none after a restart at the last step), each one's loss,
    pre-clip gradient norm and host milliseconds (synchronised), and the
    parameters and optimizer state it ended with."""

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
          device: str | torch.device = "cuda") -> TrainRun:
    api = registry.get_reduced(arch) if smoke else registry.get(arch)
    return _train_loop(api, resolve_device(device), steps=steps,
                       batch=batch, seq_len=seq_len, ckpt_dir=ckpt_dir,
                       checkpoint_every=checkpoint_every, lr=lr,
                       log_every=log_every,
                       num_microbatches=num_microbatches)


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


def _train_loop(api: ModelApi, dev: torch.device, *, steps, batch, seq_len,
                ckpt_dir, checkpoint_every, lr, log_every,
                num_microbatches) -> TrainRun:
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
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state, meta = mgr.restore_latest({"params": params,
                                          "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start_step = meta["step"]
        pipe.restore({"step": start_step, "shard": 0})
        print(f"[train] restored step {start_step}")

    step_fn = steps_mod.make_train_step(api, opt_cfg,
                                        num_microbatches=num_microbatches)
    run = TrainRun(start_step, [], [], [], params, opt_state)
    for step in range(start_step, steps):
        inputs = _batch_tensors(api, pipe.next(), step, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, gnorm, params, opt_state = step_fn(params, opt_state, inputs)
        run.losses.append(float(loss))         # waits for the step
        run.step_ms.append((time.perf_counter() - t0) * 1e3)
        run.gnorms.append(float(gnorm))
        if (step + 1) % log_every == 0 or step == steps - 1:
            print(f"[train] step {step + 1}/{steps} loss={run.losses[-1]:.4f}"
                  f" gnorm={run.gnorms[-1]:.2f} ({run.step_ms[-1]:.1f} ms)")
        if mgr and (step + 1) % checkpoint_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
    if mgr:
        mgr.save(steps, {"params": params, "opt": opt_state}, block=True)
    run.params, run.opt_state = params, opt_state
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="train the published config, not the reduced one")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq_len=args.seq_len, lr=args.lr,
                ckpt_dir=args.ckpt_dir,
                checkpoint_every=args.checkpoint_every, device=args.device)
    if run.losses:
        print(f"[train] first loss {run.losses[0]:.4f} -> last "
              f"{run.losses[-1]:.4f}")
    else:
        print(f"[train] nothing to do: restored step {run.start_step}")


if __name__ == "__main__":
    main()
