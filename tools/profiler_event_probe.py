#!/usr/bin/env python3
"""How many of a CUDA graph's kernel events ``torch.profiler`` reports.

    python3 tools/profiler_event_probe.py [--arch ID ...] [--sessions N]

Serves each model at its published width and depth (random bf16 weights
from a seed; Whisper from 1500 frames of stub embeddings, decoding from
position 1), captures the decode step as a CUDA graph
(``launch.steps.graph_decode_step``) and replays it greedily under
``torch.profiler`` in four ways, ``--sessions`` profiler sessions each:
8 and 32 replays a session, queued back to back, with the profiler's
window starting and ending right at the replays or 50 ms away from them.
Each replay launches the same kernels, so every session of one way should
see the same device events; for each session it prints the device events
in all and those of K5's split and combine kernels, against the launches
per replay (from the capture) times the replays, and how far the first and
last device events lie inside the host's span of the replays (Kineto drops
an event that falls outside the profiler's window; ``KINETO_LOG_LEVEL=1``
prints its count as ``Out-of-range`` after each session).  Needs the card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SEED = 20260311
K5 = {"flash_decode_split_kernel": "flash_decode",
      "flash_decode_combine_kernel": "flash_decode_combine"}
# (replays a session, idle seconds at both ends of the profiler's window)
WAYS = [(8, 0.0), (8, 0.05), (32, 0.0), (32, 0.05)]


def session(step, tok, start, replays, guard):
    """One profiler session of ``replays`` greedy replays, queued back to
    back, with ``guard`` idle seconds after the profiler starts and before
    it stops: (device events in all, {K5 kernel: events}, lead, tail).
    ``lead`` is the first device event's start less the start of the host
    span that launches the replays, ``tail`` that span's end (after the
    last synchronize) less the last device event's end, both in us on the
    trace's clock: a negative one is the card's clock running off the
    host's."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(guard)
        with record_function("replays"):
            for i in range(replays):
                tok = step(tok, start + i).argmax(dim=-1)[:, None]
            torch.cuda.synchronize()
        time.sleep(guard)
    total, k5 = 0, dict.fromkeys(K5, 0)
    first = last = span = None
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            total += 1
            for name in k5:
                k5[name] += name in ev.name
            r = ev.time_range
            first = r.start if first is None else min(first, r.start)
            last = r.end if last is None else max(last, r.end)
        elif ev.name == "replays":
            span = ev.time_range
    return total, k5, first - span.start, span.end - last


def probe(arch, sessions):
    import numpy as np
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import registry

    api = registry.get(arch)
    cfg = api.cfg
    rng = np.random.default_rng(SEED)
    params = api.init_params(SEED, device="cuda")
    b = 4
    if cfg.family == "audio":
        inputs = {"frames": torch.from_numpy(rng.standard_normal(
            (b, 1500, cfg.d_model))).to("cuda", torch.bfloat16)}
        start = 1
    else:
        start = 480
        inputs = {"tokens": torch.from_numpy(rng.integers(
            3, cfg.vocab, size=(b, start))).cuda()}
    logits, cache = api.prefill_fn(params, inputs, max_len=start + 32)
    step = steps.graph_decode_step(api, params, cache, b)
    tok = logits.argmax(dim=-1)[:, None]
    for replays, guard in WAYS:
        way = f"{replays} replays, {guard} s idle at both ends"
        want = {k: step.launches_per_replay[c] * replays
                for k, c in K5.items()}
        for s in range(sessions):
            total, k5, lead, tail = session(step, tok, start, replays,
                                            guard)
            print(f"{arch}: {way}, session {s}: {total} device events, "
                  f"lead {lead:.1f} us, tail {tail:.1f} us; "
                  + "; ".join(f"{k} {k5[k]} (launches {want[k]})"
                              for k in K5), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+",
                    default=["zamba2-2.7b", "whisper-medium"])
    ap.add_argument("--sessions", type=int, default=6)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profiler_event_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    for arch in args.arch:
        probe(arch, args.sessions)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
