"""A cell of the benchmark rehearsed on the CPU at a tiny size: the
program's plain versions in place of its CUDA kernels, and the eager
decode step in place of the CUDA graph.

    python3 bench/tests/rehearse.py <workload> [--seed N] [--seconds S]
        [--trace 0|1] [--fault NAME] [--modules]

Prints the run's result object as the last line; ``--modules`` adds the
top-level names of every loaded module (key ``modules``).  ``--fault``
breaks the timed path underneath the harness (see ``FAULTS``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import run as bench_run  # noqa: E402

TINY_CONV = {
    "layers": [
        {"c_in": 3, "h_in": 6, "w_in": 6, "n_kernels": 4, "h_k": 3, "w_k": 3},
        {"c_in": 4, "h_in": 6, "w_in": 6, "n_kernels": 8, "h_k": 3,
         "w_k": 3}],
}
TINY_CONV_MIX = {"pool_images": 8, "check_every": 1, "warm_passes": 1,
                 "reserve": 2, "trace_passes": 2}
TINY_LM = {"hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "vocab_size": 256}
TINY_LM_MIX = {"batch": 4, "context": 16, "gen": 4, "first_tokens": 4,
               "warm_steps": 1, "events": 8, "trace_steps": 2,
               "check_sessions": 4}


def tiny(cfg: dict, mix: dict) -> None:
    if cfg["setup"] == "conv_net":
        cfg.update(TINY_CONV)
        mix.update(TINY_CONV_MIX)
    else:
        cfg.update(TINY_LM)
        mix.update(TINY_LM_MIX)


def _conv_fault(kind: str):
    """Wrap the planned conv kernel's entry so that it breaks."""
    from repro_torch.kernels import emit
    real = emit.conv2d_offload_planned
    calls = {"n": 0}

    def broken(x, w, **kw):
        calls["n"] += 1
        out = real(x, w, **kw)
        if kind == "unchanged":
            return out.new_zeros(out.shape)
        if kind == "half_batch" and calls["n"] % 2:
            return out.new_zeros(out.shape)
        if kind == "altered" and calls["n"] == 3:
            out = out.clone()
            out.view(-1)[0] += 1.0
        return out
    emit.conv2d_offload_planned = broken


def _decode_fault(kind: str):
    """Break the decode step: the cache left unwritten, half of the batch's
    attention left out, or one token's logit raised where it is made."""
    from repro_torch.models import transformer
    if kind == "unchanged":
        transformer.write_row = lambda cache, pos, new: None
    elif kind == "half_batch":
        real = transformer.decode_attend

        def attend(q, k, v, lengths):
            out = real(q, k, v, lengths)
            out[out.shape[0] // 2:] = 0
            return out
        transformer.decode_attend = attend
    elif kind == "altered":
        real = transformer._logits
        calls = {"n": 0}

        def logits(x, lm_head):
            out = real(x, lm_head)
            calls["n"] += 1
            if calls["n"] % 3 == 0:
                out[0, calls["n"] % out.shape[1]] += 1e4
            return out
        transformer._logits = logits


FAULTS = ("unchanged", "half_batch", "altered")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workload")
    ap.add_argument("--seed", type=int, default=2**31 + 12345)
    ap.add_argument("--seconds", type=float, default=0.3)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault", choices=FAULTS)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--modules", action="store_true")
    args = ap.parse_args(argv)
    bench_run.prepare_env(bench_run.ROOT)
    import torch
    from harness import spec
    bench = spec.load_benchmark()
    setup = spec.config(bench, spec.workload(bench, args.workload)
                        ["config"])["setup"]
    if args.fault:
        (_conv_fault if setup == "conv_net" else _decode_fault)(args.fault)
    result = bench_run.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), device=torch.device("cpu"),
                                override=tiny, control=args.control)
    if args.modules:
        result["modules"] = sorted({m.split(".")[0] for m in sys.modules})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
