"""Batched serving demo: prefill a prompt batch, decode greedily with the
KV cache (the S1 offloading schedule: the queries stay resident while the
cache streams through block by block).

The port's counterpart of ``examples/serve_decode.py``, on ``repro_torch``.
It runs on the card: every GQA layer of every decode step goes through the
hand-written decode kernel (``kernels/csrc/flash_decode.cu``), and the step
is one CUDA graph, replayed.  ``--device cpu`` runs the plain versions,
eagerly; there is no fallback from the card to the CPU.

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""
import argparse
import json

from repro_torch.launch.serve import serve
from repro_torch.obs.counters import COUNTS

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    run = serve("tinyllama-1.1b", smoke=True, batch=4, prompt_len=32,
                gen_len=12, device=args.device)
    print("sampled continuation ids:\n", run.tokens)
    # the wrappers count the graph's warm-up and capture; a replay runs
    # launches_per_replay more without passing through them
    print("decode kernel launches " + json.dumps(
        {"counted": {name: COUNTS[name] for name in
                     ("flash_decode", "flash_decode_combine")},
         "replays": run.replays,
         "per_replay": run.launches_per_replay,
         "shape": list(run.tokens.shape)}))
