"""End-to-end training driver: trains a reduced-config LM on the synthetic
pipeline with checkpointing.  Use --steps 200 for the full demo (loss drops
well below the ~5.5 random-vocab floor).

The port's counterpart of ``examples/train_lm.py``, on ``repro_torch``.  It
trains on the card; ``--device cpu`` trains on the CPU, and there is no
fallback from the card to the CPU.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 30 [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch.train import train

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        losses = train(args.arch, smoke=True, steps=args.steps,
                       batch=args.batch, seq_len=args.seq_len, ckpt_dir=d,
                       checkpoint_every=max(10, args.steps // 2),
                       lr=1e-3, log_every=5, device=args.device).losses
    k = max(1, min(5, len(losses) // 3))
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"loss {first:.3f} (first {k}) -> {last:.3f} (last {k})")
    assert last < first, "training did not reduce loss"
