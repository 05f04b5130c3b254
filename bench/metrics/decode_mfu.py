"""The whole decode step's share of the card's bf16 peak, in per cent:
the model's FLOPs of every step of the window (2 x the matmul parameters
a token touches x the batch, plus QK^T and PV over each step's length,
``harness/yardstick.py``) over the window's seconds (host clock, to its
final synchronisation), over 989 TFLOP/s.  Moves
``decode_tokens_per_s``."""
from harness import yardstick


def read(run):
    secs, lengths = run.window.get("elapsed_s"), run.window.get("lengths")
    if not secs or not lengths or "model" not in run.info:
        return None
    m, b = run.info["model"], run.info["batch"]
    flops = sum(yardstick.decode_step_flops(m, b, n) for n in lengths)
    return flops / secs / yardstick.PEAK_FLOPS["bfloat16"] * 100.0
