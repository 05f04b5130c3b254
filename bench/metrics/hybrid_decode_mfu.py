"""The hybrid decode step's share of the card's bf16 peak, in per cent:
Zamba2's FLOPs of every step of the window (``harness/hybrid_counts.py``:
both mixers' projections, the shared blocks' products at every
application with their adapters, the tied head, the state update, QK^T
and PV over each step's length) over the window's seconds (host clock,
to its final synchronisation), over 989 TFLOP/s.  Moves
``decode_tokens_per_s``."""
from harness import hybrid_counts, yardstick


def read(run):
    secs, lengths = run.window.get("elapsed_s"), run.window.get("lengths")
    m = run.info.get("model", {})
    if not secs or not lengths or "hybrid_layer_ids" not in m:
        return None
    b = run.info["batch"]
    flops = sum(hybrid_counts.decode_step_flops(m, b, n) for n in lengths)
    return flops / secs / yardstick.PEAK_FLOPS["bfloat16"] * 100.0
