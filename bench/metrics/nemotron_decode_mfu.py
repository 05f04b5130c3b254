"""The reasoning cell's decode step's share of the card's bf16 peak, in
per cent: Nemotron-H's FLOPs of every step of the window
(``harness/nemotron_counts.py``: the Mamba and attention projections,
each expert block's router, its 6 routed experts and the shared one, the
untied head, the state update, QK^T and PV over each step's length) over
the window's seconds (host clock, to its final synchronisation), over
989 TFLOP/s.  Moves ``decode_tokens_per_s``."""
from harness import nemotron_counts, yardstick


def read(run):
    secs, lengths = run.window.get("elapsed_s"), run.window.get("lengths")
    m = run.info.get("model", {})
    if not secs or not lengths or "n_routed_experts" not in m:
        return None
    b = run.info["batch"]
    flops = sum(nemotron_counts.decode_step_flops(m, b, n) for n in lengths)
    return flops / secs / yardstick.PEAK_FLOPS["bfloat16"] * 100.0
