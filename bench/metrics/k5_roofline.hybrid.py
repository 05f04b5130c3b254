"""K5's share of its roofline in the hybrid decode cell, in per cent: the
least time of the traced steps' decode-attention calls (one an
application of a shared block, at G 1 and the head of 2 hidden_size /
heads; each the larger of its bytes, K and V rows up to the step's
length, q and the output, over 3.35 TB/s, and its QK^T and PV operations
over 989 TFLOP/s) over K5's device seconds (``harness/readers.py``).
Moves ``decode_tokens_per_s``."""
from harness import hybrid_counts, yardstick
from harness.readers import k5_seconds


def read(run):
    k5 = k5_seconds(run)
    if not k5 or "hybrid_layer_ids" not in run.info["model"]:
        return None
    s = hybrid_counts.sizes(run.info["model"])
    b = run.info["batch"]
    least = 0.0
    for length in run.traced["lengths"]:
        least += s["apps"] * yardstick.least_seconds(
            yardstick.k5_flops(b, s["h"], s["dh"], length),
            yardstick.k5_bytes(b, s["h"], s["hk"], s["dh"], length),
            "bfloat16")
    return least / k5 * 100.0
