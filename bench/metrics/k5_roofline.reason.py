"""K5's share of its roofline in the reasoning cell, in per cent: the
least time of the traced steps' decode-attention calls (one an attention
block, six a step, at G 16 and D 128; each the larger of its bytes, K and
V rows up to the step's length read once, q and the output, over 3.35
TB/s, and its QK^T and PV operations over 989 TFLOP/s) over K5's device
seconds (``harness/readers.py``).  Moves ``decode_tokens_per_s``."""
from harness import nemotron_counts, yardstick
from harness.readers import k5_seconds


def read(run):
    m = run.info.get("model", {})
    k5 = k5_seconds(run)
    if not k5 or "n_routed_experts" not in m:
        return None
    s = nemotron_counts.sizes(m)
    b = run.info["batch"]
    least = 0.0
    for length in run.traced["lengths"]:
        least += s["attn"] * yardstick.least_seconds(
            yardstick.k5_flops(b, s["h"], s["dh"], length),
            yardstick.k5_bytes(b, s["h"], s["hk"], s["dh"], length),
            "bfloat16")
    return least / k5 * 100.0
