"""K5's share of its roofline, in per cent: the least time of the traced
steps' decode-attention calls (one a layer; each the larger of its
bytes, K and V rows up to the step's length, q and the output, over 3.35
TB/s, and its QK^T and PV operations over 989 TFLOP/s) over K5's device
seconds (``harness/readers.py``).  Moves ``decode_tokens_per_s``."""
from harness import yardstick
from harness.readers import k5_seconds


def read(run):
    k5 = k5_seconds(run)
    if not k5:
        return None
    m, b = run.info["model"], run.info["batch"]
    h, hk = m["num_attention_heads"], m["num_key_value_heads"]
    dh = m["hidden_size"] // h
    least = 0.0
    for length in run.traced["lengths"]:
        least += m["num_hidden_layers"] * yardstick.least_seconds(
            yardstick.k5_flops(b, h, dh, length),
            yardstick.k5_bytes(b, h, hk, dh, length), "bfloat16")
    return least / k5 * 100.0
