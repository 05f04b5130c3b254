"""The expert layers' share of the eager traced decode steps' device
time, in per cent: the device seconds of the kernels launched under
``moe.layer`` spans (routing, the routed and shared experts, the
combine) over those of every kernel the eager steps launched
(``harness/moe_trace.py``).  Nothing where the program records no such
span.  Moves ``decode_tokens_per_s``."""
from harness import moe_trace


def read(run):
    secs = moe_trace.eager_seconds(run)
    if not secs or not secs["all"]:
        return None
    return secs["moe.layer"] / secs["all"] * 100.0
