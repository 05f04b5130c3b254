"""The routed experts' share of their roofline in the reasoning cell, in
per cent: the least time of the eager traced steps' expert layers over
the device seconds of the kernels launched under their ``moe.experts``
spans (``harness/moe_trace.py``).  A layer's least time is the larger of
its bytes, the ``up`` and ``down`` matrices of every expert that at least
one of the step's tokens chose, read once in bfloat16, and the chosen
rows in and out, over 3.35 TB/s, and its FLOPs over 989 TFLOP/s
(``harness/nemotron_counts.py::expert_least``): the same work whatever
implements it.  Nothing where the program keeps no choices.  Moves
``decode_tokens_per_s``."""
from harness import moe_trace, nemotron_counts, yardstick


def read(run):
    m = run.info.get("model", {})
    if "n_routed_experts" not in m:
        return None
    secs, routes = moe_trace.eager_seconds(run), moe_trace.kept()
    if not secs or not secs["moe.experts"] or not routes or \
            len(routes) != secs["layers"]:
        return None
    least = sum(yardstick.least_seconds(*nemotron_counts.expert_least(
        m, int(r.unique().numel()), r.numel()), "bfloat16") for r in routes)
    return least / secs["moe.experts"] * 100.0
