"""The fused recurrent-update kernel's share of its roofline in the
reasoning cell, in per cent: the least time of the traced steps'
launches (each a Mamba block's float32 state (B, H, P, N), at N 128 with
B and C in 8 groups, read once and written once over 3.35 TB/s) over the
kernel's device seconds in the traced steps (the mean of the events seen
times the launches made: launches a replay, counted at the capture, x
the traced steps).  Nothing where the program has no such kernel.  Moves
``decode_tokens_per_s``."""
from harness import nemotron_counts, yardstick

KERNEL = "ssd_update_kernel"


def read(run):
    per = run.info.get("launches_per_replay") or {}
    m = run.info.get("model", {})
    if not run.trace or not per.get(KERNEL) or "n_routed_experts" not in m:
        return None
    made = per[KERNEL] * run.traced["steps"]
    secs = run.trace.kernel_seconds(KERNEL, launches=made)
    if not secs:
        return None
    s = nemotron_counts.sizes(m)
    state = 2 * run.info["batch"] * s["heads"] * s["p"] * s["n"] * 4
    return made * state / yardstick.HBM_BYTES_PER_S / secs * 100.0
