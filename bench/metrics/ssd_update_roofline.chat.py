"""The fused recurrent-update kernel's share of its roofline in the
hybrid decode cell, in per cent: the least time of the traced steps'
launches (each a layer's float32 state (B, H, P, N) read once and written
once, ``harness/hybrid_counts.py``'s state bytes without the conv window,
over 3.35 TB/s) over the kernel's device seconds in the traced steps (the
mean of the events seen times the launches made: launches a replay,
counted at the capture, x the traced steps).  Only the state is counted,
so it reads above 100 only where the kernel skips work.  Nothing where the
program has no such kernel.  Moves ``decode_tokens_per_s``."""
from harness import hybrid_counts, yardstick

KERNEL = "ssd_update_kernel"


def read(run):
    per = run.info.get("launches_per_replay") or {}
    m = run.info.get("model", {})
    if not run.trace or not per.get(KERNEL) or "hybrid_layer_ids" not in m:
        return None
    made = per[KERNEL] * run.traced["steps"]
    secs = run.trace.kernel_seconds(KERNEL, launches=made)
    if not secs:
        return None
    s = hybrid_counts.sizes(m)
    state = 2 * run.info["batch"] * s["heads"] * s["p"] * s["n"] * 4
    return made * state / yardstick.HBM_BYTES_PER_S / secs * 100.0
