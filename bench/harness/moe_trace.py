"""The device time of an expert layer's work, from the program's host
spans beside a device trace of a few decode steps run eagerly.

The traced sub-window replays the captured step alone.  After it, a
profiler session of its own (``setups/moe_hybrid_lm.py``:
``traced()["eager"]()``, run once, when a reader first asks, giving
(its device trace, its eager steps' host interval)) holds two replays
and then a few steps through the eager ``decode_fn``, in which each
expert layer records ``moe.layer`` over ``moe.route``, ``moe.experts``,
``moe.shared`` and ``moe.combine`` and keeps its choices
(``repro_torch.obs.spans.RECORDER.kept``).  So the traced sub-window's
idle share and device time are the replays' own.  The spans' clock is
fitted to that session's trace by its replays (each ``decode.replay``
holds its ``cudaGraphLaunch``, ``harness/spans.py``); a device event
belongs to the interval in which the host made the runtime call that
launched it (the two share a correlation id).  In a checkout whose
program records none of these, every function here gives ``None``.
"""
from __future__ import annotations

import bisect

from harness import spans as hs

SPANS = ("moe.layer", "moe.experts")


def kept():
    """The choices (T, k) the expert layers kept in the traced
    sub-window, in order, or ``None``."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    return getattr(spans.RECORDER, "kept", None)


def _seconds_launched_in(trace, launch_at: dict, intervals: list) -> float:
    """Device seconds of the events whose launching call started inside
    one of ``intervals`` (trace microseconds)."""
    intervals = sorted(intervals)
    starts = [a for a, _ in intervals]
    total = 0.0
    for _, a, b, corr in trace.device:
        t = launch_at.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= intervals[i][1]:
            total += b - a
    return total * 1e-6


def eager_seconds(run) -> dict | None:
    """Device seconds of the kernels launched in the eager steps
    (``"all"``) and under each of :data:`SPANS`, with the number of
    ``moe.layer`` spans (``"layers"``); ``None`` where the run has no
    device trace or no eager steps, the program no such spans, or the
    clock no fit."""
    eager = (run.traced or {}).get("eager")
    if not run.trace or eager is None:
        return None
    trace, interval = eager()
    snap = hs.recorded()
    fit = hs.fit_clock(snap, trace, *hs.DECODE_CALL)
    if fit is None:
        return None
    by_name = {name: [hs.on_trace(s.start_ns, s.end_ns, fit)
                      for s in snap.spans if s.name == name]
               for name in SPANS}
    if not by_name["moe.layer"]:
        return None
    launch_at = {corr: a for _, a, _, corr in trace.runtime
                 if corr is not None}
    out = {"all": _seconds_launched_in(trace, launch_at,
                                       [hs.on_trace(*interval, fit)]),
           "layers": len(by_name["moe.layer"])}
    for name, intervals in by_name.items():
        out[name] = _seconds_launched_in(trace, launch_at, intervals)
    return out
