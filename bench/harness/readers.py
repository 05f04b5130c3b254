"""What several per-layer metrics read alike, kept beside the harness so
that each metric's own file stays a few lines."""
from __future__ import annotations

K5_KERNELS = {"flash_decode_split_kernel": "flash_decode",
              "flash_decode_combine_kernel": "flash_decode_combine"}


def enqueue_us(run, mode: str):
    """Host microseconds a call of ``EmittedConv.run`` takes to return,
    over the window's calls of a ``mode`` cell, with no synchronisation
    inside (the wrapper, its plan arithmetic, the Λ transpose's launch,
    the ``ctypes`` call and ``_build.check``)."""
    if run.info.get("mode") != mode or not run.window.get("calls"):
        return None
    return run.window["calls_s"] / run.window["calls"] * 1e6


def idle_percent(run):
    """The share of the traced sub-window, in per cent, in which no
    operation ran on the device (the union of the trace's kernels, copies
    and sets, against the host's clock around the sub-window and its
    final synchronisation).  A device event that Kineto dropped reads as
    idle: a few in ten thousand at most."""
    if not run.trace or run.trace.window_s <= 0:
        return None
    return (1.0 - run.trace.busy_s() / run.trace.window_s) * 100.0


def k5_seconds(run):
    """K5's device seconds in the traced sub-window (its split and combine
    kernels), each the mean of the events seen times the launches made
    (launches a replay, counted at the capture, x the traced steps), so
    that an event Kineto dropped is not read as time saved."""
    if not run.trace or "launches_per_replay" not in run.info:
        return None
    total, seen = 0.0, False
    for name, counter in K5_KERNELS.items():
        made = run.info["launches_per_replay"][counter] * run.traced["steps"]
        secs = run.trace.kernel_seconds(name, launches=made)
        if secs is not None:
            total += secs
            seen = True
    return total if seen else None
