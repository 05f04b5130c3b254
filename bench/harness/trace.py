"""The profiler's trace of a traced sub-window, and its reduction.

``record(torch, device, work)`` runs ``work()`` under ``torch.profiler``
with the card's activity only (kernels, copies, and the CUDA runtime
calls the host makes), so that the host is not slowed by recording each
of its operators: the idle share stays the host's own.  The trace is
written to a temporary file under ``$TMPDIR``, read back and deleted.

Kineto drops a few device events in a session (0 to 17 of 14k-115k on
this card).  Readers that sum one kernel's time scale the mean of the
launches seen by the launches made (:meth:`DeviceTrace.kernel_seconds`);
the busy time is the union of the events seen, so a dropped event reads
as idle, at most a few in ten thousand.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver"}


def short(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].strip()


class DeviceTrace:
    """Device events ``(name, start_us, end_us, correlation)`` and the
    host's runtime calls of one traced window of ``window_s`` seconds (the
    host's clock around the work and its final synchronisation)."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device = sorted((
            (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("args", {}).get("correlation"))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS), key=lambda e: e[1])
        self.runtime = sorted((
            (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("args", {}).get("correlation"))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in RUNTIME_CATS), key=lambda e: e[1])

    def __bool__(self) -> bool:
        return bool(self.device)

    def matching(self, *needles: str) -> list:
        return [e for e in self.device if any(n in e[0] for n in needles)]

    def kernel_seconds(self, *needles: str, launches: int | None = None
                       ) -> float | None:
        """Device seconds of the kernels whose names hold a needle; with
        ``launches``, the mean of those seen times the launches made."""
        seen = self.matching(*needles)
        if not seen:
            return None
        total = sum(b - a for _, a, b, _ in seen) * 1e-6
        if launches:
            total *= launches / len(seen)
        return total

    def device_seconds(self) -> float:
        """The sum of every device event's time (overlaps counted twice)."""
        return sum(b - a for _, a, b, _ in self.device) * 1e-6

    def _merged(self) -> list:
        merged = []
        for _, a, b, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self._merged()) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, a, b, _ in self.device:
            key = short(name)
            by[key] = by.get(key, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time between device events, summed by what the host was
        doing: in a runtime call that waits (a synchronisation), not yet
        at the launch of the next operation, or past it with the device
        still to start it."""
        launch_of = {r[3]: r for r in self.runtime if r[3] is not None}
        starts = [r[1] for r in self.runtime]
        merged = self._merged()
        firsts = {}
        for name, a, _, corr in self.device:
            firsts.setdefault(a, (name, corr))
        by = {}
        for (_, gap_a), (gap_b, _) in zip(merged, merged[1:]):
            i = bisect.bisect_right(starts, gap_a)
            waiting = [r for r in self.runtime[max(0, i - 64):i]
                       if gap_a < r[2]]
            nxt_name, corr = firsts.get(gap_b, ("?", None))
            launch = launch_of.get(corr)
            if waiting:
                key = f"host in {waiting[-1][0]}"
            elif launch is not None and launch[1] > gap_a:
                key = f"host before {launch[0]} of {short(nxt_name)}"
            elif launch is not None:
                key = f"launched, device to start {short(nxt_name)}"
            else:
                key = f"unattributed, before {short(nxt_name)}"
            by[key] = by.get(key, 0.0) + (gap_b - gap_a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def record(torch, device, work) -> tuple[DeviceTrace, object]:
    """Run ``work()`` under the profiler; returns the trace and what
    ``work`` returned.  On the CPU (the tests' rehearsal) the trace holds
    no device event."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" \
        else [ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = work()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return DeviceTrace(events, window_s), out
