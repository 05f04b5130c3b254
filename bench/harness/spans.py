"""The program's host spans of a traced sub-window, put on the device
trace's clock.

The program records host spans (``repro_torch.obs.spans``) only while a
profiler session is on, so in a run of ``bench/run.py`` its recorder
holds the traced sub-window's spans alone.  :func:`recorded` reads them;
in a checkout whose program has no recorder it gives ``None``.

The spans are on ``time.perf_counter_ns``; the trace's events on the
profiler's clock.  :func:`fit_clock` finds the one offset between the
two: each span that makes a CUDA runtime call (``conv.launch`` makes
K1's ``cudaLaunchKernelExC``, ``decode.replay`` the ``cudaGraphLaunch``)
must hold that call.  A span and a call are paired by time at a common
offset, not by order (Kineto drops a few events), and the fitted offset
lies inside every matched pair's interval.  Then each gap between the
device's events can be laid against the spans (:func:`idle_share_in`,
:func:`idle_by_span`).
"""
from __future__ import annotations

from typing import NamedTuple

OUTSIDE = "outside the program"
CONV_CALL = ("conv.launch", "cudaLaunchKernelExC")
DECODE_CALL = ("decode.replay", "cudaGraphLaunch")
# the share of spans that must hold their call at the fitted offset
LEAST = 0.99
# how far past the difference between the counts of spans and calls a
# span is tried against calls of other ranks
REACH = 8


class Fit(NamedTuple):
    """Trace microseconds = host nanoseconds / 1000 + ``offset_us``;
    every matched call lies in its span at any offset within
    ``width_us`` around it; ``matched`` of ``spans`` spans hold theirs."""
    offset_us: float
    width_us: float
    matched: int
    spans: int


def recorded():
    """The program's spans (``repro_torch.obs.spans.snapshot()``), or
    ``None`` where the program has no span recorder."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    return spans.snapshot()


def fit_clock(snap, trace, span_name: str, call_name: str) -> Fit | None:
    """The offset from the spans' clock to the trace's at which each span
    called ``span_name`` holds one runtime call ``call_name``; ``None``
    if the recorder dropped spans, or if fewer than :data:`LEAST` of the
    spans hold their call at the best offset.

    Span ``i`` is tried against calls ``i - d`` to ``i + d`` (``d``: the
    difference between the counts, plus :data:`REACH`); each pair gives the
    interval of offsets at which the call lies inside the span, and the
    offset covered by the most intervals wins."""
    if snap is None or snap.dropped or not trace:
        return None
    hosts = sorted((s.start_ns / 1e3, s.end_ns / 1e3) for s in snap.spans
                   if s.name == span_name)
    calls = [(a, b) for name, a, b, _ in trace.runtime if name == call_name]
    n, m = len(hosts), len(calls)
    if not n or not m:
        return None
    d = abs(n - m) + REACH
    edges = []
    for i, (s, e) in enumerate(hosts):
        for a, b in calls[max(0, i - d):i + d + 1]:
            lo, hi = b - e, a - s
            if lo <= hi:
                edges.append((lo, 0, i))
                edges.append((hi, 1, i))
    edges.sort()
    best, count, best_at = 0, 0, None
    for at, closing, _ in edges:
        if closing:
            count -= 1
        else:
            count += 1
            if count > best:
                best, best_at = count, at
    if best_at is None:
        return None
    lo, hi, held = float("-inf"), float("inf"), set()
    for i, (s, e) in enumerate(hosts):
        for a, b in calls[max(0, i - d):i + d + 1]:
            if b - e <= best_at <= a - s and i not in held:
                held.add(i)
                lo, hi = max(lo, b - e), min(hi, a - s)
    if len(held) < LEAST * n:
        return None
    return Fit((lo + hi) / 2, hi - lo, len(held), n)


def on_trace(start_ns: int, end_ns: int, fit: Fit) -> tuple:
    """A host interval in trace microseconds."""
    return start_ns / 1e3 + fit.offset_us, end_ns / 1e3 + fit.offset_us


def _merged(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_gaps(trace) -> list:
    """The gaps ``(start_us, end_us)`` between the trace's device events:
    from its first to its last event, where none ran."""
    busy = _merged((a, b) for _, a, b, _ in trace.device)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def overlap_us(gaps: list, intervals: list) -> float:
    """Microseconds of ``gaps`` (sorted, disjoint) that ``intervals``
    cover."""
    total, j, cover = 0.0, 0, _merged(intervals)
    for a, b in gaps:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total


def idle_share_in(trace, intervals: list) -> float | None:
    """The share of the gaps between the device's events, in per cent,
    that ``intervals`` (trace microseconds) cover."""
    gaps = device_gaps(trace)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    return overlap_us(gaps, intervals) / idle * 100.0


def idle_by_span(trace, snap, fit: Fit) -> dict:
    """Seconds of the gaps between the device's events by the innermost
    span open during them (its self time), or :data:`OUTSIDE`."""
    kids = snap.children()
    pieces = []
    for i, s in enumerate(snap.spans):
        at = s.start_ns
        for c in sorted(kids[i], key=lambda c: snap.spans[c].start_ns):
            pieces.append((at, snap.spans[c].start_ns, s.name))
            at = snap.spans[c].end_ns
        pieces.append((at, s.end_ns, s.name))
    pieces = sorted((*on_trace(a, b, fit), name) for a, b, name in pieces
                    if b > a)
    gaps = device_gaps(trace)
    out = {OUTSIDE: sum(b - a for a, b in gaps)}
    by_name: dict = {}
    for a, b, name in pieces:
        by_name.setdefault(name, []).append((a, b))
    for name, intervals in by_name.items():
        took = overlap_us(gaps, intervals)
        out[name] = took * 1e-6
        out[OUTSIDE] -= took
    out[OUTSIDE] *= 1e-6
    return out


def roots(snap, name: str) -> list:
    """``(root span, {child name: [child spans]})`` of every root call
    called ``name``."""
    out, index = [], {}
    for i, s in enumerate(snap.spans):
        if s.parent < 0 and s.name == name:
            index[i] = len(out)
            out.append((s, {}))
        elif s.parent in index:
            out[index[s.parent]][1].setdefault(s.name, []).append(s)
    return out


def conv_calls(snap) -> list:
    """``(conv.run span, its conv.launch spans)`` of every conv call."""
    return [(r, kids.get("conv.launch", [])) for r, kids in
            roots(snap, "conv.run")]


def conv_split_us(snap) -> tuple | None:
    """Mean microseconds of a conv call outside its ``conv.launch`` (the
    per-plan-fixed work redone each call) and inside it."""
    calls = conv_calls(snap) if snap is not None else []
    if not calls:
        return None
    launch = [sum(c.end_ns - c.start_ns for c in ls) for _, ls in calls]
    whole = [r.end_ns - r.start_ns for r, _ in calls]
    n = len(calls)
    return ((sum(whole) - sum(launch)) / n / 1e3, sum(launch) / n / 1e3)


def conv_prep_intervals(snap, fit: Fit) -> list:
    """Each conv call's interval less its ``conv.launch``, on the trace's
    clock."""
    out = []
    for r, launches in conv_calls(snap):
        at = r.start_ns
        for c in sorted(launches, key=lambda c: c.start_ns):
            out.append(on_trace(at, c.start_ns, fit))
            at = c.end_ns
        out.append(on_trace(at, r.end_ns, fit))
    return out

