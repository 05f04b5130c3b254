"""Host spans on the hot path, on the host's clock, recorded only while a
``torch.profiler`` session is on.

The two host paths that set the pace of the port's served loops open a
*root* span per call and record child spans at the boundaries inside
it: ``EmittedConv.run`` (``conv.run``, with the layer index, and beneath
it ``conv.check``, ``conv.geometry``, ``conv.lambda``, ``conv.alloc``,
``conv.launch``) and
``GraphDecodeStep.__call__`` (``decode.step``, with the replay's index,
and beneath it ``decode.tokens``, ``decode.pos``, ``decode.replay``).
A sigmoid-routed expert layer run outside a graph
(``models/moe.py::dropless``) opens ``moe.layer``, with its token
count, over ``moe.route``, ``moe.experts``, ``moe.shared`` and
``moe.combine``, and keeps its choices, a device tensor, in
:attr:`SpanRecorder.kept` (:meth:`SpanRecorder.keep`: no copy and no
read, at most ``capacity`` of them) for a reader to count the experts a
step chose.  A graph replay passes through none of them.

The gate is the profiler's own flag (``torch.autograd.profiler.
_is_profiler_enabled``), which a root call reads once, inline, as
``GATE._is_profiler_enabled``.  With no profiler session a root call
costs that read and the branches on the 0 it passes down; no call site
reaches the recorder.  So an operator who profiles gets the spans beside
the device trace, and a timed window with the profiler off records none.
There is no knob; a test forces the gate by putting an object with that
attribute in place of :data:`GATE`.

A root call opens with :meth:`SpanRecorder.root` (its start, or 0 when
no room is left) and hands the end of its last span down to the
functions it calls, which chain their children from it::

    t = t0 = RECORDER.root() if GATE._is_profiler_enabled else 0
    ...                                 # the work the first child bounds
    if t:
        t = RECORDER.add(CONV_CHECK, t)
    ...                                 # the next child's, from its end
    if t:
        RECORDER.add(CONV_GEOMETRY, t)
    ...
    if t0:
        RECORDER.add(CONV_RUN, t0, layer)   # the root, in a ``finally``

A span is stored when it closes: its name id, start and end
(``time.perf_counter_ns``), the sequence number of its root call and a
root's argument, five ints appended to one list (no object the garbage
collector tracks is kept, so recording starts no collection).  The list
holds at most ``capacity`` spans: a root call starts only while room for
``CALL_SPANS`` more is left, and one that finds none is not recorded and
counted in ``dropped``.  :meth:`SpanRecorder.snapshot` rebuilds the tree
(each span's parent is the innermost span of its call that holds it)
and :meth:`SpanRecorder.clear` empties the list.  Nothing is written
anywhere.

Roots do not nest, a root call records at most ``CALL_SPANS`` spans,
and one thread records: the instrumented paths are the serving loops',
each driven from one thread.  A child whose work raised is not stored;
its root is.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch.autograd.profiler as _autograd_profiler

NAMES = ("conv.run", "conv.check", "conv.geometry", "conv.lambda",
         "conv.alloc", "conv.launch", "decode.step", "decode.tokens",
         "decode.pos", "decode.replay", "moe.layer", "moe.route",
         "moe.experts", "moe.shared", "moe.combine")
(CONV_RUN, CONV_CHECK, CONV_GEOMETRY, CONV_LAMBDA, CONV_ALLOC, CONV_LAUNCH,
 DECODE_STEP, DECODE_TOKENS, DECODE_POS, DECODE_REPLAY, MOE_LAYER, MOE_ROUTE,
 MOE_EXPERTS, MOE_SHARED, MOE_COMBINE) = range(len(NAMES))

CAPACITY = 1 << 16
CALL_SPANS = 64

now = time.perf_counter_ns

# a root call records while GATE._is_profiler_enabled
GATE = _autograd_profiler


class HostSpan(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int     # index into the snapshot's spans; -1 for a root
    root: int       # sequence number of the root call
    arg: int        # a root's argument (layer index, replay); 0 below


@dataclasses.dataclass(frozen=True)
class SpanSnapshot:
    """The recorded spans by start, a parent before its children, and how
    many were dropped for want of room."""
    spans: tuple
    dropped: int

    def children(self) -> list:
        """For each span, the indices of its children."""
        out = [[] for _ in self.spans]
        for i, s in enumerate(self.spans):
            if s.parent >= 0:
                out[s.parent].append(i)
        return out

    def self_ns(self) -> list:
        """Each span's duration less its children's durations."""
        own = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                own[s.parent] -= s.end_ns - s.start_ns
        return own


class SpanRecorder:
    """Closed spans, five ints each, in one list of bounded length.

    ``root()`` opens a root call: its start, or 0 (counted in
    ``dropped``) when no room is left.  ``add(name, t0, arg)`` stores a
    span of the open root call, the root itself included, from ``t0`` to
    now.  ``keep(t)`` keeps a tensor of the open root call in ``kept``."""

    __slots__ = ("capacity", "dropped", "kept", "_seq", "_log", "_room")

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._room = 5 * (capacity - CALL_SPANS)
        self._seq = 0
        self.clear()

    def clear(self) -> None:
        self._log, self.dropped, self.kept = [], 0, []

    def root(self) -> int:
        if len(self._log) > self._room:
            self.dropped += 1
            return 0
        self._seq += 1
        return now()

    def add(self, name: int, t0: int, arg: int = 0) -> int:
        """Store a span of the open root call from ``t0`` to now; returns
        its end, the start of a span that follows it at once."""
        t1 = now()
        self._log += (name, t0, t1, self._seq, arg)
        return t1

    def keep(self, t) -> None:
        """Keep ``t`` (a reference: nothing is copied or read) while fewer
        than ``capacity`` are kept."""
        if len(self.kept) < self.capacity:
            self.kept.append(t)

    def snapshot(self) -> SpanSnapshot:
        log, by_root = self._log, {}
        for k in range(0, len(log), 5):
            name, t0, t1, seq, arg = log[k:k + 5]
            by_root.setdefault(seq, []).append((t0, -t1, name, arg))
        spans = []
        for seq, recs in by_root.items():
            recs.sort()
            stack = []
            for t0, t1, name, arg in recs:
                while stack and spans[stack[-1]].end_ns <= t0:
                    stack.pop()
                spans.append(HostSpan(NAMES[name], t0, -t1,
                                      stack[-1] if stack else -1, seq, arg))
                stack.append(len(spans) - 1)
        return SpanSnapshot(tuple(spans), self.dropped)


RECORDER = SpanRecorder()


def snapshot() -> SpanSnapshot:
    """The process's recorder's spans (:data:`RECORDER`)."""
    return RECORDER.snapshot()


def clear() -> None:
    """Empty the process's recorder."""
    RECORDER.clear()
