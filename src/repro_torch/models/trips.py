"""Repeated bodies that a count multiplies out.

The loops of the models (``layers.flash_attention``'s chunks) and of the
steps (the microbatches of ``launch.steps.make_train_step``) iterate
:func:`loop`.  Outside a count it is the plain loop.  Under
``launch.hlo_stats.count`` the body runs for the first item only, and what
it counted is multiplied by the number of items, as the JAX package's
``hlo_stats`` multiplies a ``while`` body by its trip count.  The models
depend on this module and not on the launchers; ``launch.hlo_stats`` owns
the counting and pushes its frames here.
"""
from __future__ import annotations

import math

import torch

# The open count's frames, innermost last: objects with ``add(other,
# mult)`` and ``unknown_trip_loops`` whose type makes an empty one.
# Empty: nothing is counting.
FRAMES: list = []
# The loops run under the open count: [first autograd sequence number of
# the body, first one after it (None while the loop runs), trips].
RANGES: list[list] = []


def _sequence_mark() -> int:
    """The autograd sequence number a node made now gets: every node made
    after this call has a larger one (nodes number in the order they are
    made, per thread)."""
    with torch.enable_grad():
        return torch.empty(0, requires_grad=True).view(0).grad_fn \
            ._sequence_nr()


def backward_mult() -> int:
    """1, or in the backward of an autograd node, the trips of the loops
    that made the node and have ended: that node's backward stands for
    theirs in every trip that did not run."""
    current = getattr(torch._C, "_current_autograd_node", None)
    node = current() if current is not None else None
    if node is None:
        return 1
    seq = node._sequence_nr()
    return math.prod(n for lo, hi, n in RANGES
                     if hi is not None and lo < seq < hi)


def loop(iterable):
    """The items of ``iterable``, to be iterated by a repeated body.
    Under a count only the first item is given, and what the body counted
    is added to the enclosing frame times the number of items when the
    loop ends; the backward of the autograd nodes it made is multiplied
    when it runs (:func:`backward_mult`).  A loop that starts in the
    backward of a node that is itself multiplied (a recomputation there)
    cannot be multiplied out: it is counted in ``unknown_trip_loops``."""
    items = list(iterable)
    if not FRAMES or not items:
        yield from items
        return
    frame = type(FRAMES[-1])()
    if backward_mult() > 1:
        frame.unknown_trip_loops += 1
    span = [_sequence_mark(), None, len(items)]
    RANGES.append(span)
    FRAMES.append(frame)
    try:
        yield items[0]
    finally:
        FRAMES.pop()
        span[1] = _sequence_mark()
        FRAMES[-1].add(frame, len(items))
