"""Per-device statistics of a step, counted from the ATen operations it
runs: the numbers the JAX package's ``hlo_stats.analyze`` reads out of
XLA's optimized, partitioned HLO.

There is no HLO in PyTorch, so this module ports what ``analyze``
returns, not how it gets it.  :func:`count` runs ``fn(*args)`` under a
dispatch mode that sees every ATen operation on the tensors each device
holds: on DTensors the mode lets DTensor propagate the sharding (it
declines the DTensor-level call) and counts the local operations DTensor
then issues, on the local shards, and the collectives it issues to
redistribute them.  :class:`Stats` keeps ``analyze``'s fields:

  * ``flops``: matrix-product FLOPs on the local shards, by the
    ``2·prod(out)·prod(contract)`` rule (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``mv``, ``dot``; convolutions and fused attention by
    ``torch.utils.flop_counter``); elementwise FLOPs are not counted, as
    there;
  * ``bytes_accessed``: the operand and output bytes of every ATen
    operation on the local shards, views excepted.  PyTorch's eager mode
    fuses nothing, so every elementwise step of an expression is an
    operation of its own that reads and writes its tensors; XLA fuses such
    chains into one kernel and ``analyze`` counts a fusion's surface
    operands and results once.  The count here is therefore an upper
    bound on what the same step would move fused: how much higher depends
    on how long the elementwise chains are;
  * ``collective_bytes`` by kind, under the reference's five names
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``): the bytes of each collective's result on one
    device, classified by the collective DTensor issued (on a CPU mesh
    DTensor runs its all-to-all as an all-gather and a slice; it is filed
    as the all-to-all it is), with ``collective_total`` and
    ``collective_count``;
  * ``unknown_trip_loops``: a loop the count could not multiply out.
    The port's steps repeat a body only through ``trips.loop``, which
    carries its trip count, so this stays 0.

Where a step repeats a body (the microbatch loop of the train step, the
chunks of ``layers.flash_attention``), it iterates ``models.trips.loop``:
under :func:`count` the body runs once and its counts are multiplied by
the trips, as ``analyze`` multiplies a ``while`` body by its trip count;
outside a count it is the plain loop.  The backward pass of a body runs
after its loop has ended: an operation that runs in the backward of an
autograd node is multiplied by the trips of the loops, ended by then,
that the node was made in (``trips.backward_mult``; on the CPU, where the
autograd engine runs a node's backward in the calling thread).  The
gradient sums into a tensor that every trip reads (a query chunk of
``flash_attention``, each of its KV chunks) are counted for the trips
that ran: the backward's bytes are a lower bound there, its FLOPs exact.
So a step run under :func:`count` returns results of the right shapes
and placements whose values are not the step's: each loop ran one trip.

The reference's ``cost_analysis_dict`` and ``parse_computations`` read
XLA's compiled output; they have no input in PyTorch and are not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.models import trips

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the functional collectives DTensor issues, by the reference's names
_COLLECTIVE_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}

# operations that move no data
_FREE = {"empty", "empty_strided", "empty_like", "lift_fresh",
         "wait_tensor", "_local_scalar_dense", "detach", "alias",
         "set_", "resize_"}


@dataclasses.dataclass
class Stats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES})
    collective_count: float = 0.0
    unknown_trip_loops: int = 0

    def add(self, other: "Stats", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes_accessed += other.bytes_accessed * mult
        for c in _COLLECTIVES:
            self.collective_bytes[c] += other.collective_bytes[c] * mult
        self.collective_count += other.collective_count * mult
        self.unknown_trip_loops += other.unknown_trip_loops

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())


def _bytes(t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * t.element_size()


def _dims(t) -> tuple:
    return tuple(t.shape)


def _matmul_flops(name: str, args, out) -> float | None:
    """2·prod(out)·prod(contract) for the products, else None."""
    if name in ("mm", "bmm", "mv", "dot"):
        a = args[0]
    elif name in ("addmm", "baddbmm"):
        a = args[1]
    else:
        return None
    contract = _dims(a)[-1] if a.dim() else 1
    return 2.0 * math.prod(_dims(out)) * contract


# the frames :func:`count` and ``trips.loop`` add to; empty: not counting
_STACK = trips.FRAMES
# what ran, each repeated body once (the reference's raw cost analysis)
_RAN: list[Stats] = []


class _Counter(TorchDispatchMode):
    """Counts the local operations and the collectives into the top
    frame of ``_STACK``."""

    def __init__(self):
        super().__init__()
        self._in_alltoall = 0
        # DTensor infers an op's output under a fake mode of its own; the
        # operations on the shards run under the mode active at entry
        self._fake_mode_on_entry = active_fake_mode()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented           # DTensor issues the local ops
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_mode_on_entry:
            return out                      # DTensor's shape propagation
        tensors = [a for a in flat if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        name = func.overloadpacket.__name__
        once = Stats()
        self._add(once, name, func, args, kwargs, tensors, outs, out)
        _STACK[-1].add(once, trips.backward_mult())
        _RAN[-1].add(once)
        return out

    def _add(self, st: Stats, name, func, args, kwargs, tensors, outs, out):
        kind = _COLLECTIVE_OF.get(name)
        if kind is not None:
            if not self._in_alltoall:
                st.collective_bytes[kind] += sum(_bytes(o) for o in outs)
                st.collective_count += 1
                st.bytes_accessed += sum(map(_bytes, tensors + outs))
            return
        if name in _FREE or func.is_view:
            return
        st.bytes_accessed += sum(map(_bytes, tensors + outs))
        flops = _matmul_flops(name, args, out)
        if flops is None and func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        st.flops += flops or 0.0

    @contextlib.contextmanager
    def _alltoall_as_one(self):
        """On a CPU mesh DTensor runs a shard-dim all-to-all as an
        all-gather and a local slice (``placement_types.
        shard_dim_alltoall``): count that call as one all-to-all, of its
        result's bytes, and not its inner all-gather."""
        from torch.distributed.tensor import placement_types
        real = getattr(placement_types, "shard_dim_alltoall", None)
        if real is None:
            yield
            return

        def as_one(input, *rest, **kw):
            self._in_alltoall += 1
            try:
                out = real(input, *rest, **kw)
            finally:
                self._in_alltoall -= 1
            once = Stats()
            once.collective_bytes["all-to-all"] += _bytes(out)
            once.collective_count += 1
            once.bytes_accessed += _bytes(input) + _bytes(out)
            _STACK[-1].add(once, trips.backward_mult())
            _RAN[-1].add(once)
            return out

        placement_types.shard_dim_alltoall = as_one
        try:
            yield
        finally:
            placement_types.shard_dim_alltoall = real


def count(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run once, with what one device of its mesh
    did counted: returns (its result, :class:`Stats` with every
    ``trips.loop`` multiplied out, :class:`Stats` of what ran, each repeated
    body once).  The result has the right shapes, not the right values
    (each loop ran its first trip only).  Operations are counted where
    they run on the shards under the fake mode active at the call (none
    for real tensors)."""
    st, ran = Stats(), Stats()
    _STACK.append(st)
    _RAN.append(ran)
    ranges = len(trips.RANGES)
    counter = _Counter()
    try:
        with counter, counter._alltoall_as_one():
            out = fn(*args, **kwargs)
    finally:
        _STACK.pop()
        _RAN.pop()
        del trips.RANGES[ranges:]
    return out, st, ran
