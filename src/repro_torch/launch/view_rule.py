"""PyTorch 2.11's DTensor rule for views, enforced on later versions.

The card machine's PyTorch (2.11) refuses, in DTensor's sharding
propagation, a strict view (``aten.view``, ``aten._unsafe_view``: what
``reshape``, ``flatten``, ``matmul``, ``bmm`` and ``einsum`` lower to)
that merges several dims of a DTensor when one of the merged dims other
than the first is split ("Attempted to flatten multiple dimensions, with
dimension 1 being sharded"), and fails in ``aten.constant_pad_nd`` on a
DTensor ("list index out of range").  Later versions accept both (a
``_StridedShard``, a pad strategy), so a mesh path that passes here may
still fail on the card machine.  :class:`StrictViews` raises where 2.11
would, so the CPU tests hold the mesh path to 2.11's rule:

    with StrictViews():
        steps.dist_train_step(api, axes)(params, opt_state, batch)

The dims a view merges are DTensor's own reading of the shapes
(``_view_ops.view_groups``), the reading 2.11 applies.  Any pad of a
DTensor raises, split dim or not: the port pads the local shards.  So
does an ``index_put`` among split DTensors (the backward of an indexing
such as the embedding's ``table[tokens]``), where 2.11 fails with "Shard
dim -1 ... must be normalized": the port indexes the local shards.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._ops._view_ops import (Flatten, InputDim,
                                                      view_groups)
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
_STRICT = (aten.view.default, aten._unsafe_view.default)
_INDEX_PUT = (aten.index_put.default, aten.index_put_.default,
              aten._index_put_impl_.default)


def _flattens(rule):
    """The ``Flatten`` entries of a view's dim map, nested ones too."""
    for entry in rule:
        if isinstance(entry, Flatten):
            yield entry
        for sub in getattr(entry, "input_dims", ()) or ():
            yield from _flattens((sub,))
        inner = getattr(entry, "input_dim", None)
        if inner is not None and not isinstance(entry, InputDim):
            yield from _flattens((inner,))


def check_view(x: DTensor, shape) -> None:
    """Raise where 2.11 refuses ``x.view(shape)``: a merged dim other
    than the first of its group is split."""
    if x.dim() == 0 or len(shape) == 0:
        return                               # a scalar merges nothing
    split = {pl.dim for pl in x.placements if pl.is_shard()}
    for flat in _flattens(view_groups(tuple(x.shape), tuple(shape))):
        for dim in flat.input_dims[1:]:
            if isinstance(dim, InputDim) and dim.input_dim in split:
                node = torch._C._current_autograd_node()
                raise RuntimeError(
                    "Attempted to flatten multiple dimensions, with "
                    f"dimension {dim.input_dim} being sharded "
                    f"({tuple(x.shape)} {tuple(x.placements)} -> "
                    f"{tuple(shape)}): PyTorch 2.11's DTensor refuses it"
                    + (f" (in the backward of {node.name()})" if node
                       else ""))


class StrictViews(TorchDispatchMode):
    """Inside the block, a strict view that merges a split dim other than
    the first of its group, a pad of a DTensor, or an ``index_put`` among
    split DTensors raises as on PyTorch 2.11; every other operation runs
    as it would."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if args and isinstance(args[0], DTensor):
            if func in _STRICT:
                check_view(args[0], args[1])
            elif func is aten.constant_pad_nd.default:
                raise RuntimeError(
                    f"constant_pad_nd of a DTensor {tuple(args[0].shape)} "
                    f"{tuple(args[0].placements)}: PyTorch 2.11's DTensor "
                    "fails there (list index out of range)")
            elif func in _INDEX_PUT and any(
                    isinstance(a, DTensor) and any(
                        pl.is_shard() for pl in a.placements)
                    for a in torch.utils._pytree.tree_leaves(args)):
                raise RuntimeError(
                    f"{func} of split DTensors (an indexing's backward): "
                    "PyTorch 2.11's DTensor fails there (Shard dim -1 "
                    "must be normalized)")
        if any(isinstance(a, DTensor) for a in
               torch.utils._pytree.tree_leaves((args, kwargs))):
            return NotImplemented           # DTensor runs it
        return func(*args, **kwargs)
