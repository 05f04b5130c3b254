"""Gradient compression for a reduction over slow links: per-tensor int8
quantisation with error feedback, and random-k sparsification.  Each is a
transform over a tree of tensors, so it composes with any optimizer:

    comp = ErrorFeedbackInt8()
    cstate = comp.init(grads_like)
    q, cstate = comp.compress(grads, cstate)     # before the reduction
    grads_hat = comp.decompress(q)               # after

The int8 path rounds half to even (``torch.round``, as ``jnp.round``), so
it gives the JAX package's values bit for bit.  ``RandomK`` draws its masks
from a ``torch.Generator`` seeded by ``init``: the same properties as the
JAX package's ``jax.random`` masks, not the same masks.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.common import leaves, map_defs, map_trees


def _zeros_f32(tree):
    return map_defs(lambda g: torch.zeros_like(g, dtype=torch.float32), tree)


def _part(tree, i: int):
    """The ``i``-th entry of every tuple leaf of ``tree``."""
    return map_defs(lambda t: t[i], tree)


@dataclasses.dataclass(frozen=True)
class Quantized:
    values: Any          # int8 tree
    scales: Any          # float32 per-tensor scales


class ErrorFeedbackInt8:
    """Per-tensor symmetric int8 quantisation with residual carry."""

    def init(self, grads_like):
        return _zeros_f32(grads_like)

    def compress(self, grads, residual) -> tuple[Quantized, Any]:
        def one(g, r):
            x = g.float() + r
            scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(x / scale), -127, 127) \
                .to(torch.int8)
            return q, scale, x - q.float() * scale

        out = map_trees(one, grads, residual)
        return (Quantized(values=_part(out, 0), scales=_part(out, 1)),
                _part(out, 2))

    def decompress(self, q: Quantized):
        return map_trees(lambda v, s: v.float() * s, q.values, q.scales)

    @staticmethod
    def bytes_ratio(dtype=torch.float32) -> float:
        return dtype.itemsize / 1.0      # int8 = 1 byte


class RandomK:
    """Memory-SGD style sparsifier (Stich et al.): transmit a random
    k-fraction of entries *unscaled* and carry the untransmitted mass in
    the residual — biased per step, mass-conserving over time."""

    def __init__(self, fraction: float = 0.1):
        self.fraction = fraction

    def init(self, grads_like, seed: int = 0):
        dev = leaves(grads_like)[0].device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return {"residual": _zeros_f32(grads_like), "generator": gen}

    def compress(self, grads, state):
        gen = state["generator"]

        def one(g, r):
            x = g.float() + r
            mask = torch.rand(g.shape, generator=gen,
                              device=g.device) < self.fraction
            return torch.where(mask, x, 0.0), torch.where(mask, 0.0, x)

        out = map_trees(one, grads, state["residual"])
        return _part(out, 0), {"residual": _part(out, 1), "generator": gen}

    @staticmethod
    def decompress(q):
        return q
