"""Serving step functions: the prefill and the decode step as callables
of a model API (the JAX package jits and shards these; on one card they
are the model functions themselves)."""
from __future__ import annotations

from repro_torch.models.registry import ModelApi


def make_prefill_step(api: ModelApi, max_len: int | None = None):
    def serve_prefill(params, batch):
        return api.prefill_fn(params, batch, max_len=max_len)

    return serve_prefill


def make_decode_step(api: ModelApi):
    def serve_step(params, cache, tokens, pos: int):
        return api.decode_fn(params, cache, tokens, pos)

    return serve_step
