"""Step functions: the train step, the prefill and the decode step as
callables of a model API.

The JAX package jits and shards these (``jit_train_step``,
``jit_prefill_step``, ``jit_decode_step``).  On one card the train step and
the prefill stay eager: the train step's time goes to large products, and
the prefill's shapes change with the prompt.  The decode step's
counterpart of ``jit_decode_step`` is :func:`graph_decode_step`, one CUDA
graph over ``decode_fn`` replayed every step; :func:`make_decode_step` is
the eager step, the CPU's.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels import flash_decode
from repro_torch.models.common import leaves, map_defs
from repro_torch.models.registry import ModelApi
from repro_torch.optim import adamw

# eager steps run on a side stream before the capture
WARMUP_STEPS = 2


def value_and_grad(api: ModelApi, params, batch):
    """``api.loss_fn`` of ``batch`` and its gradients with respect to every
    parameter, in ``leaves(params)`` order and the parameters' dtypes (the
    counterpart of ``jax.value_and_grad``).  The parameters need gradients
    only inside the call."""
    flat = leaves(params)
    try:
        for p in flat:
            p.requires_grad_(True)
        loss = api.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss.detach(), grads


def make_train_step(api: ModelApi,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    num_microbatches: int = 8):
    """Training step with microbatched gradient accumulation, on one
    device (the JAX package's, without its sharding pins).

    ``train_step(params, opt_state, batch)`` splits the batch (a dict of
    tensors, rows first) by stride, row r to microbatch r % m, m halved
    from ``num_microbatches`` until it divides the batch; runs each
    microbatch's loss and gradients in turn (only one microbatch's
    activations are alive at a time); sums the gradients in float32
    buffers (``torch.autograd.grad`` per microbatch, never ``.backward()``
    into the parameters' own ``.grad``, which would sum bfloat16
    gradients in bfloat16); and takes one ``adamw.update`` with the mean
    loss and the mean gradients.  The parameters and the optimizer state
    are updated in place.  Returns (loss, gnorm, params, opt_state), the
    loss and the pre-clip gradient norm 0-d float32 tensors."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, batch):
        b = next(iter(batch.values())).shape[0]
        m = num_microbatches
        while m > 1 and b % m != 0:
            m //= 2
        grads = map_defs(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=leaves(params)[0].device)
        for j in range(m):
            micro = {k: v[j::m] for k, v in batch.items()}
            loss, micro_grads = value_and_grad(api, params, micro)
            for acc, g in zip(leaves(grads), micro_grads, strict=True):
                acc.add_(g.float())
            lsum += loss
        for acc in leaves(grads):
            acc.div_(m)
        params, opt_state, gnorm = adamw.update(params, grads, opt_state,
                                                opt_cfg)
        return lsum / m, gnorm, params, opt_state

    return train_step


def make_prefill_step(api: ModelApi, max_len: int | None = None):
    def serve_prefill(params, batch):
        return api.prefill_fn(params, batch, max_len=max_len)

    return serve_prefill


def make_decode_step(api: ModelApi):
    def serve_step(params, cache, tokens, pos):
        return api.decode_fn(params, cache, tokens, pos)

    return serve_step


class GraphDecodeStep:
    """One decode step of ``api`` captured as a CUDA graph over ``params``
    and ``cache`` (the cache that prefill returned, a tree of tensors; its
    tensors are the graph's from now on, updated in place by every
    replay).

    ``step(tokens, pos)`` copies ``tokens`` (B, 1) and ``pos`` (an int or
    a 0-d integer tensor) into the graph's static buffers, replays, and
    returns the static logits (B, V) float32: consume them before the next
    replay, which overwrites them.

    The warm-up steps and the capture run the step for real, at the last
    position the model's step may take (``api.last_pos``: the KV cache's
    last row, Whisper's ``dec_seq - 1``), so what that step writes
    (``api.step_writes``: a recurrent state whole, a KV cache's row) is
    saved before and put back after.

    Attributes: ``capture_ms`` (host milliseconds of the warm-up and the
    capture, synchronised), ``launches_per_replay`` (the decode kernels'
    launches one replay makes: what ``flash_decode.LAUNCHES`` counted
    during the capture, by name), ``replays`` (replays so far).  The
    wrappers' host counters do not see replays; launches of a run are
    ``launches_per_replay`` times ``replays``.
    """

    def __init__(self, api: ModelApi, params, cache, batch: int):
        dev = params["embed"].device
        tensors = leaves(cache)
        if dev.type != "cuda" or any(c.device != dev for c in tensors):
            raise ValueError(
                f"graph_decode_step captures a CUDA graph and needs the "
                f"parameters and the cache on one CUDA device, got "
                f"{dev} and {sorted({str(c.device) for c in tensors})}"
                f"; on the CPU use make_decode_step")
        last = api.last_pos(cache)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.pos = torch.full((), last, dtype=torch.int32, device=dev)
        written = api.step_writes(cache, last)
        saved = [t.clone() for t in written]
        t0 = time.perf_counter()
        # warm up on a side stream: cuBLAS workspaces, the kernels' build
        # and first launch, the allocator's blocks
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                api.decode_fn(params, cache, self.tokens, self.pos)
        main.wait_stream(side)
        before = dict(flash_decode.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = api.decode_fn(params, cache, self.tokens,
                                           self.pos)
        self.launches_per_replay = {
            name: flash_decode.LAUNCHES[name] - before[name]
            for name in flash_decode.LAUNCHES}
        for t, s in zip(written, saved):
            t.copy_(s)
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.replays = 0

    def __call__(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        self.tokens.copy_(tokens)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos.reshape(()))
        else:
            self.pos.fill_(pos)
        self.graph.replay()
        self.replays += 1
        return self.logits


def graph_decode_step(api: ModelApi, params, cache, batch: int
                      ) -> GraphDecodeStep:
    """The counterpart of the JAX package's ``jit_decode_step``: the decode
    step captured once as a CUDA graph (:class:`GraphDecodeStep`).  Raises
    on CPU tensors, and where the capture fails; it never falls back to
    the eager step."""
    return GraphDecodeStep(api, params, cache, batch)
