"""Step functions: the train step, the prefill and the decode step as
callables of a model API, un-meshed and on a mesh.

The JAX package jits these with explicit in/out shardings
(``jit_train_step``, ``jit_prefill_step``, ``jit_decode_step``).  Their
counterparts here, :func:`dist_train_step`, :func:`dist_prefill_step` and
:func:`dist_decode_step`, run the same step functions eagerly on DTensors
over the ambient mesh (``launch.mesh.enter_mesh``): each lays parameters,
optimizer state, inputs and cache out by the specs (``ModelApi``'s
``param_specs``, ``zero1_specs``, ``input_specs``, ``cache_defs``) and
gives its outputs back in the reference's out_shardings.  On one card the
mesh is (1, 1).  The un-meshed decode step's counterpart of
``jit_decode_step`` on the card is :func:`graph_decode_step`, one CUDA
graph over ``decode_fn`` replayed every step; :func:`make_decode_step` is
the eager step, the CPU's.  :func:`abstract_train_args` and
:func:`abstract_serve_args` give the dry run's ``meta`` arguments.
"""
from __future__ import annotations

import time

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import trips
from repro_torch.models.common import (Axes, P, ShapeCell, leaves, map_defs,
                                       map_trees, param_specs, placements)
from repro_torch.models.layers import batch_shards, current_mesh, shard
from repro_torch.models.registry import ModelApi
from repro_torch.obs import counters, spans
from repro_torch.optim import adamw

# eager steps run on a side stream before the capture
WARMUP_STEPS = 2


def value_and_grad(api: ModelApi, params, batch, axes: Axes | None = None):
    """``api.loss_fn`` of ``batch`` and its gradients with respect to every
    parameter, in ``leaves(params)`` order and the parameters' dtypes (the
    counterpart of ``jax.value_and_grad``).  The parameters need gradients
    only inside the call."""
    flat = leaves(params)
    try:
        for p in flat:
            p.requires_grad_(True)
        loss = api.loss_fn(params, batch, axes)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss.detach(), grads


def _rows(x: torch.Tensor, j: int, m: int) -> torch.Tensor:
    """Rows j, j + m, j + 2m, ... of ``x``.  On a DTensor split by rows
    each device takes its own (its block starts on a multiple of ``m``
    when m divides the rows per device), so the split moves nothing and
    the microbatch keeps the batch's placements."""
    if not isinstance(x, DTensor):
        return x[j::m]
    shape = (x.shape[0] // m,) + tuple(x.shape[1:])
    return DTensor.from_local(x.to_local()[j::m], x.device_mesh,
                              x.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def make_train_step(api: ModelApi,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    num_microbatches: int = 8, *, axes: Axes | None = None):
    """Training step with microbatched gradient accumulation.

    ``train_step(params, opt_state, batch)`` splits the batch (a dict of
    tensors, rows first) by stride, row r to microbatch r % m, m halved
    from ``num_microbatches`` until it divides the batch and, under a
    mesh, the rows of a microbatch stay divisible by the devices the batch
    is split over (else the microbatch would not keep the batch's
    sharding); runs each microbatch's loss and gradients in turn (only one
    microbatch's activations are alive at a time; ``trips.loop``);
    sums the gradients in float32 buffers (``torch.autograd.grad`` per
    microbatch, never ``.backward()`` into the parameters' own ``.grad``,
    which would sum bfloat16 gradients in bfloat16), under a mesh pinned
    to the full ZeRO-1 sharding (``adamw.state_specs`` of
    ``zero1_specs``: the sums are reduce-scatters); and takes one
    ``adamw.update`` with the mean loss and the mean gradients.  The
    parameters and the optimizer state are updated in place.  Returns
    (loss, gnorm, params, opt_state), the loss and the pre-clip gradient
    norm 0-d float32 tensors."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    gspecs = adamw.state_specs(api.zero1_specs(axes), axes)["m"] \
        if axes else None

    def train_step(params, opt_state, batch):
        b = next(iter(batch.values())).shape[0]
        nshards = batch_shards(axes)
        m = num_microbatches
        while m > 1 and (b % m != 0 or (b // m) % nshards != 0):
            m //= 2
        grads = map_defs(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        if gspecs is not None:
            grads = map_trees(shard, grads, gspecs)
        acc_specs = leaves(gspecs) if gspecs is not None else \
            [None] * len(leaves(grads))
        lsum = None
        for j in trips.loop(range(m)):
            micro = {k: _rows(v, j, m) for k, v in batch.items()}
            loss, micro_grads = value_and_grad(api, params, micro, axes)
            for acc, g, spec in zip(leaves(grads), micro_grads, acc_specs,
                                    strict=True):
                acc.add_(shard(g.float(), spec))
            lsum = loss if lsum is None else lsum + loss
        for acc in leaves(grads):
            acc.div_(m)
        params, opt_state, gnorm = adamw.update(params, grads, opt_state,
                                                opt_cfg)
        return lsum / m, gnorm, params, opt_state

    return train_step


def make_prefill_step(api: ModelApi, max_len: int | None = None, *,
                      axes: Axes | None = None):
    def serve_prefill(params, batch):
        return api.prefill_fn(params, batch, axes, max_len=max_len)

    return serve_prefill


def make_decode_step(api: ModelApi, *, axes: Axes | None = None):
    def serve_step(params, cache, tokens, pos):
        return api.decode_fn(params, cache, tokens, pos, axes)

    return serve_step


# --------------------------------------------------------------------- #
# Steps on a mesh (the counterparts of the JAX package's jit_*)
# --------------------------------------------------------------------- #

def _mesh():
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("a dist_* step runs on the ambient mesh: enter one "
                         "with launch.mesh.enter_mesh(mesh)")
    return mesh


def distribute(tree, specs):
    """``tree`` laid out on the ambient mesh by ``specs`` (a tree of
    PartitionSpecs of the same structure): a DTensor redistributed where
    its placements differ, a plain tensor (whole, the same on every rank)
    cut into its shards."""
    mesh = _mesh()

    def one(x, spec):
        want = placements(spec, mesh)
        if isinstance(x, DTensor):
            return x if tuple(x.placements) == want else \
                x.redistribute(mesh, want)
        return distribute_tensor(x, mesh, want)

    return map_trees(one, tree, specs)


def cache_specs(api: ModelApi, cache, axes: Axes):
    """The specs of ``cache`` (a prefill's, or a decode cell's): those of
    ``api.cache_defs`` at its batch (specs do not depend on its rows)."""
    b = next(t for t in leaves(cache) if t.dim() > 1).shape[1]
    return param_specs(api.cache_defs(b, api.last_pos(cache) + 1, axes))


def batch_specs(batch: dict, axes: Axes) -> dict:
    """The input specs of a batch: rows over ("pod","data") when there is
    more than one, nothing else split (``ModelApi.input_specs``' rule)."""
    return {k: P(axes.batch if v.shape[0] > 1 else None,
                 *(None,) * (v.dim() - 1)) for k, v in batch.items()}


def dist_train_step(api: ModelApi, axes: Axes,
                    num_microbatches: int | None = None,
                    opt_cfg: adamw.AdamWConfig | None = None):
    """The train step on the ambient mesh (``jit_train_step``): params by
    ``param_specs``, optimizer state by ``state_specs(zero1_specs)``, the
    batch by its input specs; returns (loss, gnorm, params, opt_state),
    the loss and norm replicated, params and state in their specs.  MoE
    archs take 16 microbatches by default, the others 8, as there."""
    pspecs = api.param_specs(axes)
    ospecs = adamw.state_specs(api.zero1_specs(axes), axes)
    micro = num_microbatches or (16 if api.cfg.n_experts else 8)
    fn = make_train_step(api, opt_cfg, micro, axes=axes)

    def step(params, opt_state, batch):
        params = distribute(params, pspecs)
        opt_state = distribute(opt_state, ospecs)
        batch = distribute(batch, batch_specs(batch, axes))
        with implicit_replication():
            loss, gnorm, params, opt_state = fn(params, opt_state, batch)
        return (shard(loss, P()), shard(gnorm, P()),
                distribute(params, pspecs), distribute(opt_state, ospecs))

    return step


def dist_prefill_step(api: ModelApi, axes: Axes, max_len: int | None = None):
    """Prefill on the ambient mesh (``jit_prefill_step``): params by
    ``param_specs``, the inputs by their specs; returns (logits, cache),
    the logits batch-sharded and the cache pinned to the decode cell's
    cache specs."""
    pspecs = api.param_specs(axes)
    fn = make_prefill_step(api, max_len, axes=axes)

    def step(params, batch):
        params = distribute(params, pspecs)
        batch = distribute(batch, batch_specs(batch, axes))
        with implicit_replication():
            logits, cache = fn(params, batch)
        b = logits.shape[0]
        return (shard(logits, P(axes.batch if b > 1 else None, None)),
                distribute(cache, cache_specs(api, cache, axes)))

    return step


def dist_decode_step(api: ModelApi, axes: Axes):
    """The decode step on the ambient mesh (``jit_decode_step``): params
    in the decode layout (``param_specs(layout="decode")``), the cache by
    its specs (updated in place once laid out), tokens batch-sharded, ``pos``
    replicated; returns (logits, cache), the logits batch-sharded."""
    pspecs = api.param_specs(axes, layout="decode")
    fn = make_decode_step(api, axes=axes)

    def step(params, cache, tokens, pos):
        b = tokens.shape[0]
        params = distribute(params, pspecs)
        cache = distribute(cache, cache_specs(api, cache, axes))
        tokens = distribute(tokens, P(axes.batch if b > 1 else None, None))
        if not isinstance(pos, torch.Tensor):
            pos = torch.tensor(pos, dtype=torch.int32,
                               device=tokens.to_local().device)
        pos = distribute(pos.reshape(()), P())
        with implicit_replication():
            logits, cache = fn(params, cache, tokens, pos)
        return shard(logits, P(axes.batch if b > 1 else None, None)), cache

    return step


def abstract_train_args(api: ModelApi, cell: ShapeCell,
                        axes: Axes | None = None):
    """(params, optimizer state, inputs) of a train cell as ``meta``
    tensors: nothing is allocated."""
    params = api.abstract_params(axes)
    opt = adamw.abstract_state(params)
    inputs, _ = api.input_specs(cell, axes)
    return params, opt, inputs


def abstract_serve_args(api: ModelApi, cell: ShapeCell,
                        axes: Axes | None = None):
    """The arguments of a prefill cell (params, inputs) or a decode cell
    (params, cache, tokens, pos) as ``meta`` tensors."""
    params = api.abstract_params(axes)
    inputs, _ = api.input_specs(cell, axes)
    if cell.kind == "prefill":
        return params, inputs
    return params, inputs["cache"], inputs["tokens"], inputs["pos"]


def step_counters() -> dict:
    """A copy of the port's host counters, by name
    (``obs.counters.COUNTS``): among them the kernels' launches, the
    recurrent updates, Zamba2's block applications and Nemotron-H's
    expert-layer applications a decode step adds to."""
    return dict(counters.COUNTS)


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
    capture, synchronised), ``launches_per_replay`` (what one replay
    makes: every host counter's difference over the capture, by name
    (:func:`step_counters`): the kernels' launches, the recurrent updates
    and Zamba2's block applications), ``replays`` (replays so
    far).  The host counters do not see replays; launches of a run are
    ``launches_per_replay`` times ``replays``.  The host's side of a step
    is timed by host spans under a profiler session
    (:mod:`repro_torch.obs.spans`): ``decode.step``, with the replay's
    index, over ``decode.tokens`` (the token copy), ``decode.pos`` (the
    position's copy or fill) and ``decode.replay`` (``cudaGraphLaunch``).
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
        before = step_counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = api.decode_fn(params, cache, self.tokens,
                                           self.pos)
        self.launches_per_replay = {
            name: count - before.get(name, 0)
            for name, count in step_counters().items()}
        for t, s in zip(written, saved):
            t.copy_(s)
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.replays = 0

    def __call__(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        t = t0 = spans.RECORDER.root() if spans.GATE._is_profiler_enabled \
            else 0
        index = self.replays
        try:
            self.tokens.copy_(tokens)
            if t:
                t = spans.RECORDER.add(spans.DECODE_TOKENS, t)
            if isinstance(pos, torch.Tensor):
                self.pos.copy_(pos.reshape(()))
            else:
                self.pos.fill_(pos)
            if t:
                t = spans.RECORDER.add(spans.DECODE_POS, t)
            self.graph.replay()
            if t:
                spans.RECORDER.add(spans.DECODE_REPLAY, t)
            self.replays += 1
            return self.logits
        finally:
            if t0:
                spans.RECORDER.add(spans.DECODE_STEP, t0, index)


def graph_decode_step(api: ModelApi, params, cache, batch: int
                      ) -> GraphDecodeStep:
    """The counterpart of the JAX package's ``jit_decode_step``: the decode
    step captured once as a CUDA graph (:class:`GraphDecodeStep`).  Raises
    on CPU tensors, and where the capture fails; it never falls back to
    the eager step."""
    return GraphDecodeStep(api, params, cache, batch)
