"""Mixture-of-Experts with sort-based (dropped-token) dispatch.

The JAX package cuts the tokens into one block per (pod x data) shard and
routes each block on its own; un-meshed (and on a mesh whose batch axes
have one device) that is one block, the routing over all ``T = B * S``
tokens at once, and under a mesh :func:`moe_ffn` routes block by block
with expert parallelism.  Every step keeps the JAX
package's order of operations: an f32 router, softmax, top-k, weights
renormalised; a stable sort of the (token, choice) pairs by expert; each
expert's first ``C`` pairs kept (``C`` from the static token count, so no
host sync), the rest dropped; a gather into ``(E, C, d)`` slots; the
expert SwiGLU as batched products (XLA's einsum in the JAX package, no
Pallas kernel); a weighted gather back to token order; DeepSeek's shared
experts added.

Nothing here reads a value back to the host (no ``.item()``, no
``nonzero``, no boolean-mask indexing), so a decode step that routes
through it can be captured in a CUDA graph.  Where the JAX package
scatters with ``mode="drop"``, the port scatters into a buffer with one
spare slot at the end (the index every dropped pair points at) and slices
it off: ``scatter_`` raises on an index out of range.

A sigmoid-routed layer (:func:`dropless`, with :func:`sigmoid_param_defs`:
Nemotron-H's and DeepSeek-V3's router, called by ``models/nemotron_h.py``)
drops no pair, and runs un-meshed: each token's scores are the sigmoid of
its f32 router product, the top-k of the scores plus ``router_bias``
(``e_score_correction_bias``, which moves the choice and not the
weights) are chosen, their scores renormalised and scaled by
``routed_scale``; the experts are relu^2 and not gated
(``down(relu(up x)^2)``), the shared expert ``shared_expert_ff`` wide.
Its capacity is the caller's: in a decode step the step's token count, so
no expert can overflow and nothing is read back; in a prefill, which no
graph captures, the largest load, read back.  Each of its applications
records host spans under a profiler session (``obs/spans.py``):
``moe.layer`` over ``moe.route``, ``moe.experts``, ``moe.shared`` and
``moe.combine``, and keeps its choices on the device for a reader.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import ArchConfig, Axes, P, pd
from repro_torch.models.layers import batch_shards, full_f32_matmul, shard
from repro_torch.obs import spans


def moe_param_defs(cfg: ArchConfig, axes: Axes):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    defs = {
        "router": pd((d, e), P(None, axes.model), dtype=torch.float32),
        "w_gate": pd((e, d, f), P(axes.model, axes.data, None)),
        "w_up": pd((e, d, f), P(axes.model, axes.data, None)),
        "w_down": pd((e, f, d), P(axes.model, axes.data, None)),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.d_ff
        defs["shared"] = {
            "w_gate": pd((d, fs), P(axes.data, axes.model)),
            "w_up": pd((d, fs), P(axes.data, axes.model)),
            "w_down": pd((fs, d), P(axes.model, axes.data)),
        }
    return defs


def sigmoid_param_defs(cfg):
    """A sigmoid-routed layer's weights, un-meshed: the f32 router and its
    selection bias, the relu^2 experts' ``up`` and ``down``, the shared
    expert's (``cfg.shared_expert_ff`` wide; none where it is 0)."""
    e, d, f, fs = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.shared_expert_ff
    defs = {
        "router": pd((d, e), dtype=torch.float32),
        "router_bias": pd((e,), init="zeros", dtype=torch.float32),
        "w_up": pd((e, d, f)),
        "w_down": pd((e, f, d)),
    }
    if fs:
        defs["shared"] = {"w_up": pd((d, fs)), "w_down": pd((fs, d))}
    return defs


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert: ``tokens * top_k / n_experts`` times the capacity
    factor, rounded up to a multiple of 8, at least 8."""
    c = int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(x: torch.Tensor, router: torch.Tensor, top_k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of the tokens ``x (T, d)``: (weights (T, k) f32,
    renormalised to sum to 1, experts (T, k) int64).  The router product
    is full f32 on the card (TF32 off), as the JAX package's f32 ``@``."""
    with full_f32_matmul():
        logits = x.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, top_k, dim=-1)
    return top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def route_sigmoid(x: torch.Tensor, router: torch.Tensor,
                  bias: torch.Tensor, top_k: int, scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sigmoid routing of the tokens ``x (T, d)``: (weights (T, k) f32,
    experts (T, k) int64).  The experts are the top-k of the scores plus
    ``bias``; their weights are their scores without it, renormalised to
    sum to 1 and multiplied by ``scale``.  The router product is full f32
    on the card (TF32 off)."""
    with full_f32_matmul():
        scores = torch.sigmoid(x.float() @ router)
    top_e = torch.topk(scores + bias, top_k, dim=-1).indices
    top_w = scores.gather(-1, top_e)
    return top_w / (top_w.sum(-1, keepdim=True) + 1e-20) * scale, top_e


def dropped_pairs(x: torch.Tensor, router: torch.Tensor, cfg: ArchConfig
                  ) -> int:
    """How many (token, choice) pairs of ``x (B, S, d)`` the capacity drops
    in :func:`moe_ffn`: over each expert's load, its pairs past the first
    ``C``.  A diagnostic: it reads the count back to the host, so it is
    never called on the decode path."""
    b, s, d = x.shape
    _, top_e = route(x.reshape(b * s, d), router, cfg.top_k)
    load = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
    return int((load - _capacity(b * s, cfg)).clamp_min(0).sum())


def _n_blocks(axes: Axes | None, t: int) -> int:
    """Number of (pod x data) shards of the ambient mesh, if it divides
    the ``t`` tokens; else 1."""
    nb = batch_shards(axes)
    return nb if t % nb == 0 else 1


def _slots(top_e: torch.Tensor, e: int, c: int):
    """The (token, choice) pairs of ``top_e (T, k)`` laid into ``c`` slots
    per expert: a stable sort of the pairs by expert, each expert's first
    ``c`` pairs kept in order.  Returns (the sort, each sorted pair's slot
    ``expert * c + rank``, or ``e * c`` (the spare) where it is dropped,
    the token of every slot (``T`` in an empty one and the spare), the
    slot of every pair in token order)."""
    t, k = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(t * k)
    sort_idx = torch.argsort(flat_e, stable=True)        # jnp.argsort is stable
    sorted_e = flat_e[sort_idx]
    first = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos_in_e = torch.arange(t * k, device=dev) - first[sorted_e]
    keep = pos_in_e < c
    token_of = sort_idx // k
    dest = torch.where(keep, sorted_e * c + pos_in_e,
                       torch.full_like(sorted_e, e * c))

    # index maps; slot e * c is the spare every dropped pair lands in
    src_token = torch.full((e * c + 1,), t, dtype=torch.int64, device=dev)
    src_token.scatter_(0, dest, token_of)
    inv_sort = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(t * k, device=dev))
    return sort_idx, dest, src_token, dest[inv_sort]


def _experts_of_block(xf, router, w_gate, w_up, w_down, cfg: ArchConfig,
                      e_lo: int):
    """One block's routed experts.  xf (T, d) the block's tokens, routed
    over all ``n_experts`` (``router`` (d, E) whole); ``w_*`` the weights
    of experts ``e_lo .. e_lo + len(w_gate)`` only.  Returns (T, d): what
    those experts add to each token (every expert when they are all
    here)."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    n_loc = w_gate.shape[0]
    c = _capacity(t, cfg)
    dev = xf.device
    top_w, top_e = route(xf, router, k)
    sort_idx, dest, src_token, slot_of_pair = _slots(top_e, e, c)
    pair_of_slot = torch.full((e * c + 1,), t * k, dtype=torch.int64,
                              device=dev)
    pair_of_slot.scatter_(0, dest, sort_idx)
    # the slots of the experts here
    lo, n_slots = e_lo * c, n_loc * c
    src_token = src_token[lo:lo + n_slots]
    pair_of_slot = pair_of_slot[lo:lo + n_slots]

    # dispatch: gather the kept tokens into their slots, empty slots zero
    slot_used = (src_token < t).to(xf.dtype)[:, None]
    xb = (xf[src_token.clamp_max(t - 1)] * slot_used).reshape(n_loc, c, d)

    # the experts' SwiGLU, one batched product per weight
    g = torch.bmm(xb, w_gate)
    u = torch.bmm(xb, w_up)
    y = torch.bmm(F.silu(g.float()).to(xf.dtype) * u, w_down)
    y = y.reshape(n_slots, d)

    # combine: weight each slot by its pair's router weight, then gather
    # the k slots of every token back to token order
    w_flat = top_w.reshape(t * k)
    w_slot = w_flat[pair_of_slot.clamp_max(t * k - 1)] \
        * (pair_of_slot < t * k)
    y_w = y * w_slot[:, None].to(y.dtype)
    sop = slot_of_pair.reshape(t, k) - lo
    out = torch.zeros((t, d), dtype=xf.dtype, device=dev)
    for kk in range(k):
        idx = sop[:, kk]
        valid = ((idx >= 0) & (idx < n_slots))[:, None].to(y.dtype)
        out = out + y_w[idx.clamp(0, n_slots - 1)] * valid
    return out


def _most_loaded(top_e: torch.Tensor, e: int) -> int:
    """The largest number of pairs any expert took, read back to the
    host and rounded up to a multiple of 8: a capacity that drops none.
    Never on a decode step."""
    load = torch.bincount(top_e.reshape(-1), minlength=e)
    return -(-int(load.max()) // 8) * 8


def relu2_experts(xb: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """Every expert on its slots: ``xb (E, C, d)`` -> ``(E, C, d)``,
    ``down(relu(up x)^2)`` as two batched products."""
    return torch.bmm(F.relu(torch.bmm(xb, w_up)).square(), w_down)


def dropless(x: torch.Tensor, p, cfg, capacity: int | None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """A sigmoid-routed layer over ``x (B, S, d)``, every pair in a slot:
    ``capacity`` slots per expert (a decode step's token count), or with
    None the largest load read back.  Empty slots hold a copy of the last
    token and are never read back.  The k outputs of a token are weighted
    and summed in f32 with the shared expert's, then cast once.  Returns
    (the layer's output (B, S, d), each token's chosen experts (B, S, k)
    int64)."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    xf = x.reshape(t, d)
    at = t0 = spans.RECORDER.root() if spans.GATE._is_profiler_enabled \
        else 0
    try:
        top_w, top_e = route_sigmoid(xf, p["router"], p["router_bias"], k,
                                     cfg.routed_scale)
        c = capacity or _most_loaded(top_e, e)
        _, _, src_token, slot_of_pair = _slots(top_e, e, c)
        if at:
            spans.RECORDER.keep(top_e)
            at = spans.RECORDER.add(spans.MOE_ROUTE, at)
        xb = xf[src_token[:e * c].clamp_max(t - 1)].view(e, c, d)
        y = relu2_experts(xb, p["w_up"], p["w_down"]).view(e * c, d)
        if at:
            at = spans.RECORDER.add(spans.MOE_EXPERTS, at)
        out = None
        if "shared" in p:
            sp = p["shared"]
            out = (F.relu(xf @ sp["w_up"]).square() @ sp["w_down"]).float()
            if at:
                at = spans.RECORDER.add(spans.MOE_SHARED, at)
        # a pair past a too small capacity (none at the caller's) weighs 0
        w = top_w.reshape(t * k) * (slot_of_pair < e * c)
        routed = (y[slot_of_pair.clamp_max(e * c - 1)].float() * w[:, None]) \
            .view(t, k, d).sum(dim=1)
        out = (routed if out is None else routed + out).to(x.dtype)
        if at:
            spans.RECORDER.add(spans.MOE_COMBINE, at)
        return out.reshape(b, s, d), top_e.view(b, s, k)
    finally:
        if t0:
            spans.RECORDER.add(spans.MOE_LAYER, t0, t)


def moe_ffn(x: torch.Tensor, p, cfg: ArchConfig, axes: Axes | None = None
            ) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Top-k routing, gather dispatch into
    ``(E, C, d)`` slots, the experts' SwiGLU, weighted combine, shared
    experts.

    Under a mesh the routing is block-local by construction, as in the JAX
    package: the tokens are cut into one block per (pod x data) shard
    (when that divides them) and each device routes its own block with its
    own capacity (``local_map`` over the block dim: the argsort, capacity,
    gather and scatter never cross a shard).  The experts stay split over
    "model" (expert parallelism): a device dispatches to, computes and
    combines only its own experts' slots, and the shards' partial sums
    meet in one reduction over "model"."""
    b, s, d = x.shape
    t = b * s
    if not isinstance(x, DTensor):
        out = _experts_of_block(x.reshape(t, d), p["router"], p["w_gate"],
                                p["w_up"], p["w_down"], cfg, 0)
    else:
        mesh = x.device_mesh
        nb = _n_blocks(axes, t)
        blk = (axes.pod, axes.data) if axes.pod else axes.data
        xf = shard(x.reshape(nb, t // nb, d), P(blk if nb > 1 else None))
        block_pl = xf.placements
        model = mesh.mesh_dim_names.index(axes.model)
        w_pl = tuple(Shard(0) if i == model else Replicate()
                     for i in range(mesh.ndim))
        whole = (Replicate(),) * mesh.ndim
        out_pl = tuple(Partial() if i == model else pl
                       for i, pl in enumerate(block_pl))
        # a device's gradients: its block's tokens through its own
        # experts, so partial over "model" for the tokens and the router,
        # and over the block axes for the router and its experts' weights
        w_grad_pl = tuple(Shard(0) if i == model else Partial()
                          for i in range(mesh.ndim))
        partial = (Partial(),) * mesh.ndim

        def blocks(xf, router, w_gate, w_up, w_down):
            e_lo = mesh.get_local_rank(model) * w_gate.shape[0]
            return torch.stack([
                _experts_of_block(xb, router, w_gate, w_up, w_down, cfg,
                                  e_lo) for xb in xf])

        out = local_map(blocks, out_placements=(out_pl,),
                        in_placements=(block_pl, whole, w_pl, w_pl, w_pl),
                        in_grad_placements=(out_pl, partial, w_grad_pl,
                                            w_grad_pl, w_grad_pl),
                        device_mesh=mesh, redistribute_inputs=True)(
            xf, p["router"], p["w_gate"], p["w_up"], p["w_down"])
        out = out.reshape(t, d)
        x = xf.reshape(t, d)
    xf = x.reshape(t, d)
    if cfg.n_shared_experts:
        sp = p["shared"]
        gs = xf @ sp["w_gate"]
        us = xf @ sp["w_up"]
        out = out + (F.silu(gs.float()).to(x.dtype) * us) @ sp["w_down"]
    out = out.reshape(b, s, d)
    if axes is not None:
        nb = _n_blocks(axes, t)
        blk = (axes.pod, axes.data) if axes.pod else axes.data
        out = shard(out, P(blk, None, None) if b % nb == 0
                    else P(None, None, None))
    return out


def aux_load_balance_loss(logits: torch.Tensor, top_e: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss: ``n_experts`` times the
    sum over experts of the mean router probability and the share of
    tokens whose first choice is that expert.  No ``loss_fn`` adds it, as
    in the JAX package."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.reshape(-1, n_experts).mean(dim=0)
    onehot = F.one_hot(top_e[..., 0].long(), n_experts).float()
    ce = onehot.reshape(-1, n_experts).mean(dim=0)
    return n_experts * (me * ce).sum()
