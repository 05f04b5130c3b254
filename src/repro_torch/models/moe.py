"""Mixture-of-Experts with sort-based (dropped-token) dispatch, on one card.

The JAX package cuts the tokens into one block per (pod x data) shard and
routes each block on its own; one card is one block, so the routing here
is over all ``T = B * S`` tokens at once.  Every step keeps the JAX
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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, pd
from repro_torch.models.layers import full_f32_matmul


def moe_param_defs(cfg: ArchConfig):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    defs = {
        "router": pd((d, e), dtype=torch.float32),
        "w_gate": pd((e, d, f)),
        "w_up": pd((e, d, f)),
        "w_down": pd((e, f, d)),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.d_ff
        defs["shared"] = {
            "w_gate": pd((d, fs)),
            "w_up": pd((d, fs)),
            "w_down": pd((fs, d)),
        }
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


def moe_ffn(x: torch.Tensor, p, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Top-k routing, gather dispatch into
    ``(E, C, d)`` slots, the experts' SwiGLU, weighted combine, shared
    experts."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(t, cfg)
    dev = x.device
    xf = x.reshape(t, d)
    top_w, top_e = route(xf, p["router"], k)

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
    src_token = src_token[:e * c]
    inv_sort = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(t * k, device=dev))
    slot_of_pair = dest[inv_sort]                         # (T*k,) token-major
    pair_of_slot = torch.full((e * c + 1,), t * k, dtype=torch.int64,
                              device=dev)
    pair_of_slot.scatter_(0, dest, sort_idx)
    pair_of_slot = pair_of_slot[:e * c]

    # dispatch: gather the kept tokens into their slots, empty slots zero
    slot_used = (src_token < t).to(x.dtype)[:, None]
    xb = (xf[src_token.clamp_max(t - 1)] * slot_used).reshape(e, c, d)

    # the experts' SwiGLU, one batched product per weight
    g = torch.bmm(xb, p["w_gate"])
    u = torch.bmm(xb, p["w_up"])
    y = torch.bmm(F.silu(g.float()).to(x.dtype) * u, p["w_down"])
    y = y.reshape(e * c, d)

    # combine: weight each slot by its pair's router weight, then gather
    # the k slots of every token back to token order
    w_flat = top_w.reshape(t * k)
    w_slot = w_flat[pair_of_slot.clamp_max(t * k - 1)] \
        * (pair_of_slot < t * k)
    y_w = y * w_slot[:, None].to(y.dtype)
    sop = slot_of_pair.reshape(t, k)
    out = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for kk in range(k):
        idx = sop[:, kk]
        valid = (idx < e * c)[:, None].to(y.dtype)
        out = out + y_w[idx.clamp_max(e * c - 1)] * valid

    if cfg.n_shared_experts:
        sp = p["shared"]
        gs = xf @ sp["w_gate"]
        us = xf @ sp["w_up"]
        out = out + (F.silu(gs.float()).to(x.dtype) * us) @ sp["w_down"]
    return out.reshape(b, s, d)


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
