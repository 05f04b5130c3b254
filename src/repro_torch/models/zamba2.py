"""Zamba2 as published (arXiv:2411.15242; the layer equations of Hugging
Face's ``Zamba2ForCausalLM``), un-meshed: the serving path of
``zamba2-7b``.

Every one of the ``n_layers`` layers is a Mamba-2 layer whose B and C
come in ``ssm_groups`` groups (``models/ssm.py``).  On the layers of
``hybrid_layer_ids`` one of ``num_mem_blocks`` shared blocks runs first,
the blocks in turn (application ``j`` uses block ``j % num_mem_blocks``):

    a   = attention(RMSNorm_2d(concat(x, x0)))       # 2d wide, D = 2d / H
    t   = MLP_j(RMSNorm_d(a o_proj))                 # no residual inside
    x  <- x + Mamba2(RMSNorm_d(x + t linear_j))      # into the mixer's input

``x0`` is the token's embedding.  The attention's heads are
``head_dim = 2 d / n_heads`` wide, rotated (``rope_theta``, the
rotate-half form) and scaled by ``(head_dim / 2) ** -0.5``.  The MLP is
``down(gelu(gate) * up)``, its ``gate_up`` product plus the application's
rank-``adapter_rank`` adapter; ``linear_j`` is the application's own
``d x d`` map.  The embedding is tied: the logits are ``x @ embed.T``.
Every RMSNorm takes ``norm_eps``, the mixers' gated norms
``ssm_norm_eps``.  ``models/hybrid.py`` is the JAX package's Zamba2-style
simplification, kept as it is.

The cache is ``{"mamba": {h, conv} stacked over the layers, "attn": {k, v}
stacked over the applications}``: each application has its own rows.  The
decode step writes every layer's state and row ``pos`` of every
application's K and V in place, and attends through
``transformer.decode_attend`` (the hand-written decode kernel on the card)
once an application; it reads nothing back to the host.
``zamba2_block<k>`` in ``obs.counters`` counts the decode step's
applications of block ``k``, on the host, as ``ssm_update`` counts the
recurrent updates: a CUDA graph's capture counts one step's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import mamba_lm, ssm
from repro_torch.models.common import Axes, P, Zamba2Config, pd
from repro_torch.models.layers import (apply_rope, embed, flash_attention,
                                       merge_last, repeat_kv, rmsnorm,
                                       split_last, write_row)
from repro_torch.models.transformer import (_layer, _logits, _stack_defs,
                                            cache_rows, chunked_loss,
                                            decode_attend, pad_rows,
                                            recompute, stack_layers)
from repro_torch.obs import counters

# the published layout has no mesh rules in this port (``ModelApi.meshed``)
MESHED = False


def _unmeshed(cfg: Zamba2Config, axes: Axes | None) -> None:
    if axes is not None:
        raise ValueError(f"{cfg.name} runs un-meshed (the published "
                         f"layout has no mesh rules in this port)")


def n_apps(cfg: Zamba2Config) -> int:
    """How many times the shared blocks run: one per hybrid layer."""
    return len(cfg.hybrid_layer_ids)


def attn_scale(cfg: Zamba2Config) -> float:
    """The scores' factor, ``(head_dim / 2) ** -0.5``: the head reads the
    2d-wide concatenation of two d-wide streams."""
    return (cfg.head_dim / 2) ** -0.5


def param_defs(cfg: Zamba2Config, axes: Axes | None = None):
    """Every weight, un-meshed (``axes`` is not used: no spec splits)."""
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ff, r = cfg.d_ff, cfg.adapter_rank
    mamba_layer = {"ln": pd((d,), init="ones"),
                   "mixer": ssm.ssm_param_defs(cfg, Axes())}
    block = {
        "ln_attn": pd((2 * d,), init="ones"),
        "wq": pd((2 * d, h * dh)),
        "wk": pd((2 * d, hk * dh)),
        "wv": pd((2 * d, hk * dh)),
        "wo": pd((h * dh, d)),
        "ln_mlp": pd((d,), init="ones"),
        "w_gate_up": pd((d, 2 * ff)),
        "w_down": pd((ff, d)),
    }
    app = {"adapter_in": pd((d, r)), "adapter_out": pd((r, 2 * ff)),
           "linear": pd((d, d))}
    return {
        "embed": pd((cfg.padded_vocab, d), scale=1.0),
        "mamba": _stack_defs(mamba_layer, cfg.n_layers),
        "blocks": _stack_defs(block, cfg.num_mem_blocks),
        "apps": _stack_defs(app, n_apps(cfg)),
        "ln_f": pd((d,), init="ones"),
    }


def cache_defs(cfg: Zamba2Config, batch: int, max_len: int,
               axes: Axes | None = None):
    """Every layer's state and conv tail, and each application's K and V
    of ``max_len`` rows, zeros."""
    _unmeshed(cfg, axes)
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    attn_one = {"k": pd(kv, P(), init="zeros"),
                "v": pd(kv, P(), init="zeros")}
    return {"mamba": mamba_lm.cache_defs(cfg, batch, max_len),
            "attn": _stack_defs(attn_one, n_apps(cfg))}


def _qkv(xin, bp, cfg: Zamba2Config, positions):
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_rope(split_last(xin @ bp["wq"], h, dh), positions,
                   cfg.rope_theta)
    k = apply_rope(split_last(xin @ bp["wk"], hk, dh), positions,
                   cfg.rope_theta)
    v = split_last(xin @ bp["wv"], hk, dh)
    return q, k, v


def _mlp_out(a, bp, ap, cfg: Zamba2Config):
    """The block's tail from its attention output ``a`` (…, d): the
    pre-MLP norm, ``gate_up`` with the application's adapter, gelu-gated,
    ``down``; then the application's ``linear``."""
    x = rmsnorm(a, bp["ln_mlp"], cfg.norm_eps)
    gate_up = x @ bp["w_gate_up"] + (x @ ap["adapter_in"]) @ ap["adapter_out"]
    gate, up = gate_up.chunk(2, dim=-1)
    hid = F.gelu(gate.float()).to(x.dtype) * up
    return (hid @ bp["w_down"]) @ ap["linear"]


def _block(x, x0, params, j: int, cfg: Zamba2Config, positions):
    """Application ``j`` over a whole sequence: (what it adds to the
    mixer's input, (k, v) for the cache)."""
    bp = _layer(params["blocks"], j % cfg.num_mem_blocks)
    ap = _layer(params["apps"], j)
    xin = rmsnorm(torch.cat([x, x0], dim=-1), bp["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(xin, bp, cfg, positions)
    rep = cfg.n_heads // cfg.n_kv_heads
    out = flash_attention(q, repeat_kv(k, rep), repeat_kv(v, rep),
                          causal=True, scale=attn_scale(cfg))
    return _mlp_out(merge_last(out) @ bp["wo"], bp, ap, cfg), (k, v)


def _block_decode(x, x0, params, j: int, cfg: Zamba2Config, cache, pos,
                  lengths):
    """Application ``j`` for one token: writes row ``pos`` of its K and V
    in place and attends through the decode kernel; returns what it adds
    to the mixer's input."""
    b = x.shape[0]
    bp = _layer(params["blocks"], j % cfg.num_mem_blocks)
    ap = _layer(params["apps"], j)
    xin = rmsnorm(torch.cat([x, x0], dim=-1), bp["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(xin, bp, cfg, pos.expand(b, 1))
    write_row(cache["k"], pos, k)
    write_row(cache["v"], pos, v)
    out = decode_attend(q[:, 0], cache["k"], cache["v"], lengths,
                        scale=attn_scale(cfg))
    counters.count(f"zamba2_block{j % cfg.num_mem_blocks}")
    return _mlp_out(out.reshape(b, 1, -1) @ bp["wo"], bp, ap, cfg)


def _mixer_in(x, inject, lp, cfg: Zamba2Config):
    """The mixer's normed input: the residual stream, plus what the
    layer's application adds (not to the residual itself)."""
    return rmsnorm(x if inject is None else x + inject, lp["ln"],
                   cfg.norm_eps)


def _sequence(params, tokens, cfg: Zamba2Config, seq_mask=None,
              remat: bool = False):
    """tokens (B, S) -> (the residual stream (B, S, d) after the last
    layer, every layer's cache entry, every application's (k, v)); S a
    multiple of ``ssm_chunk``."""
    x = embed(tokens, params["embed"])
    x0 = x
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    app_of = {layer: j for j, layer in enumerate(cfg.hybrid_layer_ids)}
    states, kvs = [], []

    def layer(x, inject, lp):
        return ssm.ssd_forward(_mixer_in(x, inject, lp, cfg), lp["mixer"],
                               cfg, return_cache=True, seq_mask=seq_mask)

    for i in range(cfg.n_layers):
        inject = None
        if i in app_of:
            inject, kv = _block(x, x0, params, app_of[i], cfg, positions)
            kvs.append(kv)
        lp = _layer(params["mamba"], i)
        y, c = recompute(layer, x, inject, lp) if remat else \
            layer(x, inject, lp)
        x = x + y
        states.append(c)
    return x, states, kvs


def loss_fn(params, batch, cfg: Zamba2Config, axes: Axes | None = None,
            remat: bool = True):
    """Mean next-token cross entropy (``transformer.chunked_loss``) over
    the tied head; the tokens padded to a multiple of ``ssm_chunk`` (the
    layers are causal, so the pad does not reach the real positions)."""
    _unmeshed(cfg, axes)
    tokens, s0 = mamba_lm._pad_seq(batch["tokens"], cfg.ssm_chunk)
    x, _, _ = _sequence(params, tokens, cfg, remat=remat)
    hidden = rmsnorm(x, params["ln_f"], cfg.norm_eps)[:, :s0]
    return chunked_loss(hidden, params["embed"].t(), batch["labels"])


def prefill_fn(params, batch, cfg: Zamba2Config, axes: Axes | None = None,
               max_len: int | None = None):
    """Prompt forward.  The tokens are padded to a multiple of
    ``ssm_chunk``, ``dt`` masked at the pad; each application's K and V
    take ``transformer.cache_rows`` rows of ``max(max_len, padded S)``.
    Returns (last-real-position logits (B, V) float32, cache)."""
    _unmeshed(cfg, axes)
    tokens, s0 = mamba_lm._pad_seq(batch["tokens"], cfg.ssm_chunk)
    b, s = tokens.shape
    rows = cache_rows(cfg, b, max(max_len or s0, s))
    seq_mask = mamba_lm._seq_mask(b, s, s0, tokens.device)
    x, states, kvs = _sequence(params, tokens, cfg, seq_mask)
    defs = cache_defs(cfg, b, rows)
    cache = {"mamba": stack_layers(states, defs["mamba"], None),
             "attn": stack_layers([{"k": pad_rows(k, rows),
                                    "v": pad_rows(v, rows)}
                                   for k, v in kvs], defs["attn"], None)}
    x = rmsnorm(x[:, s0 - 1], params["ln_f"], cfg.norm_eps)
    return _logits(x, params["embed"].t()), cache


def decode_fn(params, cache, tokens, pos, cfg: Zamba2Config,
              axes: Axes | None = None):
    """One decode step.  tokens (B, 1); ``pos`` a 0-d integer tensor on
    the model's device or a Python int.  Returns (logits (B, V) float32,
    cache), the cache the one passed in, updated in place."""
    _unmeshed(cfg, axes)
    x = embed(tokens, params["embed"])
    x0 = x
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
    pos = pos.reshape(())
    lengths = (pos + 1).to(torch.int32).expand(tokens.shape[0]).contiguous()
    app_of = {layer: j for j, layer in enumerate(cfg.hybrid_layer_ids)}
    for i in range(cfg.n_layers):
        inject = None
        if i in app_of:
            j = app_of[i]
            inject = _block_decode(x, x0, params, j, cfg,
                                   _layer(cache["attn"], j), pos, lengths)
        lp = _layer(params["mamba"], i)
        x = x + ssm.ssd_decode(_mixer_in(x, inject, lp, cfg), lp["mixer"],
                               cfg, _layer(cache["mamba"], i))
    x = rmsnorm(x[:, 0], params["ln_f"], cfg.norm_eps)
    return _logits(x, params["embed"].t()), cache


def step_writes(cfg: Zamba2Config, cache, pos: int) -> list:
    """The tensors a decode step at ``pos`` writes: every layer's state
    and conv tail whole, and row ``pos`` of each application's K and V
    (views)."""
    return mamba_lm.step_writes(cfg, cache["mamba"], pos) + \
        [cache["attn"][name][:, :, pos] for name in ("k", "v")]


def last_pos(cfg: Zamba2Config, cache) -> int:
    """The last position a decode step may take: the KV cache's last
    row."""
    return cache["attn"]["k"].shape[2] - 1
