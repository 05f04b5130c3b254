"""Zamba2-style hybrid (arXiv:2411.15242): a Mamba-2 backbone with one
*shared* attention + MLP block applied every ``attn_every`` layers.  The
shared block's input is concat(hidden, initial embedding) projected back to
d_model (the paper's per-application LoRA deltas are left out, as in the
JAX package).

``n_layers`` mamba blocks run in ``n_layers // attn_every`` segments; after
each segment the one shared block runs.  Each *application* of the shared
block has its own KV cache (same weights, other activations), so the cache
is nested: ``{"mamba": {h, conv} stacked over the layers, "attn": {k, v}
stacked over the applications}``.  The decode step attends through
``ops.decode_attention`` (the hand-written decode kernel on the card), once
per application, over the cache as stored; the JAX package computes it in
``jnp``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import mamba_lm, ssm
from repro_torch.models.common import ArchConfig, init_params, map_defs, pd
from repro_torch.models.layers import (apply_rope, embed, flash_attention,
                                       repeat_kv, rmsnorm, swiglu)
from repro_torch.models.transformer import (_layer, _logits, _stack_defs,
                                            cache_rows, chunked_loss,
                                            recompute)


def _n_apps(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def shared_block_defs(cfg: ArchConfig):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "w_in": pd((2 * d, d)),
        "ln_attn": pd((d,), init="ones"),
        "wq": pd((d, h * dh)),
        "wk": pd((d, cfg.n_kv_heads * dh)),
        "wv": pd((d, cfg.n_kv_heads * dh)),
        "wo": pd((h * dh, d)),
        "ln_mlp": pd((d,), init="ones"),
        "w_gate": pd((d, cfg.d_ff)),
        "w_up": pd((d, cfg.d_ff)),
        "w_down": pd((cfg.d_ff, d)),
    }


def param_defs(cfg: ArchConfig):
    mamba_layer = {
        "ln": pd((cfg.d_model,), init="ones"),
        "mixer": ssm.ssm_param_defs(cfg),
    }
    return {
        "embed": pd((cfg.padded_vocab, cfg.d_model), scale=1.0),
        "mamba": _stack_defs(mamba_layer, cfg.n_layers),
        "shared": shared_block_defs(cfg),
        "ln_f": pd((cfg.d_model,), init="ones"),
        "lm_head": pd((cfg.d_model, cfg.padded_vocab)),
    }


def _qkv(x, p, cfg: ArchConfig, positions):
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, hk, dh)
    v = (x @ p["wv"]).reshape(b, s, hk, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp(xin, p):
    return swiglu(rmsnorm(xin, p["ln_mlp"]), p["w_gate"], p["w_up"],
                  p["w_down"])


def shared_block(x, x0, p, cfg: ArchConfig, positions):
    """Full-sequence form.  Returns (out, (k, v) for the cache)."""
    xin = torch.cat([x, x0], dim=-1) @ p["w_in"]
    q, k, v = _qkv(rmsnorm(xin, p["ln_attn"]), p, cfg, positions)
    rep = cfg.n_heads // cfg.n_kv_heads
    out = flash_attention(q, repeat_kv(k, rep), repeat_kv(v, rep),
                          causal=True)
    b, s = x.shape[:2]
    xin = xin + out.reshape(b, s, -1) @ p["wo"]
    xin = xin + _mlp(xin, p)
    return x + xin, (k, v)


def shared_block_decode(x, x0, p, cfg: ArchConfig, cache, pos: torch.Tensor,
                        lengths: torch.Tensor):
    """One-token form.  Writes this token's K and V into row ``pos`` of
    the application's cache in place, by device index, then attends
    through ``ops.decode_attention`` with ``lengths`` = ``pos + 1``, as
    ``transformer.gqa_decode`` does."""
    b = x.shape[0]
    xin = torch.cat([x, x0], dim=-1) @ p["w_in"]
    q, k, v = _qkv(rmsnorm(xin, p["ln_attn"]), p, cfg, pos.expand(b, 1))
    row = pos.reshape(1).long()
    cache["k"].index_copy_(1, row, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, row, v.to(cache["v"].dtype))
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths)
    xin = xin + out.reshape(b, 1, -1) @ p["wo"]
    xin = xin + _mlp(xin, p)
    return x + xin


def cache_defs(cfg: ArchConfig, batch: int, max_len: int):
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    attn_one = {"k": pd(kv, init="zeros"), "v": pd(kv, init="zeros")}
    return {
        "mamba": mamba_lm.cache_defs(cfg, batch, max_len),
        "attn": _stack_defs(attn_one, _n_apps(cfg)),
    }


def _segments(params_mamba, cfg: ArchConfig) -> list:
    """The stacked mamba parameters cut into the ``n_layers //
    attn_every`` segments the shared block follows (views)."""
    per = cfg.attn_every
    return [map_defs(lambda a, i=i: a[i * per:(i + 1) * per], params_mamba)
            for i in range(_n_apps(cfg))]


def _run_segment(x, seg_params, cfg: ArchConfig, remat: bool = True):
    """One segment's mamba layers over the whole sequence, each
    recomputed in the backward pass with ``remat``."""
    def layer(x, lp):
        return x + ssm.ssd_forward(rmsnorm(x, lp["ln"]), lp["mixer"], cfg)

    for i in range(cfg.attn_every):
        lp = _layer(seg_params, i)
        x = recompute(layer, x, lp) if remat else layer(x, lp)
    return x


def backbone(params, tokens, cfg: ArchConfig, remat: bool = True):
    """tokens (B, S) -> hidden (B, S, d) after the final norm (training):
    the tokens padded to a multiple of ``ssm_chunk`` with ``dt`` not
    masked (``mamba_lm.backbone``; the shared block is causal too), each
    segment followed by the shared block, the hidden states cut back to
    S."""
    tokens_p, s0 = mamba_lm._pad_seq(tokens, cfg.ssm_chunk)
    x = embed(tokens_p, params["embed"])
    x0 = x
    b, s = tokens_p.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for seg in _segments(params["mamba"], cfg):
        x = _run_segment(x, seg, cfg, remat)
        x, _ = shared_block(x, x0, params["shared"], cfg, positions)
    return rmsnorm(x, params["ln_f"])[:, :s0]


def loss_fn(params, batch, cfg: ArchConfig, remat: bool = True):
    """Mean next-token cross entropy (``transformer.chunked_loss``)."""
    hidden = backbone(params, batch["tokens"], cfg, remat)
    return chunked_loss(hidden, params["lm_head"], batch["labels"])


def prefill_fn(params, batch, cfg: ArchConfig, max_len: int | None = None):
    """Prompt forward.  The tokens are padded to a multiple of
    ``ssm_chunk`` (``dt`` masked at the pad; the shared block is causal,
    so the pad does not reach the real positions), and the KV cache holds
    at least the padded length, ``max(max_len, padded S)``, rounded up to
    the rows the decode kernel's plan walks in place
    (``transformer.cache_rows``), so no decode step copies it.
    Returns (last-real-position logits (B, V) float32, cache)."""
    tokens, s0 = mamba_lm._pad_seq(batch["tokens"], cfg.ssm_chunk)
    b, s = tokens.shape
    max_len = max(max_len or s0, s)
    x = embed(tokens, params["embed"])
    x0 = x
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    seq_mask = mamba_lm._seq_mask(b, s, s0, x.device)
    cache = init_params(cache_defs(cfg, b, cache_rows(cfg, b, max_len)),
                        device=x.device)
    per = cfg.attn_every
    for app in range(_n_apps(cfg)):
        for i in range(app * per, (app + 1) * per):
            lp = _layer(params["mamba"], i)
            y, c = ssm.ssd_forward(rmsnorm(x, lp["ln"]), lp["mixer"], cfg,
                                   return_cache=True, seq_mask=seq_mask)
            x = x + y
            for name in ("h", "conv"):
                cache["mamba"][name][i] = c[name]
        x, (k, v) = shared_block(x, x0, params["shared"], cfg, positions)
        cache["attn"]["k"][app, :, :s] = k.to(torch.bfloat16)
        cache["attn"]["v"][app, :, :s] = v.to(torch.bfloat16)
    x = rmsnorm(x[:, s0 - 1:s0], params["ln_f"])
    return _logits(x[:, 0], params["lm_head"]), cache


def decode_fn(params, cache, tokens, pos, cfg: ArchConfig):
    """One decode step.  tokens (B, 1); ``pos`` a 0-d integer tensor on
    the model's device or a Python int.  Returns (logits (B, V) float32,
    cache), the cache the one passed in, updated in place: every mamba
    layer's state, and row ``pos`` of every application's K and V.  On the
    card each application launches the decode kernel once.  The body reads
    nothing back to the host."""
    x = embed(tokens, params["embed"])
    x0 = x
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
    pos = pos.reshape(())
    lengths = (pos + 1).to(torch.int32).expand(tokens.shape[0]).contiguous()
    per = cfg.attn_every
    for app in range(_n_apps(cfg)):
        for i in range(app * per, (app + 1) * per):
            lp = _layer(params["mamba"], i)
            x = x + ssm.ssd_decode(rmsnorm(x, lp["ln"]), lp["mixer"], cfg,
                                   _layer(cache["mamba"], i))
        x = shared_block_decode(x, x0, params["shared"], cfg,
                                _layer(cache["attn"], app), pos, lengths)
    x = rmsnorm(x, params["ln_f"])
    return _logits(x[:, 0], params["lm_head"]), cache


def step_writes(cfg: ArchConfig, cache, pos: int) -> list:
    """The tensors a decode step at ``pos`` writes: the whole state, and
    row ``pos`` of each application's K and V (views)."""
    return mamba_lm.step_writes(cfg, cache["mamba"], pos) + \
        [cache["attn"][name][:, :, pos] for name in ("k", "v")]


def last_pos(cfg: ArchConfig, cache) -> int:
    """The last position a decode step may take: the KV cache's last row
    (a padding row when prefill padded the cache, as in
    ``transformer.last_pos``)."""
    return cache["attn"]["k"].shape[2] - 1
