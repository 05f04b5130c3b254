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

This is the JAX package's simplification, kept as it is for the parity
tests; ``models/zamba2.py`` is the published layout
(``configs/zamba2_2_7b.py`` lists where they part).
"""
from __future__ import annotations

import torch

from repro_torch.models import mamba_lm, ssm
from repro_torch.models.common import ArchConfig, Axes, P, map_defs, pd
from repro_torch.models.layers import (apply_rope, embed, flash_attention,
                                       linear, merge_last, repeat_kv, rmsnorm,
                                       shard, split_last, swiglu, write_row)
from repro_torch.models.transformer import (_layer, _logits, _stack_defs,
                                            cache_rows, chunked_loss,
                                            decode_attend, pad_rows,
                                            recompute, stack_layers)


def _n_apps(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def shared_block_defs(cfg: ArchConfig, axes: Axes):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "w_in": pd((2 * d, d), P(axes.data, axes.model)),
        "ln_attn": pd((d,), P(None), init="ones"),
        "wq": pd((d, h * dh), P(axes.data, axes.model)),
        "wk": pd((d, cfg.n_kv_heads * dh), P(axes.data, axes.model)),
        "wv": pd((d, cfg.n_kv_heads * dh), P(axes.data, axes.model)),
        "wo": pd((h * dh, d), P(axes.model, axes.data)),
        "ln_mlp": pd((d,), P(None), init="ones"),
        "w_gate": pd((d, cfg.d_ff), P(axes.data, axes.model)),
        "w_up": pd((d, cfg.d_ff), P(axes.data, axes.model)),
        "w_down": pd((cfg.d_ff, d), P(axes.model, axes.data)),
    }


def param_defs(cfg: ArchConfig, axes: Axes | None = None):
    ax = axes or Axes()
    mamba_layer = {
        "ln": pd((cfg.d_model,), P(None), init="ones"),
        "mixer": ssm.ssm_param_defs(cfg, ax),
    }
    return {
        "embed": pd((cfg.padded_vocab, cfg.d_model), P(None, ax.model),
                    scale=1.0),
        "mamba": _stack_defs(mamba_layer, cfg.n_layers),
        "shared": shared_block_defs(cfg, ax),
        "ln_f": pd((cfg.d_model,), P(None), init="ones"),
        "lm_head": pd((cfg.d_model, cfg.padded_vocab), P(ax.data, ax.model)),
    }


def _qkv(x, p, cfg: ArchConfig, positions):
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_last(x @ p["wq"], h, dh)
    k = split_last(x @ p["wk"], hk, dh)
    v = split_last(x @ p["wv"], hk, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp(xin, p):
    return swiglu(rmsnorm(xin, p["ln_mlp"]), p["w_gate"], p["w_up"],
                  p["w_down"])


def shared_block(x, x0, p, cfg: ArchConfig, positions,
                 axes: Axes | None = None):
    """Full-sequence form.  Returns (out, (k, v) for the cache).  Under a
    mesh q, k, v are pinned with the heads on "model" (and the batch on
    ("pod","data") when it is more than 1), and the block's own residual
    ``xin`` with d whole: left to DTensor it stays a partial sum over
    "model" (its input's d is split there), whose backward runs the
    block's products on whole weights (Zamba2 train_4k in the dry run on
    the 16 x 16 mesh: 1.166e14 against 1.021e14 matmul FLOPs a
    device)."""
    xin = torch.cat([x, x0], dim=-1) @ p["w_in"]
    if axes:
        batch = axes.batch if x.shape[0] > 1 else None
        xin = shard(xin, P(batch, None, None))
    q, k, v = _qkv(rmsnorm(xin, p["ln_attn"]), p, cfg, positions)
    if axes:
        hspec = P(batch, None, axes.model, None)
        q, k, v = shard(q, hspec), shard(k, hspec), shard(v, hspec)
    rep = cfg.n_heads // cfg.n_kv_heads
    out = flash_attention(q, repeat_kv(k, rep), repeat_kv(v, rep),
                          causal=True)
    xin = xin + linear(merge_last(out), p["wo"])
    xin = xin + _mlp(xin, p)
    return x + xin, (k, v)


def shared_block_decode(x, x0, p, cfg: ArchConfig, cache, pos: torch.Tensor,
                        lengths: torch.Tensor, axes: Axes | None = None):
    """One-token form.  Writes this token's K and V into row ``pos`` of
    the application's cache in place, by device index, then attends
    through ``ops.decode_attention`` with ``lengths`` = ``pos + 1``, as
    ``transformer.gqa_decode`` does.  Under a mesh ``xin`` is pinned as
    in :func:`shared_block` (split over "model", it meets the output
    projection's partial sum in a sum that PyTorch 2.11's DTensor cannot
    lay out)."""
    b = x.shape[0]
    xin = torch.cat([x, x0], dim=-1) @ p["w_in"]
    if axes:
        xin = shard(xin, P(axes.batch if b > 1 else None, None, None))
    q, k, v = _qkv(rmsnorm(xin, p["ln_attn"]), p, cfg, pos.expand(b, 1))
    write_row(cache["k"], pos, k)
    write_row(cache["v"], pos, v)
    out = decode_attend(q[:, 0], cache["k"], cache["v"], lengths)
    xin = xin + out.reshape(b, 1, -1) @ p["wo"]
    xin = xin + _mlp(xin, p)
    return x + xin


def cache_defs(cfg: ArchConfig, batch: int, max_len: int,
               axes: Axes | None = None):
    """The mamba layers' states and each application's K/V.  The batch
    over ("pod","data") unless it is 1 (long_500k), then the sequence over
    "data"; the KV heads over "model"."""
    ax = axes or Axes()
    batch_axis = ax.batch if (axes and batch > 1) else None
    seq_axis = ax.data if (axes and batch == 1) else None   # long_500k
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    spec = P(batch_axis, seq_axis, ax.model if axes else None, None)
    attn_one = {"k": pd(kv, spec, init="zeros"),
                "v": pd(kv, spec, init="zeros")}
    return {
        "mamba": mamba_lm.cache_defs(cfg, batch, max_len, axes),
        "attn": _stack_defs(attn_one, _n_apps(cfg)),
    }


def _segments(params_mamba, cfg: ArchConfig) -> list:
    """The stacked mamba parameters cut into the ``n_layers //
    attn_every`` segments the shared block follows (views)."""
    per = cfg.attn_every
    return [map_defs(lambda a, i=i: a[i * per:(i + 1) * per], params_mamba)
            for i in range(_n_apps(cfg))]


def _run_segment(x, seg_params, cfg: ArchConfig, remat: bool = True,
                 axes: Axes | None = None):
    """One segment's mamba layers over the whole sequence, each
    recomputed in the backward pass with ``remat``."""
    def layer(x, lp):
        return x + ssm.ssd_forward(rmsnorm(x, lp["ln"]), lp["mixer"], cfg,
                                   axes=axes)

    for i in range(cfg.attn_every):
        lp = _layer(seg_params, i)
        x = recompute(layer, x, lp) if remat else layer(x, lp)
    return x


def backbone(params, tokens, cfg: ArchConfig, remat: bool = True,
             axes: Axes | None = None):
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
        x = _run_segment(x, seg, cfg, remat, axes)
        x, _ = shared_block(x, x0, params["shared"], cfg, positions, axes)
    return rmsnorm(x, params["ln_f"])[:, :s0]


def loss_fn(params, batch, cfg: ArchConfig, axes: Axes | None = None,
            remat: bool = True):
    """Mean next-token cross entropy (``transformer.chunked_loss``)."""
    hidden = backbone(params, batch["tokens"], cfg, remat, axes)
    return chunked_loss(hidden, params["lm_head"], batch["labels"],
                        axes=axes)


def prefill_fn(params, batch, cfg: ArchConfig, axes: Axes | None = None,
               max_len: int | None = None):
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
    rows = cache_rows(cfg, b, max_len)
    mamba_entries, attn_entries = [], []
    per = cfg.attn_every
    for app in range(_n_apps(cfg)):
        for i in range(app * per, (app + 1) * per):
            lp = _layer(params["mamba"], i)
            y, c = ssm.ssd_forward(rmsnorm(x, lp["ln"]), lp["mixer"], cfg,
                                   return_cache=True, seq_mask=seq_mask,
                                   axes=axes)
            x = x + y
            mamba_entries.append(c)
        x, (k, v) = shared_block(x, x0, params["shared"], cfg, positions,
                                 axes)
        attn_entries.append({"k": pad_rows(k, rows), "v": pad_rows(v, rows)})
    defs = cache_defs(cfg, b, rows, axes)
    cache = {"mamba": stack_layers(mamba_entries, defs["mamba"], axes),
             "attn": stack_layers(attn_entries, defs["attn"], axes)}
    x = rmsnorm(x[:, s0 - 1:s0], params["ln_f"])
    return _logits(x[:, 0], params["lm_head"]), cache


def decode_fn(params, cache, tokens, pos, cfg: ArchConfig,
              axes: Axes | None = None):
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
                                   _layer(cache["mamba"], i), axes)
        x = shared_block_decode(x, x0, params["shared"], cfg,
                                _layer(cache["attn"], app), pos, lengths,
                                axes)
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
