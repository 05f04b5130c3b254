"""Nemotron-H with routed experts, as NVIDIA-Nemotron-3-Nano-30B-A3B
publishes it (Hugging Face's ``NemotronHForCausalLM``,
``modeling_nemotron_h.py``), un-meshed: the serving path of
``nemotron-3-nano-30b-a3b``.

One block a letter of ``cfg.pattern`` (``hybrid_override_pattern``),
each ``x <- x + mixer(RMSNorm(x))``:

    M   a Mamba-2 mixer (``models/ssm.py``): ``ssm_n_heads`` heads of
        ``ssm_head_dim`` (d_inner their product), B and C in
        ``ssm_groups`` groups, the gated norm by group
    E   routed experts beside a shared one (``models/moe.py``): sigmoid
        scores, a selection-only bias, renormalised, x ``routed_scale``;
        relu^2 experts, not gated; no (token, choice) pair dropped
    *   GQA attention with no positional encoding, scaled by D ** -0.5

then RMSNorm and the untied ``lm_head``.  Every RMSNorm takes
``norm_eps``.

The weights are a dict of blocks by index (``params["blocks"][str(i)]``,
each ``{"norm", "mixer"}``), so a block's weights are tensors of their
own, drawn one at a time.  The cache holds two kinds of state side by
side, and the routes: ``{"mamba": {h, conv} stacked over the M blocks,
"attn": {k, v} stacked over the * blocks, "moe": {routes} stacked over the
E blocks}``, ``routes`` (B, rows, top_k) int16 the experts each position's
token chose at that block, kept as its K and V rows are (a record of
what served each token: a trainer that replays an inference's routing
reads it, and so does a check of the served tokens against a reference,
which can then follow the same choices).  The decode step writes every
Mamba block's state and conv window, row ``pos`` of every attention
block's K and V and of every expert block's routes in place, attends
through ``transformer.decode_attend`` (the hand-written decode kernel on
the card), routes every token of the step with a capacity of the step's
token count (:func:`expert_mixer`), and reads nothing back to the
host.  ``nemotron_moe`` in ``obs.counters`` counts the decode
step's expert-layer applications, on the host, as ``ssm_update`` counts
the recurrent updates: a CUDA graph's capture counts one step's.
"""
from __future__ import annotations

import torch

from repro_torch.models import mamba_lm, moe, ssm
from repro_torch.models.common import Axes, NemotronHConfig, P, pd
from repro_torch.models.layers import (embed, flash_attention, merge_last,
                                       repeat_kv, rmsnorm, split_last,
                                       write_row)
from repro_torch.models.transformer import (_logits, _stack_defs,
                                            cache_rows, decode_attend,
                                            pad_rows, stack_layers)
from repro_torch.obs import counters

# the published layout has no mesh rules in this port (``ModelApi.meshed``)
MESHED = False


def _unmeshed(cfg: NemotronHConfig, axes: Axes | None) -> None:
    if axes is not None:
        raise ValueError(f"{cfg.name} runs un-meshed (the published "
                         f"layout has no mesh rules in this port)")


def kinds(cfg: NemotronHConfig) -> dict:
    """Each kind's blocks, in order: {"M": [...], "E": [...], "*": [...]}
    (a block's place in its list is its place in the cache's stack)."""
    out = {"M": [], "E": [], "*": []}
    for i, kind in enumerate(cfg.pattern):
        out[kind].append(i)
    return out


def _attn_defs(cfg: NemotronHConfig):
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": pd((d, h * dh)), "wk": pd((d, hk * dh)),
            "wv": pd((d, hk * dh)), "wo": pd((h * dh, d))}


def param_defs(cfg: NemotronHConfig, axes: Axes | None = None):
    """Every weight, un-meshed (``axes`` is not used: no spec splits)."""
    if len(cfg.pattern) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: pattern {cfg.pattern!r} is not "
                         f"{cfg.n_layers} blocks long")
    d = cfg.d_model
    mixers = {"M": lambda: ssm.ssm_param_defs(cfg, Axes()),
              "E": lambda: moe.sigmoid_param_defs(cfg),
              "*": lambda: _attn_defs(cfg)}
    return {
        "embed": pd((cfg.padded_vocab, d), scale=1.0),
        "blocks": {str(i): {"norm": pd((d,), init="ones"),
                            "mixer": mixers[kind]()}
                   for i, kind in enumerate(cfg.pattern)},
        "norm_f": pd((d,), init="ones"),
        "lm_head": pd((d, cfg.padded_vocab)),
    }


def cache_defs(cfg: NemotronHConfig, batch: int, max_len: int,
               axes: Axes | None = None):
    """Every Mamba block's f32 state and bf16 conv window, every attention
    block's K and V of ``max_len`` rows and every expert block's routes of
    as many, zeros."""
    _unmeshed(cfg, axes)
    k = kinds(cfg)
    conv = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    state = {"h": pd((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                     P(), init="zeros", dtype=torch.float32),
             "conv": pd((batch, cfg.ssm_conv_width - 1, conv), P(),
                        init="zeros")}
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    attn = {"k": pd(kv, P(), init="zeros"), "v": pd(kv, P(), init="zeros")}
    routes = {"routes": pd((batch, max_len, cfg.top_k), P(), init="zeros",
                           dtype=torch.int16)}
    return {"mamba": _stack_defs(state, len(k["M"])),
            "attn": _stack_defs(attn, len(k["*"])),
            "moe": _stack_defs(routes, len(k["E"]))}


def _qkv(x, p, cfg: NemotronHConfig):
    return (split_last(x @ p["wq"], cfg.n_heads, cfg.head_dim),
            split_last(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim),
            split_last(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim))


def _sequence(params, tokens, cfg: NemotronHConfig, seq_mask=None):
    """tokens (B, S) -> (the residual stream (B, S, d) after the last
    block, every Mamba block's cache entry, every attention block's
    (k, v), every expert block's routes (B, S, k)); S a multiple of
    ``ssm_chunk``.  The expert blocks' capacity is the largest load, read
    back."""
    x = embed(tokens, params["embed"])
    states, kvs, routes = [], [], []

    def block(x, kind, bp):
        xin = rmsnorm(x, bp["norm"], cfg.norm_eps)
        if kind == "M":
            return ssm.ssd_forward(xin, bp["mixer"], cfg, return_cache=True,
                                   seq_mask=seq_mask)
        if kind == "E":
            return moe.dropless(xin, bp["mixer"], cfg, None)
        q, k, v = _qkv(xin, bp["mixer"], cfg)
        rep = cfg.n_heads // cfg.n_kv_heads
        out = flash_attention(q, repeat_kv(k, rep), repeat_kv(v, rep),
                              causal=True)
        return merge_last(out) @ bp["mixer"]["wo"], (k, v)

    for i, kind in enumerate(cfg.pattern):
        bp = params["blocks"][str(i)]
        y, entry = block(x, kind, bp)
        x = x + y
        if kind == "M":
            states.append(entry)
        elif kind == "*":
            kvs.append(entry)
        else:
            routes.append(entry)
    return x, states, kvs, routes


def prefill_fn(params, batch, cfg: NemotronHConfig, axes: Axes | None = None,
               max_len: int | None = None):
    """Prompt forward.  The tokens are padded to a multiple of
    ``ssm_chunk``, ``dt`` masked at the pad; each attention block's K and
    V take ``transformer.cache_rows`` rows of ``max(max_len, padded S)``.
    Returns (last-real-position logits (B, V) float32, cache)."""
    _unmeshed(cfg, axes)
    tokens, s0 = mamba_lm._pad_seq(batch["tokens"], cfg.ssm_chunk)
    b, s = tokens.shape
    rows = cache_rows(cfg, b, max(max_len or s0, s))
    seq_mask = mamba_lm._seq_mask(b, s, s0, tokens.device)
    x, states, kvs, routes = _sequence(params, tokens, cfg, seq_mask)
    defs = cache_defs(cfg, b, rows)
    cache = {"mamba": stack_layers(states, defs["mamba"], None),
             "attn": stack_layers([{"k": pad_rows(k, rows),
                                    "v": pad_rows(v, rows)}
                                   for k, v in kvs], defs["attn"], None),
             "moe": stack_layers([{"routes": pad_rows(r, rows)}
                                  for r in routes], defs["moe"], None)}
    x = rmsnorm(x[:, s0 - 1], params["norm_f"], cfg.norm_eps)
    return _logits(x, params["lm_head"]), cache


def _attend_decode(x, p, cfg: NemotronHConfig, cache, pos, lengths):
    """An attention block's mixer for one token: writes row ``pos`` of
    its K and V in place and attends through the decode kernel."""
    b = x.shape[0]
    q, k, v = _qkv(x, p, cfg)
    write_row(cache["k"], pos, k)
    write_row(cache["v"], pos, v)
    out = decode_attend(q[:, 0], cache["k"], cache["v"], lengths)
    return out.reshape(b, 1, -1) @ p["wo"]


def expert_mixer(x, p, cfg: NemotronHConfig):
    """An expert block's mixer over a decode step's tokens ``x (B, S,
    d)``: every pair in a slot at a capacity of the step's ``B * S``
    tokens, so that no expert overflows and nothing is read back.
    Returns (its output (B, S, d), each token's experts (B, S, k))."""
    return moe.dropless(x, p, cfg, capacity=x.shape[0] * x.shape[1])


def decode_fn(params, cache, tokens, pos, cfg: NemotronHConfig,
              axes: Axes | None = None):
    """One decode step.  tokens (B, 1); ``pos`` a 0-d integer tensor on
    the model's device or a Python int.  Returns (logits (B, V) float32,
    cache), the cache the one passed in, updated in place."""
    _unmeshed(cfg, axes)
    x = embed(tokens, params["embed"])
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
    pos = pos.reshape(())
    b = tokens.shape[0]
    lengths = (pos + 1).to(torch.int32).expand(b).contiguous()
    at = {"M": 0, "*": 0}
    chosen = []
    for i, kind in enumerate(cfg.pattern):
        bp = params["blocks"][str(i)]
        xin = rmsnorm(x, bp["norm"], cfg.norm_eps)
        if kind == "M":
            j = at["M"]
            y = ssm.ssd_decode(xin, bp["mixer"], cfg,
                               {n: c[j] for n, c in cache["mamba"].items()})
        elif kind == "E":
            y, experts = expert_mixer(xin, bp["mixer"], cfg)
            chosen.append(experts)
            counters.count("nemotron_moe")
        else:
            j = at["*"]
            y = _attend_decode(xin, bp["mixer"], cfg,
                               {n: c[j] for n, c in cache["attn"].items()},
                               pos, lengths)
        if kind in at:
            at[kind] += 1
        x = x + y
    # every expert block's row ``pos`` at once: one write a step
    routes = cache["moe"]["routes"]
    routes.index_copy_(2, pos.reshape(1).long(),
                       torch.stack(chosen).to(routes.dtype))
    x = rmsnorm(x[:, 0], params["norm_f"], cfg.norm_eps)
    return _logits(x, params["lm_head"]), cache


def step_writes(cfg: NemotronHConfig, cache, pos: int) -> list:
    """The tensors a decode step at ``pos`` writes: every Mamba block's
    state and conv window whole, and row ``pos`` of each attention
    block's K and V and of each expert block's routes (views)."""
    return [cache["mamba"]["h"], cache["mamba"]["conv"]] + \
        [cache["attn"][name][:, :, pos] for name in ("k", "v")] + \
        [cache["moe"]["routes"][:, :, pos]]


def last_pos(cfg: NemotronHConfig, cache) -> int:
    """The last position a decode step may take: the KV cache's last
    row."""
    return cache["attn"]["k"].shape[2] - 1
