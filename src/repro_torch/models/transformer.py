"""Decoder-only LM covering the dense, MoE, MLA and VLM-backbone families:
parameters, the training loss, prefill and the decode step of the serving
path.

Layout follows the JAX package: every per-layer weight is stacked over
layers (a leading ``n_layers`` dim), 2-D weights are ``(in, out)`` and the
cache is stacked over layers in bfloat16: ``k``/``v`` ``(n_layers, B, S,
H_kv, D)`` for GQA, ``c_kv`` ``(n_layers, B, S, kv_lora_rank)`` and
``k_pe`` ``(n_layers, B, S, qk_rope_head_dim)`` for MLA.  The projections
are plain ``torch.matmul`` (XLA's ``@`` in the JAX package); the GQA
attention of every decode step goes through ``ops.decode_attention``, i.e.
the hand-written decode kernel on the card, on the cache as stored (not
GQA-repeated).  MLA's absorbed decode (``models/mla.py``) and the MoE
feed-forward (``models/moe.py``) are plain PyTorch, as the JAX package's
are ``jnp``.

Training (``loss_fn``) runs the layers with the JAX package's sqrt(L)
two-level activation checkpointing (``two_level_scan``, nested
``torch.utils.checkpoint``) and the loss in sequence chunks
(``chunked_loss``), so neither every layer's activations nor the (B, S,
V) logits are kept for the backward pass.

``decode_fn`` keeps the position on the device: ``pos`` is a 0-d int32
tensor (a Python int is converted at the entry), the cache row is written
by device index, and the positions and lengths are built from it on the
device.  Nothing in the step reads a value back to the host, so
``launch.steps.graph_decode_step`` can capture it in a CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ArchConfig, init_params, map_defs, pd
from repro_torch.models.layers import (apply_rope, embed, flash_attention,
                                       full_f32_matmul, repeat_kv, rmsnorm,
                                       swiglu)


# --------------------------------------------------------------------- #
# Parameter definitions
# --------------------------------------------------------------------- #

def attn_param_defs(cfg: ArchConfig):
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": pd((d, h * dh)),
        "wk": pd((d, hk * dh)),
        "wv": pd((d, hk * dh)),
        "wo": pd((h * dh, d)),
    }
    if cfg.qkv_bias:
        defs.update({
            "bq": pd((h * dh,), init="zeros"),
            "bk": pd((hk * dh,), init="zeros"),
            "bv": pd((hk * dh,), init="zeros"),
        })
    if cfg.qk_norm:
        defs.update({
            "q_norm": pd((dh,), init="ones"),
            "k_norm": pd((dh,), init="ones"),
        })
    return defs


def mlp_param_defs(cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": pd((d, f)),
        "w_up": pd((d, f)),
        "w_down": pd((f, d)),
    }


def layer_param_defs(cfg: ArchConfig):
    return {
        "ln_attn": pd((cfg.d_model,), init="ones"),
        "ln_mlp": pd((cfg.d_model,), init="ones"),
        "attn": (mla_mod.mla_param_defs(cfg) if cfg.mla
                 else attn_param_defs(cfg)),
        "ffn": (moe_mod.moe_param_defs(cfg) if cfg.n_experts
                else mlp_param_defs(cfg)),
    }


def _stack_defs(defs, n: int):
    return map_defs(lambda d: pd((n,) + d.shape, d.init, d.scale, d.dtype),
                    defs)


def param_defs(cfg: ArchConfig):
    v, d = cfg.padded_vocab, cfg.d_model
    return {
        "embed": pd((v, d), scale=1.0),
        "layers": _stack_defs(layer_param_defs(cfg), cfg.n_layers),
        "ln_f": pd((d,), init="ones"),
        "lm_head": pd((d, v)),
    }


def _layer(tree, i: int):
    """Layer ``i``'s slice of a tree stacked over layers (views)."""
    if isinstance(tree, dict):
        return {name: _layer(sub, i) for name, sub in tree.items()}
    return tree[i]


# --------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------- #

def _qkv(x, p, cfg: ArchConfig):
    """Projections, reshaped to heads: q (B,S,H,D), k and v (B,S,H_kv,D)."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hk, dh)
    v = v.reshape(b, s, hk, dh)
    if cfg.qk_norm:
        q, k = rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])
    return q, k, v


def gqa_attention(x, p, cfg: ArchConfig, positions, q_offset: int = 0):
    """Full-sequence GQA attention (prefill).  Returns the block's output
    and the un-repeated (k, v) for the cache."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(x, p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, repeat_kv(k, h // hk), repeat_kv(v, h // hk),
                          causal=cfg.causal, q_offset=q_offset)
    return out.reshape(b, s, h * dh) @ p["wo"], (k, v)


def gqa_decode(x, p, cfg: ArchConfig, cache, pos: torch.Tensor, lengths):
    """One-token GQA attention against the cache.  x (B,1,d); pos a 0-d
    integer tensor on x's device.

    Writes this token's K and V into row ``pos`` of the layer's cache IN
    PLACE, by device index (the JAX package returns an updated copy), then
    attends through ``ops.decode_attention`` — the hand-written kernel on
    the card — over the cache as stored, with ``lengths`` (B,) int32 =
    ``pos + 1``."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.head_dim
    positions = pos.expand(b, 1)
    q, k, v = _qkv(x, p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    row = pos.reshape(1).long()
    cache["k"].index_copy_(1, row, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, row, v.to(cache["v"].dtype))
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths)
    return out.reshape(b, 1, h * dh) @ p["wo"]


def ffn_block(x, p, cfg: ArchConfig):
    if cfg.n_experts:
        return moe_mod.moe_ffn(x, p, cfg)
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _logits(x, lm_head):
    """(B, d) -> (B, V) float32 logits, in full float32 on the card."""
    with full_f32_matmul():
        return x.float() @ lm_head.float()


def decoder_layer(x, p, cfg: ArchConfig, positions):
    """One pre-norm layer over the whole sequence (training): attention
    (GQA, or MLA's decompressed form) and the feed-forward block (SwiGLU
    or MoE), each added to the residual stream."""
    xin = rmsnorm(x, p["ln_attn"])
    if cfg.mla:
        a = mla_mod.mla_attention(xin, p["attn"], cfg, positions)
    else:
        a, _ = gqa_attention(xin, p["attn"], cfg, positions)
    x = x + a
    return x + ffn_block(rmsnorm(x, p["ln_mlp"]), p["ffn"], cfg)


# --------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------- #

def recompute(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    instead of kept (the JAX package's ``jax.checkpoint``): autograd keeps
    only ``args``.  The recomputation runs the same operations on the same
    inputs, so the values and gradients do not change."""
    return checkpoint(fn, *args, use_reentrant=False)


def _best_group(n: int) -> int:
    """Divisor G of n minimising G + n/G (sqrt-L two-level remat)."""
    best = 1
    for g in range(1, n + 1):
        if n % g == 0 and g + n // g < best + n // best:
            best = g
    return best


def two_level_scan(layer_fn, x, stacked_params, n_layers: int):
    """sqrt(L) activation checkpointing over ``layer_fn(x, layer_params)``
    and a tree stacked over ``n_layers`` layers: an outer checkpoint per
    group of layers, an inner one per layer, nested as the JAX package
    nests ``jax.checkpoint``.  The inputs kept drop from L to G + L/G at
    the price of one more forward recomputation in the backward pass."""
    per = n_layers // _best_group(n_layers)

    def group(x, start):
        for i in range(start, start + per):
            x = recompute(layer_fn, x, _layer(stacked_params, i))
        return x

    for start in range(0, n_layers, per):
        x = recompute(group, x, start)
    return x


def backbone(params, tokens, cfg: ArchConfig, remat: bool = True):
    """tokens (B, S) -> hidden (B, S, d), after the final norm."""
    b, s = tokens.shape
    x = embed(tokens, params["embed"])
    positions = torch.arange(s, device=x.device)[None].expand(b, s)

    def layer(x, lp):
        return decoder_layer(x, lp, cfg, positions)

    if remat:
        return rmsnorm(two_level_scan(layer, x, params["layers"],
                                      cfg.n_layers), params["ln_f"])
    for i in range(cfg.n_layers):
        x = layer(x, _layer(params["layers"], i))
    return rmsnorm(x, params["ln_f"])


def _chunk_sums(h, lm_head, labels):
    """One chunk's summed negative log-likelihood over its valid labels
    and their count; the logits (B, c, V) float32, in full float32 on the
    card."""
    with full_f32_matmul():
        logits = h.float() @ lm_head.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
    valid = (labels != -1).float()
    return ((logz - gold) * valid).sum(), valid.sum()


def chunked_loss(hidden, lm_head, labels, chunk: int = 512):
    """Cross entropy against a (d, V) ``lm_head`` without the (B, S, V)
    logits: the sequence in chunks of ``chunk`` (the last padded, its
    labels -1), each chunk's body checkpointed so that autograd keeps one
    chunk's logits at a time, not every chunk's; the mean over the valid
    labels, their count clamped at 1."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s + pad, c):
        t, n = recompute(_chunk_sums, hidden[:, i:i + c], lm_head,
                     labels[:, i:i + c])
        tot, cnt = tot + t, cnt + n
    return tot / cnt.clamp_min(1.0)


def loss_fn(params, batch, cfg: ArchConfig, remat: bool = True):
    """Mean next-token cross entropy of batch["tokens"] (B, S) against
    batch["labels"] (B, S; -1 ignored), a float32 scalar."""
    hidden = backbone(params, batch["tokens"], cfg, remat)
    return chunked_loss(hidden, params["lm_head"], batch["labels"])


# --------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------- #

def cache_defs(cfg: ArchConfig, batch: int, max_len: int):
    """The cache as a ParamDef tree, stacked over layers, zeros in
    bfloat16: MLA's compressed ``c_kv`` and ``k_pe``, else GQA's ``k`` and
    ``v``."""
    if cfg.mla:
        one = {"c_kv": (batch, max_len, cfg.kv_lora_rank),
               "k_pe": (batch, max_len, cfg.qk_rope_head_dim)}
    else:
        kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        one = {"k": kv_shape, "v": kv_shape}
    return {name: pd((cfg.n_layers,) + shape, init="zeros")
            for name, shape in one.items()}


def cache_rows(cfg: ArchConfig, batch: int, max_len: int) -> int:
    """The rows prefill gives the cache of ``max_len`` positions: for GQA
    the rows the decode kernel's plan walks in place
    (``ops.decode_cache_rows``, e.g. 488 -> 512 at batch 4), so no decode
    step copies the cache to pad it; the rows past ``max_len`` stay zero
    and the lengths mask hides them.  MLA's cache is not read by the
    kernel and keeps ``max_len`` rows."""
    if cfg.mla:
        return max_len
    return ops.decode_cache_rows(max_len, cfg.head_dim,
                                 cfg.n_heads // cfg.n_kv_heads,
                                 batch * cfg.n_kv_heads, 2)


def prefill_fn(params, batch, cfg: ArchConfig, max_len: int | None = None):
    """Prompt forward.  batch["tokens"] (B, S).  Returns (last-position
    logits (B, V) float32, cache (``cache_defs``' tree of
    ``cache_rows(cfg, B, max_len)`` rows, rows past S zero))."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_len = max_len or s
    x = embed(tokens, params["embed"])
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cache = init_params(cache_defs(cfg, b, cache_rows(cfg, b, max_len)),
                        device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        xin = rmsnorm(x, lp["ln_attn"])
        if cfg.mla:
            a = mla_mod.mla_attention(xin, lp["attn"], cfg, positions)
            entries = mla_mod.mla_prefill_cache(xin, lp["attn"], cfg,
                                                positions, max_len)
            for name, entry in entries.items():
                cache[name][i] = entry
        else:
            a, (k, v) = gqa_attention(xin, lp["attn"], cfg, positions)
            cache["k"][i, :, :s] = k.to(torch.bfloat16)
            cache["v"][i, :, :s] = v.to(torch.bfloat16)
        x = x + a
        x = x + ffn_block(rmsnorm(x, lp["ln_mlp"]), lp["ffn"], cfg)
    x = rmsnorm(x[:, -1:], params["ln_f"])
    return _logits(x[:, 0], params["lm_head"]), cache


def decode_fn(params, cache, tokens, pos, cfg: ArchConfig):
    """One decode step.  tokens (B, 1); ``pos`` the position of the new
    token, a 0-d integer tensor on the model's device (the JAX package's
    ``jnp.int32`` scalar) or a Python int, converted here; every sequence
    of the batch is at the same position, as in the JAX package.  Returns
    (logits (B, V) float32, cache); the cache is the one passed in, updated
    in place at row ``pos``.  On the card each GQA layer launches the
    decode kernel once.  The body reads nothing back to the host."""
    x = embed(tokens, params["embed"])
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
    pos = pos.reshape(())
    lengths = None if cfg.mla else \
        (pos + 1).to(torch.int32).expand(tokens.shape[0]).contiguous()
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        layer_cache = {name: c[i] for name, c in cache.items()}
        xin = rmsnorm(x, lp["ln_attn"])
        if cfg.mla:
            a = mla_mod.mla_decode(xin, lp["attn"], cfg, layer_cache, pos)
        else:
            a = gqa_decode(xin, lp["attn"], cfg, layer_cache, pos, lengths)
        x = x + a
        x = x + ffn_block(rmsnorm(x, lp["ln_mlp"]), lp["ffn"], cfg)
    x = rmsnorm(x, params["ln_f"])
    return _logits(x[:, 0], params["lm_head"]), cache


def step_writes(cfg: ArchConfig, cache, pos: int) -> list:
    """The tensors a decode step at ``pos`` writes: row ``pos`` of every
    layer's cache entries (views)."""
    return [c[:, :, pos] for c in cache.values()]


def last_pos(cfg: ArchConfig, cache) -> int:
    """The last position a decode step may take: the cache's last row
    (a padding row past the caller's ``max_len`` when prefill padded the
    cache; a step there writes a row the lengths of every real step
    mask, and the graph's warm-up puts it back)."""
    return next(iter(cache.values())).shape[2] - 1
