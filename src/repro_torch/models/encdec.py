"""Whisper-style encoder-decoder (arXiv:2212.04356): parameters, the
encoder, the teacher-forced decoder, the training loss, prefill and the
decode step of the serving path.

The conv front end is a stub, as in the JAX package: the prefill takes
precomputed frame embeddings ``frames`` (B, S_frames, d_model).  Prefill
encodes them and primes the decoder with one BOS token (id 0, position 0);
decoding starts at position 1.

The cache is stacked over decoder layers in bfloat16: ``self_k``/``self_v``
(L, B, dec_seq, H, D), written at row ``pos`` by every step, and
``cross_k``/``cross_v`` (L, B, R, H, D), the encoder states' projections,
written once by prefill.  R is ``enc_len`` rounded up to the rows the
decode kernel's plan walks in place (``ops.decode_cache_rows``: 1500 ->
1536 for Whisper-medium at batch 4), so no step copies the cross cache to
pad it; the rows past ``enc_len`` are zero and ``cross_len`` (B,) int32,
the valid rows, masks them.  Both attentions of the decode step go
through ``ops.decode_attention`` (the hand-written decode kernel on the
card): self-attention with ``lengths = pos + 1``, cross-attention with
``cross_len``.  The JAX package computes them in ``jnp``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ArchConfig, Axes, P, pd
from repro_torch.models.layers import (embed, flash_attention, gelu_mlp,
                                       layernorm, linear, merge_last, shard,
                                       sinusoidal_positions, split_last,
                                       write_row)
from repro_torch.models.transformer import (_layer, _logits, _stack_defs,
                                            chunked_loss, decode_attend,
                                            pad_rows, recompute,
                                            stack_layers)


def _attn_defs(cfg: ArchConfig, axes: Axes):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": pd((d, h * dh), P(axes.data, axes.model)),
        "bq": pd((h * dh,), P(axes.model), init="zeros"),
        "wo": pd((h * dh, d), P(axes.model, axes.data)),
        "bo": pd((d,), P(None), init="zeros"),
        "wk": pd((d, h * dh), P(axes.data, axes.model)),
        "wv": pd((d, h * dh), P(axes.data, axes.model)),
        "bv": pd((h * dh,), P(axes.model), init="zeros"),
    }


def _ln(cfg: ArchConfig):
    return {"w": pd((cfg.d_model,), P(None), init="ones"),
            "b": pd((cfg.d_model,), P(None), init="zeros")}


def _mlp_defs(cfg: ArchConfig, axes: Axes):
    return {
        "w1": pd((cfg.d_model, cfg.d_ff), P(axes.data, axes.model)),
        "b1": pd((cfg.d_ff,), P(axes.model), init="zeros"),
        "w2": pd((cfg.d_ff, cfg.d_model), P(axes.model, axes.data)),
        "b2": pd((cfg.d_model,), P(None), init="zeros"),
    }


def _dec_layers(cfg: ArchConfig) -> int:
    return cfg.dec_layers or cfg.n_layers


def param_defs(cfg: ArchConfig, axes: Axes | None = None):
    ax = axes or Axes()
    enc_layer = {"ln1": _ln(cfg), "attn": _attn_defs(cfg, ax),
                 "ln2": _ln(cfg), "mlp": _mlp_defs(cfg, ax)}
    dec_layer = {"ln1": _ln(cfg), "self_attn": _attn_defs(cfg, ax),
                 "ln2": _ln(cfg), "cross_attn": _attn_defs(cfg, ax),
                 "ln3": _ln(cfg), "mlp": _mlp_defs(cfg, ax)}
    return {
        "enc_layers": _stack_defs(enc_layer, cfg.n_layers),
        "enc_ln_post": _ln(cfg),
        "embed": pd((cfg.padded_vocab, cfg.d_model), P(None, ax.model),
                    scale=1.0),
        "dec_layers": _stack_defs(dec_layer, _dec_layers(cfg)),
        "dec_ln_f": _ln(cfg),
        "lm_head": pd((cfg.d_model, cfg.padded_vocab), P(ax.data, ax.model)),
    }


def _norm(x, p):
    return layernorm(x, p["w"], p["b"])


def _mlp(x, p):
    return gelu_mlp(x, p["w1"], p["b1"], p["w2"], p["b2"])


def _batch_spec(axes: Axes | None, b: int):
    return axes.batch if b > 1 else None


def _heads(x, cfg: ArchConfig):
    return split_last(x, cfg.n_heads, cfg.head_dim)


def _mha(x, kv_src, p, cfg: ArchConfig, causal: bool,
         axes: Axes | None = None):
    """Full-sequence multi-head attention of ``x`` over ``kv_src``.
    Returns (out, (k, v)).  Under a mesh q, k, v are pinned with the heads
    on "model"."""
    b, s, _ = x.shape
    q = _heads(linear(x, p["wq"]) + p["bq"], cfg)
    k = _heads(linear(kv_src, p["wk"]), cfg)
    v = _heads(linear(kv_src, p["wv"]) + p["bv"], cfg)
    if axes:
        hspec = P(_batch_spec(axes, b), None, axes.model, None)
        q, k, v = shard(q, hspec), shard(k, hspec), shard(v, hspec)
    out = flash_attention(q, k, v, causal=causal)
    return linear(merge_last(out), p["wo"]) + p["bo"], (k, v)


def _enc_layer(x, lp, cfg: ArchConfig, axes: Axes | None = None):
    xin = _norm(x, lp["ln1"])
    a, _ = _mha(xin, xin, lp["attn"], cfg, causal=False, axes=axes)
    x = x + a
    return x + _mlp(_norm(x, lp["ln2"]), lp["mlp"])


def encode(params, frames, cfg: ArchConfig, remat: bool = False,
           axes: Axes | None = None):
    """frames (B, S, d) stub embeddings -> encoder states (B, S, d).  With
    ``remat`` (training) each layer is recomputed in the backward pass;
    serving runs without gradients and leaves it off."""
    s = frames.shape[1]
    x = frames + sinusoidal_positions(s, cfg.d_model, frames.device)[None] \
        .to(frames.dtype)
    if axes:
        x = shard(x, P(axes.batch, None, None))
    for i in range(cfg.n_layers):
        lp = _layer(params["enc_layers"], i)
        x = recompute(_enc_layer, x, lp, cfg, axes) if remat else \
            _enc_layer(x, lp, cfg, axes)
    return _norm(x, params["enc_ln_post"])


def _embed_at(tokens, params, pos_table):
    """Token embeddings plus their positions' rows, the positions rounded
    to bfloat16 first, as the JAX package adds them."""
    return embed(tokens, params["embed"]) + pos_table.to(torch.bfloat16)


def _dec_layer(x, lp, enc_out, cfg: ArchConfig, axes: Axes | None = None):
    xin = _norm(x, lp["ln1"])
    a, _ = _mha(xin, xin, lp["self_attn"], cfg, causal=True, axes=axes)
    x = x + a
    c, _ = _mha(_norm(x, lp["ln2"]), enc_out, lp["cross_attn"], cfg,
                causal=False, axes=axes)
    x = x + c
    return x + _mlp(_norm(x, lp["ln3"]), lp["mlp"])


def decode_train(params, enc_out, tokens, cfg: ArchConfig,
                 remat: bool = False, axes: Axes | None = None):
    """Teacher-forced decoder forward: tokens (B, T) from position 0 ->
    hidden states (B, T, d) after the final norm.  ``remat`` as in
    :func:`encode`."""
    t = tokens.shape[1]
    x = _embed_at(tokens, params,
                  sinusoidal_positions(t, cfg.d_model, tokens.device)[None])
    for i in range(_dec_layers(cfg)):
        lp = _layer(params["dec_layers"], i)
        x = recompute(_dec_layer, x, lp, enc_out, cfg, axes) if remat \
            else _dec_layer(x, lp, enc_out, cfg, axes)
    return _norm(x, params["dec_ln_f"])


def loss_fn(params, batch, cfg: ArchConfig, axes: Axes | None = None,
            remat: bool = True):
    """batch["frames"] (B, S, d) encoded, batch["tokens"] (B, T) decoded
    teacher-forced, the mean cross entropy against batch["labels"] (B, T;
    -1 ignored) by ``transformer.chunked_loss``."""
    enc_out = encode(params, batch["frames"], cfg, remat, axes)
    hidden = decode_train(params, enc_out, batch["tokens"], cfg, remat,
                          axes)
    return chunked_loss(hidden, params["lm_head"], batch["labels"],
                        axes=axes)


def cache_defs(cfg: ArchConfig, batch: int, enc_len: int,
               axes: Axes | None = None):
    """Cross K/V over the encoder states (padded to the decode kernel's
    rows), self K/V over ``dec_seq``, stacked over decoder layers; and
    ``cross_len`` (B,) int32, the cross cache's valid rows (the port's
    own leaf; it follows the batch).  The batch over ("pod","data"), the
    heads over "model", as in the JAX package; a batch of one is not
    split (the JAX package splits it, unevenly, which XLA pads; a DTensor
    split unevenly reads back from ``local_map`` as twice its rows), as
    the attention's own layout (``_batch_spec``) and the JAX package's
    SSM caches do."""
    ax = axes or Axes()
    h, dh = cfg.n_heads, cfg.head_dim
    batch_axis = _batch_spec(axes, batch) if axes else None
    spec = P(batch_axis, None, ax.model if axes else None, None)
    rows = ops.decode_cache_rows(enc_len, dh, 1, batch * h, 2)
    one = {
        "cross_k": pd((batch, rows, h, dh), spec, init="zeros"),
        "cross_v": pd((batch, rows, h, dh), spec, init="zeros"),
        "self_k": pd((batch, cfg.dec_seq, h, dh), spec, init="zeros"),
        "self_v": pd((batch, cfg.dec_seq, h, dh), spec, init="zeros"),
    }
    return {**_stack_defs(one, _dec_layers(cfg)),
            "cross_len": pd((batch,), P(batch_axis), init="zeros",
                            dtype=torch.int32)}


def prefill_fn(params, batch, cfg: ArchConfig, axes: Axes | None = None,
               max_len: int | None = None):
    """Encode batch["frames"] (B, S, d); prime the decoder with one BOS
    token.  Returns (its logits (B, V) float32, cache).  ``max_len`` is
    not used: the self cache holds ``dec_seq`` rows."""
    frames = batch["frames"]
    enc_out = encode(params, frames, cfg, axes=axes)
    b, enc_len = frames.shape[:2]
    bos = torch.zeros_like(frames[:, :1, 0], dtype=torch.long)
    x = _embed_at(bos, params,
                  sinusoidal_positions(1, cfg.d_model, frames.device)[None])
    defs = cache_defs(cfg, b, enc_len, axes)
    rows = defs["cross_k"].shape[2]
    entries = []
    for i in range(_dec_layers(cfg)):
        lp = _layer(params["dec_layers"], i)
        xin = _norm(x, lp["ln1"])
        a, (sk, sv) = _mha(xin, xin, lp["self_attn"], cfg, causal=True,
                           axes=axes)
        x = x + a
        c, (ck, cv) = _mha(_norm(x, lp["ln2"]), enc_out, lp["cross_attn"],
                           cfg, causal=False, axes=axes)
        x = x + c
        x = x + _mlp(_norm(x, lp["ln3"]), lp["mlp"])
        entries.append({"cross_k": pad_rows(ck, rows),
                        "cross_v": pad_rows(cv, rows),
                        "self_k": pad_rows(sk, cfg.dec_seq),
                        "self_v": pad_rows(sv, cfg.dec_seq)})
    cache = stack_layers(entries, {name: d for name, d in defs.items()
                                   if name != "cross_len"}, axes)
    cache["cross_len"] = torch.full_like(frames[:, 0, 0], enc_len,
                                         dtype=torch.int32)
    x = _norm(x, params["dec_ln_f"])
    return _logits(x[:, 0], params["lm_head"]), cache


def decode_fn(params, cache, tokens, pos, cfg: ArchConfig,
              axes: Axes | None = None):
    """One decoder token.  tokens (B, 1); ``pos`` its position (>= 1), a
    0-d integer tensor on the model's device or a Python int.  Writes row
    ``pos`` of every layer's self K/V in place, attends over it through
    the decode kernel, then over the cross cache.  Returns (logits (B, V)
    float32, cache).  On the card each layer launches the decode kernel
    twice.  The body reads nothing back to the host: the position's row
    of the sinusoid table is taken by device index."""
    b = tokens.shape[0]
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32, device=tokens.device)
    pos = pos.reshape(())
    row = pos.reshape(1).long()
    table = sinusoidal_positions(cfg.dec_seq, cfg.d_model, tokens.device)
    x = _embed_at(tokens, params, table.index_select(0, row)[None])
    lengths = (pos + 1).to(torch.int32).expand(b).contiguous()
    for i in range(_dec_layers(cfg)):
        lp = _layer(params["dec_layers"], i)
        sa, ca = lp["self_attn"], lp["cross_attn"]
        self_k, self_v = cache["self_k"][i], cache["self_v"][i]
        xin = _norm(x, lp["ln1"])
        q = _heads(xin @ sa["wq"] + sa["bq"], cfg)
        write_row(self_k, pos, _heads(xin @ sa["wk"], cfg))
        write_row(self_v, pos, _heads(xin @ sa["wv"] + sa["bv"], cfg))
        a = decode_attend(q[:, 0], self_k, self_v, lengths)
        x = x + (a.reshape(b, 1, -1) @ sa["wo"] + sa["bo"])
        q2 = _heads(_norm(x, lp["ln2"]) @ ca["wq"] + ca["bq"], cfg)
        c = decode_attend(q2[:, 0], cache["cross_k"][i],
                          cache["cross_v"][i], cache["cross_len"])
        x = x + (c.reshape(b, 1, -1) @ ca["wo"] + ca["bo"])
        x = x + _mlp(_norm(x, lp["ln3"]), lp["mlp"])
    x = _norm(x, params["dec_ln_f"])
    return _logits(x[:, 0], params["lm_head"]), cache


def step_writes(cfg: ArchConfig, cache, pos: int) -> list:
    """The tensors a decode step at ``pos`` writes: row ``pos`` of every
    layer's self K and V (views); the cross cache is read only."""
    return [cache[name][:, :, pos] for name in ("self_k", "self_v")]


def last_pos(cfg: ArchConfig, cache) -> int:
    """The last position a decode step may take: ``dec_seq - 1``."""
    return cfg.dec_seq - 1
