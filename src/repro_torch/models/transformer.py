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

Distribution, the JAX package's (``axes`` given, parameters, inputs and
cache DTensors on the mesh ``launch.mesh.enter_mesh`` made ambient):
every 2-D weight is stored P(data, model) — "model" carries the TP dim,
"data" is ZeRO/FSDP storage sharding that DTensor gathers at use; the
activations are pinned per policy (``layers.shard``): "tp" puts the batch
on ("pod","data") and heads / d_ff on "model"; "spfsdp" (odd head counts:
Qwen) the sequence on "model".
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (ArchConfig, Axes, P, map_defs, pd,
                                       param_specs)
from repro_torch.models.layers import (apply_rope, embed, flash_attention,
                                       full_f32_matmul, gold_logits,
                                       linear, logsumexp, merge_last, pad_end,
                                       repeat_kv, rmsnorm, seq_split, shard,
                                       split_last, swiglu, write_row)


# --------------------------------------------------------------------- #
# Parameter definitions
# --------------------------------------------------------------------- #

def attn_param_defs(cfg: ArchConfig, axes: Axes):
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": pd((d, h * dh), P(axes.data, axes.model)),
        "wk": pd((d, hk * dh), P(axes.data, axes.model)),
        "wv": pd((d, hk * dh), P(axes.data, axes.model)),
        "wo": pd((h * dh, d), P(axes.model, axes.data)),
    }
    if cfg.qkv_bias:
        defs.update({
            "bq": pd((h * dh,), P(axes.model), init="zeros"),
            "bk": pd((hk * dh,), P(axes.model), init="zeros"),
            "bv": pd((hk * dh,), P(axes.model), init="zeros"),
        })
    if cfg.qk_norm:
        defs.update({
            "q_norm": pd((dh,), P(None), init="ones"),
            "k_norm": pd((dh,), P(None), init="ones"),
        })
    return defs


def mlp_param_defs(cfg: ArchConfig, axes: Axes):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": pd((d, f), P(axes.data, axes.model)),
        "w_up": pd((d, f), P(axes.data, axes.model)),
        "w_down": pd((f, d), P(axes.model, axes.data)),
    }


def layer_param_defs(cfg: ArchConfig, axes: Axes):
    return {
        "ln_attn": pd((cfg.d_model,), P(None), init="ones"),
        "ln_mlp": pd((cfg.d_model,), P(None), init="ones"),
        "attn": (mla_mod.mla_param_defs(cfg, axes) if cfg.mla
                 else attn_param_defs(cfg, axes)),
        "ffn": (moe_mod.moe_param_defs(cfg, axes) if cfg.n_experts
                else mlp_param_defs(cfg, axes)),
    }


def _stack_defs(defs, n: int):
    """``defs`` stacked over ``n`` layers: a leading dim of ``n``, not
    split."""
    return map_defs(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, spec=P(None, *d.spec)), defs)


def param_defs(cfg: ArchConfig, axes: Axes | None = None):
    ax = axes or Axes()
    v, d = cfg.padded_vocab, cfg.d_model
    return {
        "embed": pd((v, d), P(None, ax.model), scale=1.0),
        "layers": _stack_defs(layer_param_defs(cfg, ax), cfg.n_layers),
        "ln_f": pd((d,), P(None), init="ones"),
        "lm_head": pd((d, v), P(ax.data, ax.model)),
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
    q = linear(x, p["wq"])
    k = linear(x, p["wk"])
    v = linear(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_last(q, h, dh)
    k = split_last(k, hk, dh)
    v = split_last(v, hk, dh)
    if cfg.qk_norm:
        q, k = rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])
    return q, k, v


def gqa_attention(x, p, cfg: ArchConfig, positions, q_offset: int = 0,
                  axes: Axes | None = None):
    """Full-sequence GQA attention (train / prefill).  Returns the block's
    output and the un-repeated (k, v) for the cache.  Under a mesh, policy
    "tp" pins the heads on "model"; "spfsdp" (odd head counts) the
    sequence of q, and inside the attention the rows of each query chunk,
    each device's rows against the whole K/V, batch-sharded and
    replicated over "model"."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(x, p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kr, vr = repeat_kv(k, h // hk), repeat_kv(v, h // hk)
    q_spec = kv_spec = None
    if axes and cfg.policy == "tp":
        q_spec = kv_spec = P(axes.batch, None, axes.model, None)
    elif axes:                                   # spfsdp: sequence parallel
        q_spec = P(axes.batch, axes.model, None, None)
        kv_spec = P(axes.batch, None, None, None)
    out = flash_attention(q, kr, vr, causal=cfg.causal, q_offset=q_offset,
                          q_spec=q_spec, kv_spec=kv_spec)
    return linear(merge_last(out), p["wo"]), (k, v)


def _seq_split_attend(q, k_cache, v_cache, lengths, q_pl, len_pl):
    """Decode attention over a cache whose sequence (dim 1) is split over
    devices: each device runs the split kernel over its own rows
    (``ops.decode_partials``, the lengths counted from its first row),
    the partials ``(acc, m, l)`` are gathered along their splits dim over
    the mesh dims that split the sequence, and the combine kernel weighs
    them by ``exp(m - max m)`` (``ops.decode_combine``): the whole softmax,
    as one device's pair computes it.  Returns q's placements with the
    sequence's mesh dims replicated."""
    mesh, cache_pl = k_cache.device_mesh, tuple(k_cache.placements)
    rows = k_cache.shape[1]          # the largest shard's: chunks of ceil
    for i, pl in enumerate(cache_pl):
        if pl == Shard(1):
            rows = -(-rows // mesh.size(i))
    _, offset = compute_local_shape_and_global_offset(
        k_cache.shape, mesh, cache_pl)
    kl, vl = k_cache.to_local(), v_cache.to_local()
    ql = q.redistribute(mesh, q_pl).to_local()
    ll = lengths.redistribute(mesh, len_pl).to_local()
    ll = (ll - offset[1]).clamp(0, kl.shape[1]).to(torch.int32)
    part = ops.decode_partials(ql, kl, vl, ll, rows=rows)
    # the workspace (B, H_kv, splits, G, D + 2): batch, KV heads and the
    # shards' ranges side by side along the splits, gathered over the
    # sequence's mesh dims (every shard planned the same splits)
    part_of = {Shard(0): Shard(0), Shard(2): Shard(1), Shard(1): Shard(2)}
    part_pl = [part_of.get(pl, Replicate()) for pl in cache_pl]
    part = DTensor.from_local(part, mesh, part_pl, run_check=False)
    part = part.redistribute(mesh, [Replicate() if pl == Shard(2) else pl
                                    for pl in part_pl]).to_local()
    out = ops.decode_combine(part, ql.dtype)
    return DTensor.from_local(out, mesh, q_pl, run_check=False,
                              shape=q.shape,
                              stride=torch.empty(q.shape, device="meta")
                              .stride())


def decode_attend(q, k_cache, v_cache, lengths, scale: float | None = None):
    """Single-query GQA attention over a cache as stored: q (B, H, D),
    caches (B, S, H_kv, D), ``lengths`` (B,) int32, the scores scaled by
    ``scale`` (None: ``D ** -0.5``; another only where the cache's
    sequence is whole).  Plain tensors go through ``ops.decode_attention``
    (the hand-written kernel pair on the card).  On DTensors the kernels run on each device's shard: batch and
    KV heads split alike in q, the caches and the lengths
    (``local_map``), and where the cache's sequence is split (the JAX
    package's cache specs for KV head counts that "model" does not
    divide, and for a batch of one) each device's partial softmax goes to
    the combine kernel beside the others' (:func:`_seq_split_attend`)."""
    attend = ops.decode_attention if scale is None else \
        functools.partial(ops.decode_attention, scale=scale)
    if not isinstance(k_cache, DTensor):
        return attend(q, k_cache, v_cache, lengths)
    mesh, cache_pl = k_cache.device_mesh, tuple(k_cache.placements)
    q_pl = tuple(Shard(0) if pl == Shard(0) else
                 Shard(1) if pl == Shard(2) else Replicate()
                 for pl in cache_pl)
    len_pl = tuple(Shard(0) if pl == Shard(0) else Replicate()
                   for pl in cache_pl)
    if not isinstance(lengths, DTensor):
        lengths = DTensor.from_local(lengths, mesh,
                                     [Replicate()] * mesh.ndim)
    if seq_split(k_cache):
        if scale is not None:
            raise ValueError("a cache split along its sequence attends at "
                             "D ** -0.5 only")
        return _seq_split_attend(q, k_cache, v_cache, lengths, q_pl, len_pl)
    return local_map(attend, out_placements=(q_pl,),
                     in_placements=(q_pl, cache_pl, cache_pl, len_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k_cache, v_cache, lengths)


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
    write_row(cache["k"], pos, k)
    write_row(cache["v"], pos, v)
    out = decode_attend(q[:, 0], cache["k"], cache["v"], lengths)
    return out.reshape(b, 1, h * dh) @ p["wo"]


def ffn_block(x, p, cfg: ArchConfig, axes: Axes | None = None):
    if cfg.n_experts:
        return moe_mod.moe_ffn(x, p, cfg, axes)
    if axes is None:
        ff_spec = None
    elif cfg.policy == "tp":
        ff_spec = P(axes.batch, None, axes.model)      # d_ff on model
    else:                                              # spfsdp: seq on model
        ff_spec = P(axes.batch, axes.model, None)
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"], ff_spec)


def _logits(x, lm_head):
    """(B, d) -> (B, V) float32 logits, in full float32 on the card."""
    with full_f32_matmul():
        return x.float() @ lm_head.float()


def _x_spec(cfg: ArchConfig, axes: Axes | None):
    """The residual stream's spec: batch on ("pod","data"), and for
    spfsdp the sequence on "model" too."""
    if axes is None:
        return None
    if cfg.policy == "spfsdp":
        return P(axes.batch, axes.model, None)
    return P(axes.batch, None, None)


def decoder_layer(x, p, cfg: ArchConfig, positions, axes: Axes | None = None):
    """One pre-norm layer over the whole sequence (training): attention
    (GQA, or MLA's decompressed form) and the feed-forward block (SwiGLU
    or MoE), each added to the residual stream, which a mesh keeps pinned
    (spfsdp: sequence on "model" — without it the FFN and attention
    compute would replicate over the model axis)."""
    xspec = _x_spec(cfg, axes)
    xin = rmsnorm(x, p["ln_attn"])
    if cfg.mla:
        a = mla_mod.mla_attention(xin, p["attn"], cfg, positions, axes)
    else:
        a, _ = gqa_attention(xin, p["attn"], cfg, positions, axes=axes)
    x = shard(x + a, xspec)
    return shard(x + ffn_block(rmsnorm(x, p["ln_mlp"]), p["ffn"], cfg, axes),
                 xspec)


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


def two_level_scan(layer_fn, x, stacked_params, n_layers: int,
                   constrain=None):
    """sqrt(L) activation checkpointing over ``layer_fn(x, layer_params)``
    and a tree stacked over ``n_layers`` layers: an outer checkpoint per
    group of layers, an inner one per layer, nested as the JAX package
    nests ``jax.checkpoint``; ``constrain`` is applied to each layer's
    output.  The inputs kept drop from L to G + L/G at the price of one
    more forward recomputation in the backward pass."""
    per = n_layers // _best_group(n_layers)

    def group(x, start):
        for i in range(start, start + per):
            x = recompute(layer_fn, x, _layer(stacked_params, i))
            if constrain is not None:
                x = constrain(x)
        return x

    for start in range(0, n_layers, per):
        x = recompute(group, x, start)
    return x


def backbone(params, tokens, cfg: ArchConfig, remat: bool = True,
             axes: Axes | None = None):
    """tokens (B, S) -> hidden (B, S, d), after the final norm."""
    b, s = tokens.shape
    xspec = _x_spec(cfg, axes)
    x = shard(embed(tokens, params["embed"]), xspec)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)

    def layer(x, lp):
        return decoder_layer(x, lp, cfg, positions, axes)

    def constrain(y):
        return shard(y, xspec)

    if remat:
        return rmsnorm(two_level_scan(layer, x, params["layers"],
                                      cfg.n_layers, constrain),
                       params["ln_f"])
    for i in range(cfg.n_layers):
        x = constrain(layer(x, _layer(params["layers"], i)))
    return rmsnorm(x, params["ln_f"])


def _chunk_sums(h, lm_head, labels):
    """One chunk's summed negative log-likelihood over its valid labels
    and their count; the logits (B, c, V) float32, in full float32 on the
    card."""
    with full_f32_matmul():
        logits = h.float() @ lm_head.float()
    logz = logsumexp(logits)
    gold = gold_logits(logits, labels)
    valid = (labels != -1).float()
    return ((logz - gold) * valid).sum(), valid.sum()


def chunked_loss(hidden, lm_head, labels, chunk: int = 512,
                 axes: Axes | None = None):
    """Cross entropy against a (d, V) ``lm_head`` without the (B, S, V)
    logits: the sequence in chunks of ``chunk`` (the last padded, its
    labels -1), each chunk's body checkpointed so that autograd keeps one
    chunk's logits at a time, not every chunk's; the mean over the valid
    labels, their count clamped at 1.  Under a mesh ``lm_head`` is
    gathered over "data" once (its vocabulary stays on "model"), so each
    device takes the logits of its own rows; left to itself DTensor splits
    the product's contraction over "data" and sums every row's partial
    logits over the devices instead (2 GB a chunk at train_4k)."""
    if axes is not None:
        lm_head = shard(lm_head, P(None, axes.model))
        # a row's logits are split over "model" by the vocabulary, so the
        # rows are whole there (spfsdp splits the sequence over it)
        hidden = shard(hidden, P(axes.batch, None, None))
    b, s, _ = hidden.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        hidden = pad_end(hidden, 1, s + pad)
        labels = pad_end(labels, 1, s + pad, value=-1)
    sums = [recompute(_chunk_sums, hidden[:, i:i + c], lm_head,
                      labels[:, i:i + c]) for i in range(0, s + pad, c)]
    tot, cnt = sums[0]
    for t, n in sums[1:]:
        tot, cnt = tot + t, cnt + n
    return tot / cnt.clamp_min(1.0)


def loss_fn(params, batch, cfg: ArchConfig, axes: Axes | None = None,
            remat: bool = True):
    """Mean next-token cross entropy of batch["tokens"] (B, S) against
    batch["labels"] (B, S; -1 ignored), a float32 scalar."""
    hidden = backbone(params, batch["tokens"], cfg, remat, axes)
    return chunked_loss(hidden, params["lm_head"], batch["labels"],
                        axes=axes)


# --------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------- #

def cache_defs(cfg: ArchConfig, batch: int, max_len: int,
               axes: Axes | None = None):
    """The cache as a ParamDef tree, stacked over layers, zeros in
    bfloat16: MLA's compressed ``c_kv`` and ``k_pe``, else GQA's ``k`` and
    ``v``.

    Sharding, the JAX package's: batch over ("pod","data"); the second
    cache dim over "model" — heads when the KV head count divides the axis,
    otherwise the cache *sequence* (GQA kv=4/8 archs; decode attention then
    runs a distributed softmax over the sequence shards).  batch==1
    (long_500k) shards the sequence over "data" instead.  MLA's latent has
    no head dim: its sequence goes on "model"."""
    ax = axes or Axes()
    seq_axis = None
    batch_axis = ax.batch if axes else None
    head_axis = None
    if axes:
        if batch == 1:                # long_500k: no batch to shard
            batch_axis, seq_axis = None, ax.data
        elif cfg.n_kv_heads and cfg.n_kv_heads % 16 == 0:
            head_axis = ax.model
        else:
            seq_axis = ax.model
    if cfg.mla:
        mla_seq = seq_axis if seq_axis else (ax.model if axes else None)
        spec = P(batch_axis, mla_seq, None)
        one = {"c_kv": pd((batch, max_len, cfg.kv_lora_rank), spec,
                          init="zeros"),
               "k_pe": pd((batch, max_len, cfg.qk_rope_head_dim), spec,
                          init="zeros")}
    else:
        kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        spec = P(batch_axis, seq_axis, head_axis, None)
        one = {"k": pd(kv_shape, spec, init="zeros"),
               "v": pd(kv_shape, spec, init="zeros")}
    return _stack_defs(one, cfg.n_layers)


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


def pad_rows(x, rows: int):
    """``x`` (B, s, ...) zero-padded along dim 1 to ``rows`` rows."""
    return pad_end(x, 1, rows)


def stack_layers(entries: list, defs, axes: Axes | None):
    """Per-layer cache entries (dicts of tensors of one layer's shape) ->
    the cache tree ``defs`` describes, stacked over layers in its dtypes.
    Under a mesh each layer's entry is pinned to its spec (the stacked
    spec without the layer dim) and the stack to the stacked spec, the
    JAX package's pins of the prefill's cache."""
    specs = param_specs(defs)
    out = {}
    for name, d in defs.items():
        spec = specs[name] if axes else None
        layer_spec = P(*spec[1:]) if spec is not None else None
        out[name] = shard(torch.stack([shard(e[name].to(d.dtype), layer_spec)
                                       for e in entries]), spec)
    return out


def prefill_fn(params, batch, cfg: ArchConfig, axes: Axes | None = None,
               max_len: int | None = None):
    """Prompt forward.  batch["tokens"] (B, S).  Returns (last-position
    logits (B, V) float32, cache (``cache_defs``' tree of
    ``cache_rows(cfg, B, max_len)`` rows, rows past S zero))."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_len = max_len or s
    rows = cache_rows(cfg, b, max_len)
    xspec = _x_spec(cfg, axes)
    x = shard(embed(tokens, params["embed"]), xspec)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    entries = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        xin = rmsnorm(x, lp["ln_attn"])
        if cfg.mla:
            a = mla_mod.mla_attention(xin, lp["attn"], cfg, positions, axes)
            entries.append(mla_mod.mla_prefill_cache(xin, lp["attn"], cfg,
                                                     positions, max_len))
        else:
            a, (k, v) = gqa_attention(xin, lp["attn"], cfg, positions,
                                      axes=axes)
            entries.append({"k": pad_rows(k, rows), "v": pad_rows(v, rows)})
        x = x + a
        x = x + ffn_block(rmsnorm(x, lp["ln_mlp"]), lp["ffn"], cfg, axes)
        x = shard(x, xspec)
    cache = stack_layers(entries, cache_defs(cfg, b, rows, axes), axes)
    x = rmsnorm(x[:, -1:], params["ln_f"])
    return _logits(x[:, 0], params["lm_head"]), cache


def decode_fn(params, cache, tokens, pos, cfg: ArchConfig,
              axes: Axes | None = None):
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
        x = x + ffn_block(rmsnorm(x, lp["ln_mlp"]), lp["ffn"], cfg, axes)
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
