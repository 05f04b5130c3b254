"""Pure Mamba-2 LM (mamba2-2.7b): embed -> SSD layers -> head; the training
loss, prefill and the decode step of the serving path.

Attention-free: the serve cache is the (state, conv tail) pair of every
layer, stacked over layers — ``h`` (L, B, H, P, N) float32 and ``conv``
(L, B, W-1, d_inner + 2N) bfloat16 — O(1) in sequence length.  The decode
step rewrites both whole, in place (``ssm.ssd_decode``), and reads nothing
back to the host, so ``launch.steps.graph_decode_step`` captures it.
"""
from __future__ import annotations

import torch

from repro_torch.models import ssm
from repro_torch.models.common import ArchConfig, Axes, P, pd
from repro_torch.models.layers import embed, pad_end, rmsnorm, shard
from repro_torch.models.transformer import (_layer, _logits, _stack_defs,
                                            chunked_loss, recompute,
                                            stack_layers)


def param_defs(cfg: ArchConfig, axes: Axes | None = None):
    ax = axes or Axes()
    layer = {
        "ln": pd((cfg.d_model,), P(None), init="ones"),
        "mixer": ssm.ssm_param_defs(cfg, ax),
    }
    return {
        "embed": pd((cfg.padded_vocab, cfg.d_model), P(None, ax.model),
                    scale=1.0),
        "layers": _stack_defs(layer, cfg.n_layers),
        "ln_f": pd((cfg.d_model,), P(None), init="ones"),
        "lm_head": pd((cfg.d_model, cfg.padded_vocab),
                      P(ax.data, ax.model)),
    }


def cache_defs(cfg: ArchConfig, batch: int, max_len: int,
               axes: Axes | None = None):
    """The cache as a ParamDef tree stacked over layers (``max_len`` is
    not used: the state does not grow with the sequence).  The batch over
    ("pod","data") unless it is 1, the heads and channels over "model"."""
    ax = axes or Axes()
    batch_axis = ax.batch if (axes and batch > 1) else None
    model_axis = ax.model if axes else None
    one = {
        "h": pd((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                P(batch_axis, model_axis, None, None), init="zeros",
                dtype=torch.float32),
        "conv": pd((batch, cfg.ssm_conv_width - 1,
                    cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state),
                   P(batch_axis, None, model_axis), init="zeros"),
    }
    return _stack_defs(one, cfg.n_layers)


def _pad_seq(x: torch.Tensor, chunk: int):
    """``x`` (B, S, ...) padded with zeros along S to a multiple of
    ``chunk``; returns (padded, S)."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = pad_end(x, 1, s + pad)
    return x, s


def _seq_mask(b: int, s: int, s0: int, device) -> torch.Tensor:
    """(B, S) bool: the first ``s0`` positions are real, the rest pad."""
    return (torch.arange(s, device=device) < s0)[None].expand(b, s)


def _x_spec(axes: Axes | None):
    return P(axes.batch, None, None) if axes else None


def backbone(params, tokens, cfg: ArchConfig, remat: bool = True,
             axes: Axes | None = None):
    """tokens (B, S) -> hidden (B, S, d) after the final norm (training).
    The tokens are padded to a multiple of ``ssm_chunk`` and, as in the
    JAX package, ``dt`` is not masked at the pad: the scan is causal, so
    the pad does not reach the real positions, and the hidden states are
    cut back to S.  With ``remat`` each layer is recomputed in the
    backward pass; under a mesh the residual stream is pinned batch-sharded
    after the embedding and after every layer."""
    tokens, s0 = _pad_seq(tokens, cfg.ssm_chunk)
    x = shard(embed(tokens, params["embed"]), _x_spec(axes))

    def layer(x, lp):
        return x + ssm.ssd_forward(rmsnorm(x, lp["ln"]), lp["mixer"], cfg,
                                   axes=axes)

    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x = shard(recompute(layer, x, lp) if remat else layer(x, lp),
                  _x_spec(axes))
    return rmsnorm(x, params["ln_f"])[:, :s0]


def loss_fn(params, batch, cfg: ArchConfig, axes: Axes | None = None,
            remat: bool = True):
    """Mean next-token cross entropy (``transformer.chunked_loss``)."""
    hidden = backbone(params, batch["tokens"], cfg, remat, axes)
    return chunked_loss(hidden, params["lm_head"], batch["labels"],
                        axes=axes)


def prefill_fn(params, batch, cfg: ArchConfig, axes: Axes | None = None,
               max_len: int | None = None):
    """Prompt forward.  batch["tokens"] (B, S), padded here to a multiple
    of ``ssm_chunk`` (a 480-token prompt runs as 512, ``dt`` masked at the
    pad).  Returns (last-real-position logits (B, V) float32, cache)."""
    tokens, s0 = _pad_seq(batch["tokens"], cfg.ssm_chunk)
    b, s = tokens.shape
    x = shard(embed(tokens, params["embed"]), _x_spec(axes))
    seq_mask = _seq_mask(b, s, s0, x.device)
    entries = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        y, c = ssm.ssd_forward(rmsnorm(x, lp["ln"]), lp["mixer"], cfg,
                               return_cache=True, seq_mask=seq_mask,
                               axes=axes)
        x = x + y
        entries.append(c)
    cache = stack_layers(entries, cache_defs(cfg, b, max_len or s0, axes),
                         axes)
    x = rmsnorm(x[:, s0 - 1:s0], params["ln_f"])
    return _logits(x[:, 0], params["lm_head"]), cache


def decode_fn(params, cache, tokens, pos, cfg: ArchConfig,
              axes: Axes | None = None):
    """One decode step.  tokens (B, 1); ``pos`` is not used (the state
    carries the position).  Returns (logits (B, V) float32, cache), the
    cache the one passed in, rewritten in place."""
    del pos
    x = embed(tokens, params["embed"])
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x = x + ssm.ssd_decode(rmsnorm(x, lp["ln"]), lp["mixer"], cfg,
                               _layer(cache, i), axes)
    x = rmsnorm(x, params["ln_f"])
    return _logits(x[:, 0], params["lm_head"]), cache


def step_writes(cfg: ArchConfig, cache, pos: int) -> list:
    """The tensors a decode step writes: the whole state."""
    return [cache["h"], cache["conv"]]


def last_pos(cfg: ArchConfig, cache) -> int:
    """The last position a decode step may take (any: the step ignores
    it)."""
    return 0
