"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Two forms, as in the JAX package:

* prefill: the latent is decompressed to full per-head K and V, and
  ``layers.flash_attention`` runs over them (its value width, ``v_head_dim``,
  differs from the key's, ``qk_nope_head_dim + qk_rope_head_dim``);
* decode: the *absorbed* form.  The query is pulled into the latent space
  (``q_nope @ W_UK``), attention runs against the compressed cache itself
  (``c_kv`` of ``kv_lora_rank`` and the roped ``k_pe`` per token), and the
  context is expanded back with ``W_UV``.  The einsums are float32, full
  precision on the card (TF32 off), as the JAX package writes them.

The JAX package computes this attention in ``jnp``, not through its decode
kernel: the latent "head" is one head whose key is ``kv_lora_rank +
qk_rope_head_dim`` wide (576 for DeepSeek-V2) and whose value is
``kv_lora_rank`` (512).  The port does the same in plain PyTorch, so the
decode kernel is not on this path.

``mla_decode`` takes ``pos`` as a 0-d integer tensor on the model's device,
writes the new cache row by device index and masks with ``arange(S) <=
pos`` built on the device: no value comes back to the host, so the step can
be captured in a CUDA graph.  The cache is updated in place (the JAX
package returns an updated copy).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig, Axes, P, pd
from repro_torch.models.layers import (apply_rope, flash_attention,
                                       full_f32_matmul, linear, merge_last,
                                       pad_end, rmsnorm, shard, split_last,
                                       write_row)

_NEG = -1e30


def mla_param_defs(cfg: ArchConfig, axes: Axes):
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "wq_a": pd((d, cfg.q_lora_rank), P(axes.data, None)),
        "q_norm": pd((cfg.q_lora_rank,), P(None), init="ones"),
        "wq_b": pd((cfg.q_lora_rank, h * qk), P(axes.data, axes.model)),
        "wkv_a": pd((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                    P(axes.data, None)),
        "kv_norm": pd((cfg.kv_lora_rank,), P(None), init="ones"),
        "wkv_b": pd((cfg.kv_lora_rank,
                     h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                    P(axes.data, axes.model)),
        "wo": pd((h * cfg.v_head_dim, d), P(axes.model, axes.data)),
    }


def _project_q(x, p, cfg: ArchConfig, positions):
    """x (B,S,d) -> q_nope (B,S,H,nope), q_pe (B,S,H,rope)."""
    b, s, _ = x.shape
    cq = rmsnorm(linear(x, p["wq_a"]), p["q_norm"])
    q = split_last(linear(cq, p["wq_b"]), cfg.n_heads,
                   cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                           dim=-1)
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def _latent(x, p, cfg: ArchConfig, positions):
    """x (B,S,d) -> the compressed entries: c_kv (B,S,lora) before its
    norm, roped k_pe (B,S,1,rope) on a head axis of 1."""
    c_kv, k_pe = linear(x, p["wkv_a"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    return c_kv, apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)


def mla_attention(x, p, cfg: ArchConfig, positions,
                  axes: Axes | None = None) -> torch.Tensor:
    """Train / prefill form: decompressed K/V and causal flash attention.
    x (B,S,d) -> (B,S,d).  Under a mesh the decompressed K/V (the big MLA
    prefill tensor) is pinned head-sharded on its flat (H * (nope+v)) dim
    before the reshape, and q, k, v heads on "model"."""
    b, s, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_pe = _project_q(x, p, cfg, positions)
    c_kv, k_pe = _latent(x, p, cfg, positions)
    kv = linear(rmsnorm(c_kv, p["kv_norm"]), p["wkv_b"])
    if axes:
        kv = shard(kv, P(axes.batch, None, axes.model))
    kv = split_last(kv, h, nope + cfg.v_head_dim)
    k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, s, h, rope)], dim=-1)
    if axes:
        hspec = P(axes.batch, None, axes.model, None)
        q, k, v = shard(q, hspec), shard(k, hspec), shard(v, hspec)
    out = flash_attention(q, k, v, causal=True)            # (B,S,H,v_dim)
    return linear(merge_last(out), p["wo"])


def mla_init_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, *,
                   device: str | torch.device = "cuda"):
    """One layer's empty compressed cache: c_kv (B,S,lora) and the roped
    k_pe (B,S,rope)."""
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                            dtype=dtype, device=device),
    }


def mla_cache_specs(cfg: ArchConfig, axes: Axes, shard_seq: bool):
    """One layer's cache specs: the batch over ("pod","data"), or with
    ``shard_seq`` the sequence over "model" and the batch not split."""
    seq = axes.model if shard_seq else None
    spec = P(axes.batch if not shard_seq else None, seq, None)
    return {"c_kv": spec, "k_pe": spec}


def mla_prefill_cache(x, p, cfg: ArchConfig, positions, max_len: int):
    """The compressed cache entries of a prompt, zero-padded to
    ``max_len`` rows, bfloat16: c_kv (B,max_len,lora), k_pe
    (B,max_len,rope)."""
    c_kv, k_pe = _latent(x, p, cfg, positions)
    return {"c_kv": pad_end(rmsnorm(c_kv, p["kv_norm"]), 1, max_len)
            .to(torch.bfloat16),
            "k_pe": pad_end(k_pe[:, :, 0], 1, max_len).to(torch.bfloat16)}


def mla_decode(x, p, cfg: ArchConfig, cache: dict, pos: torch.Tensor
               ) -> torch.Tensor:
    """Absorbed one-token decode against the compressed cache.

    x (B,1,d); cache c_kv (B,S,lora) and k_pe (B,S,rope), written IN PLACE
    at row ``pos``; pos a 0-d integer tensor on x's device.  Returns
    (B,1,d)."""
    b = x.shape[0]
    h = cfg.n_heads
    nope, rope, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    positions = pos.expand(b, 1)
    q_nope, q_pe = _project_q(x, p, cfg, positions)
    q_nope, q_pe = q_nope[:, 0], q_pe[:, 0]                # (B,H,*)

    c_new, kpe_new = _latent(x, p, cfg, positions)         # (B,1,*)
    write_row(cache["c_kv"], pos, rmsnorm(c_new, p["kv_norm"]))
    write_row(cache["k_pe"], pos, kpe_new[:, :, 0])

    w_kv_b = p["wkv_b"].reshape(cfg.kv_lora_rank, h, nope + dv)
    w_uk = w_kv_b[:, :, :nope].float()                    # (lora, H, nope)
    w_uv = w_kv_b[:, :, nope:].float()                    # (lora, H, dv)
    c_kv = cache["c_kv"].float()
    with full_f32_matmul():
        q_lat = torch.einsum("bhn,lhn->bhl", q_nope.float(), w_uk)
        s_lat = torch.einsum("bhl,bsl->bhs", q_lat, c_kv)
        s_pe = torch.einsum("bhr,bsr->bhs", q_pe.float(),
                            cache["k_pe"].float())
        scores = (s_lat + s_pe) * (nope + rope) ** -0.5    # (B,H,S)
        valid = torch.arange(scores.shape[-1], device=x.device) <= pos
        scores = scores.masked_fill(~valid, _NEG)
        pr = torch.softmax(scores, dim=-1)
        ctx_lat = torch.einsum("bhs,bsl->bhl", pr, c_kv)
        ctx = torch.einsum("bhl,lhv->bhv", ctx_lat, w_uv)
    out = ctx.reshape(b, 1, h * dv).to(x.dtype)
    return out @ p["wo"]
