"""Analytic MODEL_FLOPS per (arch x cell) — the "useful work" reference for
the §Roofline ratio MODEL_FLOPS / HLO_FLOPs.

Conventions (documented in EXPERIMENTS.md):
  * parameter flops: 6·N·D for training (fwd 2 + bwd 4; remat recompute is
    deliberately NOT included — it is waste the ratio should expose),
    2·N·D for forward-only (prefill/decode);
  * N counts matmul-visible parameters (embedding gather excluded, LM head
    included, MoE experts counted at top_k + shared activation);
  * attention flops: 4·S²·H·dh per layer per sequence (QK^T + PV, full
    square — our flash computes the full square), x3 for training;
  * SSD flops: intra-chunk quadratic + state terms per the ssm.py einsums.
"""
from __future__ import annotations

from repro_torch.models.common import ArchConfig, ShapeCell
from repro_torch.models.registry import ModelApi


def _dense_layer_params(cfg: ArchConfig) -> int:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.family in ("ssm", "hybrid"):
        # backbone layers are pure SSD mixers (zamba's attention/MLP live
        # only in the shared block, added separately)
        di, n, hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        return d * (2 * di + 2 * n + hs) + di * d
    if cfg.mla:
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        attn = (cfg.d_model * cfg.q_lora_rank
                + cfg.q_lora_rank * h * qk
                + cfg.d_model * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                + cfg.kv_lora_rank * h * (cfg.qk_nope_head_dim
                                          + cfg.v_head_dim)
                + h * cfg.v_head_dim * d)
    elif h:
        attn = d * h * dh + 2 * d * hk * dh + h * dh * d
    else:
        attn = 0
    if cfg.n_experts:
        ffn_active = 3 * d * cfg.d_ff * (cfg.top_k + cfg.n_shared_experts)
    elif cfg.d_ff:
        mult = 2 if cfg.family == "audio" else 3      # gelu vs swiglu
        ffn_active = mult * d * cfg.d_ff
    else:
        ffn_active = 0
    return attn + ffn_active


def active_param_flops_per_token(cfg: ArchConfig) -> int:
    """2·N_active: matmul params touched per token, times 2."""
    per_layer = _dense_layer_params(cfg)
    n = cfg.n_layers * per_layer
    if cfg.family == "audio":
        # decoder layers add cross-attention (q + o over d, k/v over d)
        n += (cfg.dec_layers or cfg.n_layers) * (
            _dense_layer_params(cfg)
            + 4 * cfg.d_model * cfg.n_heads * cfg.head_dim)
    if cfg.family == "hybrid":
        d = cfg.d_model
        shared = (2 * d * d + d * cfg.n_heads * cfg.head_dim
                  + 2 * d * cfg.n_kv_heads * cfg.head_dim
                  + cfg.n_heads * cfg.head_dim * d + 3 * d * cfg.d_ff)
        n += (cfg.n_layers // cfg.attn_every) * shared
    n += cfg.d_model * cfg.padded_vocab          # lm head
    return 2 * n


def _attn_flops_fwd(cfg: ArchConfig, s: int, kv_len: int | None = None
                    ) -> int:
    """Per sequence, all layers: QK^T + PV (full square / full cache)."""
    kv_len = kv_len or s
    if cfg.family == "ssm":
        # SSD: scores 2·nc·Q²·N + intra 2·nc·Q²·H·P + states/out terms
        q = cfg.ssm_chunk
        nc = max(1, s // q)
        n, h, p = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        per_layer = nc * (2 * q * q * n + 2 * q * q * h * p
                          + 4 * q * h * p * n)
        return cfg.n_layers * per_layer
    total = 0
    if cfg.n_heads:
        dh_qk = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) if cfg.mla \
            else cfg.head_dim
        dh_v = cfg.v_head_dim if cfg.mla else cfg.head_dim
        per_layer = 2 * s * kv_len * cfg.n_heads * (dh_qk + dh_v)
        if cfg.family == "hybrid":
            total += (cfg.n_layers // cfg.attn_every) * per_layer
            # plus the SSD backbone
            ssm_cfg = cfg
            q = cfg.ssm_chunk
            nc = max(1, s // q)
            n, h, p = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
            total += cfg.n_layers * nc * (2 * q * q * n + 2 * q * q * h * p
                                          + 4 * q * h * p * n)
        elif cfg.family == "audio":
            total += cfg.n_layers * per_layer                    # encoder
            dec = cfg.dec_layers or cfg.n_layers
            t = cfg.dec_seq
            total += dec * 2 * t * t * cfg.n_heads * 2 * cfg.head_dim
            total += dec * 2 * t * kv_len * cfg.n_heads * 2 * cfg.head_dim
        else:
            total += cfg.n_layers * per_layer
    return total


def _audio_parts(cfg: ArchConfig):
    enc_params = cfg.n_layers * _dense_layer_params(cfg)
    dec_l = cfg.dec_layers or cfg.n_layers
    dec_params = dec_l * (_dense_layer_params(cfg)
                          + 4 * cfg.d_model * cfg.n_heads * cfg.head_dim) \
        + cfg.d_model * cfg.padded_vocab
    return enc_params, dec_params, dec_l


def model_flops(api: ModelApi, cell: ShapeCell) -> float:
    """Useful FLOPs per executed step, whole job (all devices)."""
    cfg = api.cfg
    b, s = cell.global_batch, cell.seq_len
    pf = active_param_flops_per_token(cfg)
    hdh = cfg.n_heads * (cfg.head_dim or 0)
    if cfg.family == "audio":
        enc_p, dec_p, dec_l = _audio_parts(cfg)
        t = cfg.dec_seq
        enc_fwd = (2 * enc_p * s + cfg.n_layers * 4 * s * s * hdh) * b
        if cell.kind == "train":
            dec_fwd = (2 * dec_p * t
                       + dec_l * (4 * t * t * hdh + 4 * t * s * hdh)) * b
            return 3 * (enc_fwd + dec_fwd)
        if cell.kind == "prefill":     # encode + 1 BOS decoder token
            return enc_fwd + (2 * dec_p + dec_l * 4 * s * hdh) * b
        # decode: 1 token, self cache dec_seq + cross cache s
        return (2 * dec_p + dec_l * (4 * t * hdh + 4 * s * hdh)) * b
    if cell.kind == "train":
        return 3 * pf * b * s + 3 * _attn_flops_fwd(cfg, s) * b
    if cell.kind == "prefill":
        return pf * b * s + _attn_flops_fwd(cfg, s) * b
    # decode: one token, cache length s
    if cfg.family in ("ssm", "hybrid"):
        n, h, p = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        rec = cfg.n_layers * (4 * h * p * n)
        attn = 0
        if cfg.family == "hybrid":
            attn = (cfg.n_layers // cfg.attn_every) * 4 * s * hdh
        return (pf + rec + attn) * b
    return pf * b + _attn_flops_fwd(cfg, 1, kv_len=s) * b
