"""Qwen2 decoding in plain PyTorch, float32 with TF32 off (arXiv:2407.10671;
the layer equations of Hugging Face's ``Qwen2ForCausalLM``).

Per layer: RMSNorm, the q/k/v projections with their biases, rotary
embeddings (``rope_theta``, the rotate-half form), grouped-query
attention over the cache and the new rows, the output projection added
to the residual; RMSNorm, SwiGLU (``down(silu(gate) * up)``) added to the
residual; then the final RMSNorm and the ``lm_head`` in float32.

:func:`forward` teacher-forces ``G`` new tokens of ``n`` sequences whose
first ``start`` cache rows are given, layer by layer (all ``G`` positions
of a layer at once, causal among themselves), so that one layer's
weights are in float32 at a time.  Weights are a dict in the layout the
benchmark made them: ``embed`` (V, d), per-layer tensors stacked over
layers with 2-D weights as (in, out), ``ln_f``, ``lm_head`` (d, V).

``quant="fp8"`` is the control: every weight matrix (the embedding is a
table, not a product) rounded to ``float8_e4m3fn`` with a scale per
output channel before use, the rest as above.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.conv2d import full_f32

FP8_MAX = 448.0


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (n, s, heads, D); positions (s,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = positions.float()[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def fp8_round(w: torch.Tensor) -> torch.Tensor:
    """(in, out) weight through float8_e4m3fn, scaled per output column."""
    scale = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _weight(t: torch.Tensor, quant: str | None) -> torch.Tensor:
    t = t.float()
    return fp8_round(t) if quant == "fp8" and t.dim() == 2 else t


def _attend(q, k, v, start: int, n_rep: int):
    """One sequence: q (G, H, D) at positions start..start+G-1; k, v
    (start+G, H_kv, D).  Causal: query j sees rows 0..start+j."""
    g, h, d = q.shape
    k = k.repeat_interleave(n_rep, dim=1)
    v = v.repeat_interleave(n_rep, dim=1)
    scores = torch.einsum("ghd,shd->hgs", q, k) / d ** 0.5
    rows = torch.arange(k.shape[0], device=q.device)
    allowed = rows[None, :] <= (start + torch.arange(g, device=q.device)
                                )[:, None]
    scores = scores.masked_fill(~allowed[None], float("-inf"))
    return torch.einsum("hgs,shd->ghd", scores.softmax(-1), v)


def forward(weights: dict, model: dict, init_kv, tokens: torch.Tensor,
            start: int, quant: str | None = None):
    """tokens (n, G): the input token of each step.  ``init_kv(layer)``
    gives that layer's first ``start`` cache rows of the ``n`` sequences,
    (k, v) each (n, start, H_kv, D), keys already rotated.  Returns
    (logits (n, G, V) float32, [k of each layer], [v of each layer]),
    the new rows (n, G, H_kv, D) float32."""
    d = model["hidden_size"]
    h, hk = model["num_attention_heads"], model["num_key_value_heads"]
    dh = d // h
    eps, theta = model["rms_norm_eps"], model["rope_theta"]
    n, g = tokens.shape
    positions = torch.arange(start, start + g, device=tokens.device)
    lay = weights["layers"]
    ks, vs = [], []
    with full_f32():
        x = weights["embed"][tokens].float()
        for i in range(model["num_hidden_layers"]):
            def w(*path):
                t = lay
                for p in path:
                    t = t[p]
                return _weight(t[i], quant)
            xin = rmsnorm(x, w("ln_attn"), eps)
            q = (xin @ w("attn", "wq") + w("attn", "bq")).view(n, g, h, dh)
            k = (xin @ w("attn", "wk") + w("attn", "bk")).view(n, g, hk, dh)
            v = (xin @ w("attn", "wv") + w("attn", "bv")).view(n, g, hk, dh)
            q, k = rope(q, positions, theta), rope(k, positions, theta)
            ks.append(k)
            vs.append(v)
            k0, v0 = init_kv(i)
            out = torch.stack([
                _attend(q[b], torch.cat([k0[b].float(), k[b]]),
                        torch.cat([v0[b].float(), v[b]]), start, h // hk)
                for b in range(n)])
            x = x + out.reshape(n, g, h * dh) @ w("attn", "wo")
            xin = rmsnorm(x, w("ln_mlp"), eps)
            x = x + (F.silu(xin @ w("ffn", "w_gate")) * (xin @ w("ffn", "w_up"))
                     ) @ w("ffn", "w_down")
        x = rmsnorm(x, _weight(weights["ln_f"], quant), eps)
        logits = x @ _weight(weights["lm_head"], quant)
    return logits, ks, vs
