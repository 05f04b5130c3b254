"""Neural building blocks of the serving and training paths, in plain
PyTorch: norms, RoPE, sinusoidal positions, chunked flash attention, GQA
helpers, the SwiGLU and GELU MLPs, embeddings, the unembedding and the
cross entropy.
All functions take explicit parameter tensors (built from ParamDef trees
in the model files) and follow the JAX package's numerics: reductions,
RoPE and softmax in float32, results cast back to the input's dtype."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


# ----------------------------- norms ---------------------------------- #

def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).pow(2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


# ----------------------------- RoPE ------------------------------------ #

def rope_frequencies(dim: int, theta: float,
                     device: str | torch.device | None = None
                     ) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)           # (D/2,)
    ang = positions[..., :, None].float() * freqs                 # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int,
                         device: str | torch.device | None = None
                         ) -> torch.Tensor:
    """(seq, dim) float32 table: sines of the first half, cosines of the
    second, over the frequencies ``10000 ** (-2i / dim)``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    ang = pos * (1.0 / (10_000.0 ** exps))[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------- attention ----------------------------------- #

def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, H_kv, D) -> (B, S, H_kv*n_rep, D)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


_NEG = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """Memory-safe attention: an outer loop over query chunks, an inner
    loop over KV chunks with an online softmax in float32 (the S1 schedule
    in plain PyTorch; the hand-written decode kernel is the single-query
    version).  Not a kernel of its own: the JAX package writes it in jnp.

    q: (B, Sq, H, D); k/v: (B, Skv, H, D) (already GQA-repeated).
    ``q_offset``: absolute position of q[0] (prefill continuation).
    Returns (B, Sq, H, Dv).
    """
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    scale = d ** -0.5
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, qc):
        qb = q[:, q0:q0 + qc].transpose(1, 2).float()           # (B,H,qc,D)
        n_q = qb.shape[2]
        qpos = q_offset + q0 + torch.arange(n_q, device=q.device)
        m = torch.full((b, h, n_q, 1), _NEG, device=q.device)
        l = torch.zeros((b, h, n_q, 1), device=q.device)
        acc = torch.zeros((b, h, n_q, dv), device=q.device)
        for k0 in range(0, skv, kc):
            kb = k[:, k0:k0 + kc].transpose(1, 2).float()       # (B,H,kc,D)
            vb = v[:, k0:k0 + kc].transpose(1, 2).float()
            s = (qb @ kb.transpose(-1, -2)) * scale
            if causal:
                kpos = k0 + torch.arange(kb.shape[2], device=q.device)
                s = s.masked_fill(kpos[None, :] > qpos[:, None], _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vb
            m = m_new
        out[:, q0:q0 + qc] = (acc / l.clamp_min(1e-30)).to(q.dtype
                                                            ).transpose(1, 2)
    return out


def decode_attention_dense(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length: torch.Tensor
                           ) -> torch.Tensor:
    """Single-token attention over a padded cache in one dense softmax:
    the counterpart of the JAX package's ``decode_attention_jnp``, which
    its models call.  The port's models go through the hand-written
    kernel (``ops.decode_attention``) instead; this stays as the plain
    yardstick of the tests.

    q: (B, H, D); caches: (B, S, H, D) GQA-repeated; length: (B,).
    """
    d = q.shape[-1]
    s = k_cache.shape[1]
    scores = torch.einsum("bhd,bshd->bhs", q.float(),
                          k_cache.float()) * (d ** -0.5)
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < length.reshape(-1, 1)
    scores = scores.masked_fill(~valid[:, None, :], _NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, v_cache.float())
    return out.to(q.dtype)


# ------------------------------ MLPs ----------------------------------- #

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g.float()).to(x.dtype) * u) @ w_down


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GELU, as ``jax.nn.gelu``'s default."""
    h = x @ w1 + b1
    return F.gelu(h.float(), approximate="tanh").to(x.dtype) @ w2 + b2


# --------------------------- embeddings -------------------------------- #

def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in float32 (the loss's numerics) against a ``(V, d)`` table,
    in full float32 on the card."""
    with full_f32_matmul():
        return x.float() @ table.float().t()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token cross entropy over the valid labels (those not
    ``ignore_id``), the count clamped at 1; logits (..., V) float32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
    valid = (labels != ignore_id).float()
    return ((logz - gold) * valid).sum() / valid.sum().clamp_min(1.0)


@contextlib.contextmanager
def full_f32_matmul():
    """Matrix products in full float32 on the card (TF32 off) inside the
    block, the caller's setting restored after.  The logits are float32
    products in the JAX package; TF32 would round their inputs to about
    three decimal digits."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
