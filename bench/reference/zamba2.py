"""Zamba2 in plain PyTorch, float32 with TF32 off (arXiv:2411.15242; the
layer equations of Hugging Face's ``Zamba2ForCausalLM``,
``transformers/models/zamba2/modeling_zamba2.py``).

Per layer ``i`` (a Mamba-2 layer at every index): where ``i`` is the
``j``-th of ``hybrid_layer_ids``, shared block ``j % num_mem_blocks`` runs
first on ``concat(x, x0)`` (``x0`` the embedding): RMSNorm over 2d, q, k,
v of ``num_attention_heads`` heads of ``attention_head_dim = 2d / heads``,
rotary embeddings (``rope_theta``, rotate-half) on q and k, causal
attention scaled by ``(head_dim / 2) ** -0.5``, ``o_proj`` to d; RMSNorm;
``gate_up`` plus the application's adapter ``(x A_j) B_j``, then
``down(gelu(gate) * up)``; then the application's ``linear_j``.  Its output
``t`` goes into the mixer's input, not the residual:
``x <- x + mixer(RMSNorm(x + t))``.  The mixer: ``in_proj`` to (z, x, B,
C, dt) with B and C in ``mamba_ngroups`` groups of ``mamba_d_state``; the
depthwise causal conv of width ``mamba_d_conv`` over (x, B, C) and SiLU;
``dt = softplus(dt + dt_bias)``; per step, head ``h`` with group
``g = h // (heads / groups)``: ``state <- exp(dt A) state + dt x B_g^T``,
``y = state C_g + D x``; the gated RMSNorm of ``y * silu(z)`` over each
group's ``d_inner / groups`` channels (epsilon 1e-5, as the published
code fixes it); ``out_proj``.  Last, RMSNorm and the tied head
``x @ embed.T``.

Departures from ``modeling_zamba2.py``, each deliberate:

- ``dt`` is not clamped at ``time_step_min``: the published kernel path
  applies ``time_step_limit``, null in the config, and no clamp; the
  file's plain-torch path clamps.
- The recurrent state is float32 throughout (the published cache holds
  it in the model's dtype), and so is everything else; every RMSNorm
  multiplies its weight in float32 before any cast.
- Weights are given in the benchmark's layout (the program's tree):
  matrices ``(in, out)``, ``gate_up`` as one ``(d, 2 ff)`` matrix whose
  first half is the gate, per-layer tensors stacked over layers, the
  blocks over ``num_mem_blocks``, each application's adapter and
  ``linear`` over the applications.
- No attention mask and no padding: every sequence is whole.

:func:`forward` runs ``G`` tokens of ``n`` sequences from position
``start``: layer by layer (so that one layer's weights are in float32 at
a time), all ``G`` positions of a layer at once where the layer has no
state, the recurrence one step at a time, no chunking and no cache
tricks.  With ``start`` 0 and no ``init`` it is the full forward pass
over a sequence; with ``init`` it is a teacher-forced run from a given
state (each layer's state and conv window, each application's first
``start`` K and V rows, keys already rotated).  ``quant="fp8"`` rounds
every weight matrix (not the embedding, a table) to ``float8_e4m3fn``
with a scale per output column; ``state_dtype=torch.bfloat16`` rounds the
recurrent state to bfloat16 after every step: the two controls.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
GATED_NORM_EPS = 1e-5


@contextlib.contextmanager
def full_f32():
    """Float32 products with TF32 off inside the block, the caller's
    settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


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


def sizes(model: dict) -> dict:
    """The sizes the layers use, from the configuration's keys."""
    d = model["hidden_size"]
    di = model["mamba_expand"] * d
    heads = di // model["mamba_headdim"]
    groups, n = model["mamba_ngroups"], model["mamba_d_state"]
    return {"d": d, "di": di, "heads": heads, "p": model["mamba_headdim"],
            "groups": groups, "n": n, "conv": di + 2 * groups * n,
            "width": model["mamba_d_conv"],
            "h": model["num_attention_heads"],
            "hk": model["num_key_value_heads"],
            "dh": 2 * d // model["num_attention_heads"],
            "ff": model["intermediate_size"],
            "blocks": model["num_mem_blocks"],
            "eps": model["rms_norm_eps"], "theta": model["rope_theta"]}


def _pick(tree: dict, i: int, quant: str | None) -> dict:
    """Entry ``i`` of a stacked subtree, float32 (weight matrices through
    fp8 with ``quant``)."""
    out = {}
    for name, t in tree.items():
        if isinstance(t, dict):
            out[name] = _pick(t, i, quant)
            continue
        t = t[i].float()
        out[name] = fp8_round(t) if quant == "fp8" and t.dim() == 2 \
            and name not in ("conv_w",) else t
    return out


def _attend(q, k, v, start: int, scale: float):
    """One sequence: q (G, H, D) at positions start..start+G-1; k, v
    (start+G, H_kv, D).  Causal: query j sees rows 0..start+j."""
    g, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("ghd,shd->hgs", q, k) * scale
    rows = torch.arange(k.shape[0], device=q.device)
    allowed = rows[None, :] <= (start + torch.arange(g, device=q.device)
                                )[:, None]
    scores = scores.masked_fill(~allowed[None], float("-inf"))
    return torch.einsum("hgs,shd->ghd", scores.softmax(-1), v)


def _block(x, x0, bp, ap, s: dict, positions, start, kv0):
    """A shared block's application: (t (n, G, d), k, v (n, G, H_kv, D))."""
    n, g, _ = x.shape
    xin = rmsnorm(torch.cat([x, x0], -1), bp["ln_attn"], s["eps"])
    q = (xin @ bp["wq"]).view(n, g, s["h"], s["dh"])
    k = (xin @ bp["wk"]).view(n, g, s["hk"], s["dh"])
    v = (xin @ bp["wv"]).view(n, g, s["hk"], s["dh"])
    q, k = rope(q, positions, s["theta"]), rope(k, positions, s["theta"])
    k0, v0 = kv0 if kv0 is not None else (k[:, :0], v[:, :0])
    scale = (s["dh"] / 2) ** -0.5
    out = torch.stack([
        _attend(q[b], torch.cat([k0[b].float(), k[b]]),
                torch.cat([v0[b].float(), v[b]]), start, scale)
        for b in range(n)])
    a = out.reshape(n, g, -1) @ bp["wo"]
    xm = rmsnorm(a, bp["ln_mlp"], s["eps"])
    gate_up = xm @ bp["w_gate_up"] + (xm @ ap["adapter_in"]) @ \
        ap["adapter_out"]
    gate, up = gate_up[..., :s["ff"]], gate_up[..., s["ff"]:]
    t = (F.gelu(gate) * up) @ bp["w_down"]
    return t @ ap["linear"], k, v


def _mixer(u, mp, s: dict, state0, state_dtype):
    """A Mamba-2 mixer over u (n, G, d) from ``state0`` (h (n, H, P, N),
    the conv window (n, W-1, C)) or zeros; returns (out (n, G, d), the
    last state, the last conv window)."""
    n, g, _ = u.shape
    di, heads, p, groups, nn = s["di"], s["heads"], s["p"], s["groups"], \
        s["n"]
    proj = u @ mp["in_proj"]
    z, xbc, dt = proj[..., :di], proj[..., di:di + s["conv"]], \
        proj[..., di + s["conv"]:]
    if state0 is None:
        h = torch.zeros((n, heads, p, nn), device=u.device)
        window = torch.zeros((n, s["width"] - 1, s["conv"]), device=u.device)
    else:
        h, window = state0[0].float().clone(), state0[1].float()
    full = torch.cat([window, xbc], dim=1)
    conv = sum(full[:, k:k + g] * mp["conv_w"][k]
               for k in range(s["width"])) + mp["conv_b"]
    conv = F.silu(conv)
    xs = conv[..., :di].reshape(n, g, heads, p)
    bm = conv[..., di:di + groups * nn].reshape(n, g, groups, nn)
    cm = conv[..., di + groups * nn:].reshape(n, g, groups, nn)
    group_of = torch.arange(heads, device=u.device) // (heads // groups)
    bm, cm = bm[:, :, group_of], cm[:, :, group_of]       # (n, G, H, N)
    dt = F.softplus(dt + mp["dt_bias"])                   # (n, G, H)
    a = -torch.exp(mp["a_log"])
    ys = []
    for t in range(g):
        h = h * torch.exp(dt[:, t] * a)[..., None, None] + \
            dt[:, t, :, None, None] * xs[:, t, :, :, None] * \
            bm[:, t, :, None, :]
        if state_dtype is not None:
            h = h.to(state_dtype).float()
        ys.append(torch.einsum("nhpk,nhk->nhp", h, cm[:, t])
                  + mp["d_skip"][:, None] * xs[:, t])
    y = torch.stack(ys, dim=1).reshape(n, g, di) * F.silu(z)
    y = rmsnorm(y.view(n, g, groups, di // groups),
                mp["norm_w"].view(groups, di // groups),
                GATED_NORM_EPS).reshape(n, g, di)
    return y @ mp["out_proj"], h, full[:, -(s["width"] - 1):]


def forward(weights: dict, model: dict, tokens: torch.Tensor,
            start: int = 0, init=None, quant: str | None = None,
            state_dtype: torch.dtype | None = None) -> dict:
    """tokens (n, G): the input token of each step, at positions
    ``start``..``start + G - 1``.  ``init`` None starts from nothing
    (zero states, no cache rows; ``start`` 0); otherwise
    ``init.state(layer)`` gives that layer's (h (n, H, P, N), conv window
    (n, W-1, C)) and ``init.kv(application)`` its first ``start`` rows
    (k, v) each (n, start, H_kv, D).  Returns ``logits`` (n, G, V)
    float32, ``k`` and ``v`` (each application's new rows (n, G, H_kv,
    D)), ``h`` and ``conv`` (each layer's state and conv window after the
    last step)."""
    s = sizes(model)
    n, g = tokens.shape
    positions = torch.arange(start, start + g, device=tokens.device)
    app_of = {layer: j for j, layer in enumerate(model["hybrid_layer_ids"])}
    out = {"k": [], "v": [], "h": [], "conv": []}
    with full_f32():
        x = weights["embed"][tokens].float()
        x0 = x
        for i in range(model["num_hidden_layers"]):
            t = None
            if i in app_of:
                j = app_of[i]
                bp = _pick(weights["blocks"], j % s["blocks"], quant)
                ap = _pick(weights["apps"], j, quant)
                t, k, v = _block(x, x0, bp, ap, s, positions, start,
                                 None if init is None else init.kv(j))
                out["k"].append(k)
                out["v"].append(v)
            lp = _pick(weights["mamba"], i, quant)
            u = rmsnorm(x if t is None else x + t, lp["ln"], s["eps"])
            y, h, window = _mixer(u, lp["mixer"], s,
                                  None if init is None else init.state(i),
                                  state_dtype)
            x = x + y
            out["h"].append(h)
            out["conv"].append(window)
        x = rmsnorm(x, weights["ln_f"].float(), s["eps"])
        out["logits"] = x @ weights["embed"].float().t()
    return out
