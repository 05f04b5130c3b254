"""Nemotron-H with routed experts in plain PyTorch, float32 with TF32 off
(NVIDIA-Nemotron-3-Nano-30B-A3B; the layer equations of Hugging Face's
``NemotronHForCausalLM``, ``modeling_nemotron_h.py``).

Block ``i`` is the ``i``-th letter of ``hybrid_override_pattern``, each
``x <- x + mixer(RMSNorm(x))`` (``layer_norm_epsilon``):

- ``M``, Mamba-2: ``in_proj`` to (z, x, B, C, dt), ``mamba_num_heads``
  heads of ``mamba_head_dim`` (d_inner their product), B and C in
  ``n_groups`` groups of ``ssm_state_size``; the depthwise causal conv of
  width ``conv_kernel`` over (x, B, C), with its bias, and SiLU;
  ``dt = softplus(dt + dt_bias)``; per step, head ``h`` with group
  ``g = h // (heads / groups)``: ``state <- exp(dt A) state + dt x B_g^T``,
  ``y = state C_g + D x``; the RMSNorm of ``y * silu(z)`` over each
  group's ``d_inner / groups`` channels (``layer_norm_epsilon``);
  ``out_proj``.
- ``E``, routed experts: scores ``sigmoid(x @ router)`` in float32; the
  ``num_experts_per_tok`` experts of the largest ``scores +
  e_score_correction_bias`` are chosen (the bias moves the choice only);
  their scores renormalised to sum to 1 and multiplied by
  ``routed_scaling_factor``; each expert ``down(relu(up x)^2)``
  (``moe_intermediate_size``), applied to every token that chose it, none
  dropped, weighted and summed; plus the shared expert, the same
  function ``moe_shared_expert_intermediate_size`` wide, on every token.
  (``n_group`` and ``topk_group`` are 1: one group, no group mask.)
- ``*``, attention: q, k, v of ``num_attention_heads`` /
  ``num_key_value_heads`` heads of ``head_dim``, no positional encoding,
  causal, scaled by ``head_dim ** -0.5``; ``o_proj``.

Last, RMSNorm and the untied ``lm_head``.

Departures from ``modeling_nemotron_h.py``, each deliberate:

- Everything is float32, the recurrent state too (the published cache
  holds it in the model's dtype); the routed experts' sum is not rounded
  to the model's dtype before the shared expert is added.
- No rotary embedding, though the config carries ``rope_theta``: the
  published attention applies none.
- Weights are given in the benchmark's layout (the program's tree):
  matrices ``(in, out)``, the experts ``(E, in, out)``, ``blocks[str(i)]``
  each ``{"norm", "mixer"}``.
- No attention mask and no padding: every sequence is whole.

:func:`forward` runs ``G`` tokens of ``n`` sequences from position
``start``: block by block (so that a block's weights are in float32 once,
an expert's when it is first used), all ``G`` positions of a block at
once where the block has no state, the recurrence one step at a time, no
chunking and no cache tricks.  With ``start`` 0 and no ``init`` it is the
full forward pass over a sequence; with ``init`` it is a teacher-forced
run from a given state (each Mamba block's state and conv window, each
attention block's first ``start`` K and V rows).  Given ``routes``, it
takes another computation's choice of experts at every expert block (a
program's, which a comparison then holds token by token without a
near-tie's flip in one reaching the other's later blocks), weighs them
by its own scores and reports how far each choice lies below its own
(``shortfall``).  It returns the final normed hidden states;
:func:`logits` puts them through the head, a few positions at a time.  ``quant="fp8"`` rounds every bfloat16 weight
matrix (the experts' too, not the embedding, a table, nor the float32
router) to ``float8_e4m3fn`` with a scale per output column;
``state_dtype=torch.bfloat16`` rounds the recurrent state to bfloat16
after every step: the two controls.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


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


def fp8_round(w: torch.Tensor) -> torch.Tensor:
    """(..., in, out) weight through float8_e4m3fn, scaled per output
    column."""
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float().mul_(scale)


def sizes(model: dict) -> dict:
    """The sizes the blocks use, from the configuration's keys."""
    heads, p = model["mamba_num_heads"], model["mamba_head_dim"]
    groups, n = model["n_groups"], model["ssm_state_size"]
    di = heads * p
    return {"d": model["hidden_size"], "di": di, "heads": heads, "p": p,
            "groups": groups, "n": n, "conv": di + 2 * groups * n,
            "width": model["conv_kernel"],
            "h": model["num_attention_heads"],
            "hk": model["num_key_value_heads"], "dh": model["head_dim"],
            "experts": model["n_routed_experts"],
            "top_k": model["num_experts_per_tok"],
            "scale": model["routed_scaling_factor"],
            "eps": model["layer_norm_epsilon"],
            "pattern": model["hybrid_override_pattern"]}


def _matrix(t: torch.Tensor, quant: str | None) -> torch.Tensor:
    """A bfloat16 weight matrix in float32 (through fp8 with ``quant``)."""
    t = t.float()
    return fp8_round(t) if quant == "fp8" else t


def _mixer(u, mp, s: dict, quant, state0, state_dtype):
    """A Mamba-2 mixer over u (n, G, d) from ``state0`` (h (n, H, P, N),
    the conv window (n, W-1, C)) or zeros; returns (out (n, G, d), the
    last state, the last conv window)."""
    n, g, _ = u.shape
    di, heads, p, groups, nn = s["di"], s["heads"], s["p"], s["groups"], \
        s["n"]
    proj = u @ _matrix(mp["in_proj"], quant)
    z, xbc, dt = proj[..., :di], proj[..., di:di + s["conv"]], \
        proj[..., di + s["conv"]:]
    if state0 is None:
        h = torch.zeros((n, heads, p, nn), device=u.device)
        window = torch.zeros((n, s["width"] - 1, s["conv"]), device=u.device)
    else:
        h, window = state0[0].float().clone(), state0[1].float()
    full = torch.cat([window, xbc], dim=1)
    conv_w = mp["conv_w"].float()
    conv = sum(full[:, k:k + g] * conv_w[k]
               for k in range(s["width"])) + mp["conv_b"].float()
    conv = F.silu(conv)
    xs = conv[..., :di].reshape(n, g, heads, p)
    bm = conv[..., di:di + groups * nn].reshape(n, g, groups, nn)
    cm = conv[..., di + groups * nn:].reshape(n, g, groups, nn)
    group_of = torch.arange(heads, device=u.device) // (heads // groups)
    bm, cm = bm[:, :, group_of], cm[:, :, group_of]       # (n, G, H, N)
    dt = F.softplus(dt + mp["dt_bias"].float())           # (n, G, H)
    a = -torch.exp(mp["a_log"].float())
    d_skip = mp["d_skip"].float()
    ys = []
    for t in range(g):
        h = h * torch.exp(dt[:, t] * a)[..., None, None] + \
            dt[:, t, :, None, None] * xs[:, t, :, :, None] * \
            bm[:, t, :, None, :]
        if state_dtype is not None:
            h = h.to(state_dtype).float()
        ys.append(torch.einsum("nhpk,nhk->nhp", h, cm[:, t])
                  + d_skip[:, None] * xs[:, t])
    y = torch.stack(ys, dim=1).reshape(n, g, di) * F.silu(z)
    y = rmsnorm(y.view(n, g, groups, di // groups),
                mp["norm_w"].float().view(groups, di // groups),
                s["eps"]).reshape(n, g, di)
    # the window a copy, not a view that would keep all of ``full``
    return (y @ _matrix(mp["out_proj"], quant), h,
            full[:, -(s["width"] - 1):].clone())


def route(x, router, bias, top_k: int, scale: float, chosen=None):
    """x (T, d): (weights (T, k), experts (T, k), shortfall (T,)): the
    top-k of the sigmoid scores plus ``bias``, weighted by their scores
    without it, renormalised, times ``scale``.  ``chosen`` (T, k), where
    given, are the experts instead (another computation's choices, which
    this one follows); their weights are still these scores.
    ``shortfall``: how far the lowest of the experts taken lies below the
    k-th largest biased score, 0 where they are the top-k."""
    scores = torch.sigmoid(x @ router.float())
    biased = scores + bias.float()
    top = torch.topk(biased, top_k, dim=-1)
    if chosen is None:
        chosen = top.indices
    shortfall = (top.values[:, -1:] - biased.gather(-1, chosen)) \
        .clamp_min(0).amax(dim=-1)
    w = scores.gather(-1, chosen)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scale, chosen, shortfall


def relu2_mlp(x, up, down):
    return F.relu(x @ up).square() @ down


def experts(u, mp, s: dict, quant=None, chosen=None):
    """The routed experts and the shared one over u (n, G, d): every
    (token, choice) pair computed, expert by expert over the tokens that
    chose it; with ``chosen`` (n, G, k) the experts given (:func:`route`).
    Returns (out (n, G, d), the experts (n, G, k), the shortfall (n, G))."""
    n, g, d = u.shape
    x = u.reshape(n * g, d)
    k = s["top_k"]
    w, chosen, short = route(x, mp["router"], mp["router_bias"], k,
                             s["scale"], None if chosen is None
                             else chosen.reshape(n * g, k))
    out = torch.zeros_like(x)
    for e in range(s["experts"]):
        token, slot = torch.where(chosen == e)
        if token.numel():
            y = relu2_mlp(x[token], _matrix(mp["w_up"][e], quant),
                          _matrix(mp["w_down"][e], quant))
            out.index_add_(0, token, y * w[token, slot][:, None])
    if "shared" in mp:
        sp = mp["shared"]
        out = out + relu2_mlp(x, _matrix(sp["w_up"], quant),
                              _matrix(sp["w_down"], quant))
    return out.reshape(n, g, d), chosen.reshape(n, g, k), short.reshape(n, g)


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


def _attention(u, mp, s: dict, quant, start: int, kv0):
    """An attention mixer over u (n, G, d): (out (n, G, d), the G new k
    and v rows (n, G, H_kv, D))."""
    n, g, _ = u.shape
    q = (u @ _matrix(mp["wq"], quant)).view(n, g, s["h"], s["dh"])
    k = (u @ _matrix(mp["wk"], quant)).view(n, g, s["hk"], s["dh"])
    v = (u @ _matrix(mp["wv"], quant)).view(n, g, s["hk"], s["dh"])
    k0, v0 = kv0 if kv0 is not None else (k[:, :0], v[:, :0])
    out = torch.stack([
        _attend(q[b], torch.cat([k0[b].float(), k[b]]),
                torch.cat([v0[b].float(), v[b]]), start, s["dh"] ** -0.5)
        for b in range(n)])
    return out.reshape(n, g, -1) @ _matrix(mp["wo"], quant), k, v


def forward(weights: dict, model: dict, tokens: torch.Tensor,
            start: int = 0, init=None, quant: str | None = None,
            state_dtype: torch.dtype | None = None, routes=None,
            hook=None) -> dict:
    """tokens (n, G): the input token of each step, at positions
    ``start``..``start + G - 1``.  ``init`` None starts from nothing
    (zero states, no cache rows; ``start`` 0); otherwise
    ``init.state(j)`` gives the ``j``-th Mamba block's (h (n, H, P, N),
    conv window (n, W-1, C)) and ``init.kv(j)`` the ``j``-th attention
    block's first ``start`` rows (k, v) each (n, start, H_kv, D).
    ``routes``, where given, holds for the ``j``-th expert block the
    experts (n, G, k) each token takes there (another computation's
    choices, followed; :func:`route`).  ``hook(j, u, mixer weights)``,
    where given, is called with the ``j``-th expert block's input u (n,
    G, d) before the block runs.  Returns ``hidden`` (n, G, d), the final
    norm's output, float32; ``k`` and ``v`` (each attention block's new
    rows (n, G, H_kv, D)), ``h`` and ``conv`` (each Mamba block's state
    and conv window after the last step), ``routes`` and ``shortfall``
    (each expert block's experts (n, G, k) and shortfall (n, G))."""
    s = sizes(model)
    out = {"k": [], "v": [], "h": [], "conv": [], "routes": [],
           "shortfall": []}
    seen = {"M": 0, "E": 0, "*": 0}
    with full_f32():
        x = weights["embed"][tokens].float()
        for i, kind in enumerate(s["pattern"]):
            bp = weights["blocks"][str(i)]
            u = rmsnorm(x, bp["norm"].float(), s["eps"])
            mp = bp["mixer"]
            if kind == "M":
                j = seen["M"]
                y, h, window = _mixer(u, mp, s, quant,
                                      None if init is None
                                      else init.state(j), state_dtype)
                out["h"].append(h)
                out["conv"].append(window)
            elif kind == "E":
                j = seen["E"]
                if hook is not None:
                    hook(j, u, mp)
                y, chosen, short = experts(u, mp, s, quant, None
                                           if routes is None else routes[j])
                out["routes"].append(chosen)
                out["shortfall"].append(short)
            else:
                j = seen["*"]
                y, k, v = _attention(u, mp, s, quant, start,
                                     None if init is None else init.kv(j))
                out["k"].append(k)
                out["v"].append(v)
            seen[kind] += 1
            x = x + y
        out["hidden"] = rmsnorm(x, weights["norm_f"].float(), s["eps"])
    return out


def logits(weights: dict, hidden: torch.Tensor, quant: str | None = None,
           chunk: int = 128):
    """Yield (position slice, logits (n, chunk, V) float32) of ``hidden``
    (n, G, d), ``chunk`` positions at a time."""
    with full_f32():
        head = _matrix(weights["lm_head"], quant)
        for lo in range(0, hidden.shape[1], chunk):
            yield slice(lo, lo + chunk), hidden[:, lo:lo + chunk] @ head


def full_logits(weights: dict, hidden: torch.Tensor,
                quant: str | None = None) -> torch.Tensor:
    """Every position's logits (n, G, V) at once (small sizes)."""
    return torch.cat([lg for _, lg in logits(weights, hidden, quant)], dim=1)
