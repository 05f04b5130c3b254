"""Mamba-2 SSD layer (state-space duality, arXiv:2405.21060), in plain
PyTorch.

Prefill uses the chunked SSD algorithm: the sequence is cut into chunks of
Q tokens; within a chunk the computation is a masked quadratic form, across
chunks a small state (H, P, N) is carried (the JAX package's
``jax.lax.scan`` over chunks is a loop over the ``nc`` chunks here).  The
chunk is a *step size* in the offloading formalism: each chunk's inputs
are one I_slice, the carried state is what stays on chip.

Decode is the O(1) recurrent form, h <- exp(dt A) h + dt B x, carried in
the serve cache together with the causal conv's tail window.  The JAX
package returns a new cache; :func:`ssd_decode` writes the layer's ``h``
and ``conv`` IN PLACE (``copy_`` into the caller's tensors), so a CUDA
graph replays the step over fixed buffers.

The dtypes follow the JAX package step for step: the projections in the
parameters' dtype, ``dt``, the decay and the state ``h`` in float32, ``xi``
kept in the activations' dtype and cast to float32 inside the products,
the conv tail stored as bfloat16.  The JAX package computes the scan in
``jnp``, with no Pallas kernel, so this stays plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, Axes, P, pd
from repro_torch.models.layers import rmsnorm, shard


def ssm_param_defs(cfg: ArchConfig, axes: Axes):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n                     # x, B, C convolved jointly
    proj_out = 2 * di + 2 * n + h             # z, x, B, C, dt
    return {
        "in_proj": pd((d, proj_out), P(axes.data, axes.model)),
        "conv_w": pd((cfg.ssm_conv_width, conv_dim), P(None, axes.model),
                     scale=0.5),
        "conv_b": pd((conv_dim,), P(axes.model), init="zeros"),
        "a_log": pd((h,), P(axes.model), init="ones", dtype=torch.float32),
        "d_skip": pd((h,), P(axes.model), init="ones", dtype=torch.float32),
        "dt_bias": pd((h,), P(axes.model), init="zeros",
                      dtype=torch.float32),
        "norm_w": pd((di,), P(axes.model), init="ones"),
        "out_proj": pd((di, d), P(axes.model, axes.data)),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None,
                 lengths: torch.Tensor | None = None):
    """Depthwise causal conv along S.  xbc (B, S, C); w (W, C); ``state``
    the previous segment's tail (B, W-1, C) or None (zeros).  Returns (out,
    tail): the tail is the inputs of the last W-1 positions, or with
    ``lengths`` (B,) those of each row's last W-1 real positions (the
    padded rows after them left out)."""
    width = w.shape[0]
    b_, s, c = xbc.shape
    if state is None:
        pad = torch.zeros((b_, width - 1, c), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                     # (B, S+W-1, C)
    out = sum(full[:, i:i + s] * w[i] for i in range(width))
    out = F.silu((out + b).float()).to(xbc.dtype)
    if width == 1:
        return out, pad
    if lengths is None:
        return out, full[:, -(width - 1):]
    # x position lengths - W + 1 + j is full position lengths + j
    idx = lengths.long()[:, None] + torch.arange(width - 1,
                                                 device=xbc.device)
    tail = full.gather(1, idx[:, :, None].expand(b_, width - 1, c))
    return out, tail


def ssd_forward(x: torch.Tensor, p, cfg: ArchConfig, cache: dict | None = None,
                return_cache: bool = False,
                seq_mask: torch.Tensor | None = None,
                axes: Axes | None = None):
    """Chunked SSD.  x (B, S, d) -> (B, S, d) [, final cache {h, conv}].
    S must divide by the chunk (the model pads).  ``cache`` streams a
    previous segment's final state in (prefill continuation).  ``seq_mask``
    (B, S) bool, a prefix mask (each row's real tokens, then its pad),
    zeroes dt at pad positions so they leave the carried state alone, and
    the conv tail returned is that of each row's last real positions.

    The JAX package's tail is the last W-1 positions of the padded
    sequence, so after a prompt that is not a multiple of the chunk its
    decode convolves the pad's inputs; the port's does not (ROADMAP.md
    Queue 3).  Under a mesh the chunked inputs and the gated output are
    pinned with the heads (channels) on "model"."""
    b, s, _ = x.shape
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    nc = s // q

    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    lengths = None if seq_mask is None else seq_mask.sum(dim=1)
    xbc, conv_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                  cache["conv"] if cache else None, lengths)
    xi = xbc[..., :di].reshape(b, s, h, pdim)
    bmat = xbc[..., di:di + n]                              # (B,S,N) 1 group
    cmat = xbc[..., di + n:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B,S,H)
    if seq_mask is not None:
        dt = dt * seq_mask[:, :, None].float()
    a = -torch.exp(p["a_log"].float())                      # (H,)
    da = dt * a

    # chunk
    xi = xi.reshape(b, nc, q, h, pdim)
    if axes:
        xi = shard(xi, P(axes.batch, None, None, axes.model, None))
    xf = xi.float()
    bm = bmat.reshape(b, nc, q, n).float()
    cm = cmat.reshape(b, nc, q, n).float()
    dt_c = dt.reshape(b, nc, q, h)
    da_cs = da.reshape(b, nc, q, h).cumsum(dim=2)           # (B,nc,Q,H)

    # intra-chunk (quadratic, causal-masked):
    # decay L[q1, q2] = exp(da_cs[q1] - da_cs[q2]) for q1 >= q2
    ldec = torch.exp(da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :])
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ldec = ldec.masked_fill(~causal[None, None, :, :, None], 0.0)
    scores = torch.einsum("bcqn,bckn->bcqk", cm, bm)        # (B,nc,Q,Q)
    w = scores[..., None] * ldec * dt_c[:, :, None, :, :]   # (B,nc,Q,K,H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", w, xf)

    # chunk states, then the carried state chunk by chunk
    seg_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)        # to chunk end
    states = torch.einsum("bckn,bckh,bckhp->bchpn", bm, dt_c * seg_end,
                          xf)                               # (B,nc,H,P,N)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])             # (B,nc,H)
    h_cur = cache["h"].float() if cache else torch.zeros_like(states[:, 0])
    h_before = []
    for c in range(nc):
        h_before.append(h_cur)
        h_cur = h_cur * chunk_decay[:, c, :, None, None] + states[:, c]
    h_before = torch.stack(h_before, dim=1)                 # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cm, h_before,
                           torch.exp(da_cs))
    y = (y_intra + y_inter).reshape(b, s, h, pdim)
    y = y + xf.reshape(b, s, h, pdim) \
        * p["d_skip"].float()[None, None, :, None]

    # gated RMSNorm + out projection
    y = y.reshape(b, s, di).to(x.dtype)
    z = F.silu(z.float()).to(x.dtype)
    y = rmsnorm(y * z, p["norm_w"])
    if axes:
        y = shard(y, P(axes.batch, None, axes.model))
    out = y @ p["out_proj"]
    if return_cache:
        return out, {"h": h_cur, "conv": conv_tail.to(torch.bfloat16)}
    return out


def ssm_init_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, *,
                   device: str | torch.device = "cuda"):
    """One layer's empty cache: ``h`` (B, H, P, N) float32 and the conv
    tail (B, W-1, d_inner + 2N) of ``dtype``."""
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
    }


def ssm_cache_specs(cfg: ArchConfig, axes: Axes):
    """One layer's cache specs: the batch over ("pod","data"), the heads
    of ``h`` and the channels of ``conv`` over "model"."""
    return {"h": P(axes.batch, axes.model, None, None),
            "conv": P(axes.batch, None, axes.model)}


def ssd_decode(x: torch.Tensor, p, cfg: ArchConfig, cache: dict
               ) -> torch.Tensor:
    """Recurrent single-token step.  x (B, 1, d) -> (B, 1, d).  Writes the
    new state into ``cache["h"]`` and the shifted conv window into
    ``cache["conv"]`` in place (the JAX package returns them as new
    arrays); reads nothing back to the host."""
    b = x.shape[0]
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    zxbcdt = x[:, 0] @ p["in_proj"]                         # (B, proj)
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)

    # conv update with the cached tail window; ``win`` is a new tensor, so
    # its slice does not alias the cache it is copied into
    win = torch.cat([cache["conv"].to(xbc.dtype), xbc[:, None]], dim=1)
    conv_out = (win * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
    xbc = F.silu(conv_out.float()).to(x.dtype)
    cache["conv"].copy_(win[:, 1:])

    xi = xbc[:, :di].reshape(b, h, pdim)
    xf = xi.float()
    bm = xbc[:, di:di + n].float()                          # (B,N)
    cm = xbc[:, di + n:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float()[None])
    a = -torch.exp(p["a_log"].float())
    dec = torch.exp(dt * a[None])                           # (B,H)

    hstate = cache["h"] * dec[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xf, bm)
    cache["h"].copy_(hstate)
    y = torch.einsum("bn,bhpn->bhp", cm, hstate) \
        + xf * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    z = F.silu(z.float()).to(x.dtype)
    y = rmsnorm(y * z, p["norm_w"])
    return (y @ p["out_proj"])[:, None, :]
