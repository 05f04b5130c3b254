"""Mamba-2 SSD layer (state-space duality, arXiv:2405.21060), in plain
PyTorch but for the decode step's recurrent update, a hand-written kernel
on the card (``kernels/ssd_update.py``).

Prefill uses the chunked SSD algorithm: the sequence is cut into chunks of
Q tokens; within a chunk the computation is a masked quadratic form, across
chunks a small state (H, P, N) is carried (the JAX package's
``jax.lax.scan`` over chunks is a loop over the ``nc`` chunks here).  The
chunk is a *step size* in the offloading formalism: each chunk's inputs
are one I_slice, the carried state is what stays on chip.

Decode is the O(1) recurrent form, h <- exp(dt A) h + dt B x, carried in
the serve cache together with the causal conv's tail window.  The JAX
package returns a new cache; :func:`ssd_decode` writes the layer's ``h``
and ``conv`` IN PLACE, so a CUDA graph replays the step over fixed
buffers: the recurrent update writes a state itself (one pass of the
kernel over it on the card, a ``copy_`` of the plain version's state on
the CPU), un-meshed the cache's own ``h``; the conv window, and on a mesh
the state, are copied into the caller's tensors.

The dtypes follow the JAX package step for step: the projections in the
parameters' dtype, ``dt``, the decay and the state ``h`` in float32, ``xi``
kept in the activations' dtype and cast to float32 inside the products,
the conv tail stored as bfloat16.  The JAX package computes the scan and
the step in ``jnp``, with no Pallas kernel; the port's decode update is a
kernel of its own for the bytes it saves (its plain version,
``ssd_update_plain``, is the step's recurrence, operation for operation).

B and C come in ``cfg.ssm_groups`` groups of ``ssm_state`` channels
(Zamba2's ``mamba_ngroups``; one for every config of the JAX package's
registry, whose layers stay as they were, operation for operation): head
``h`` reads group ``h // (heads / groups)``, and the gated norm runs over
each group's ``d_inner / groups`` channels.  Groups are un-meshed only.

``ssm_update`` in ``obs.counters`` counts the recurrent updates
:func:`ssd_decode` makes, one a layer a step, on the host: a CUDA graph's
replay does not pass through it, so a capture counts one step's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.ssd_update import ssd_update
from repro_torch.models.common import ArchConfig, Axes, P, pd
from repro_torch.models.layers import (grad_like, linear, on_shards, rmsnorm,
                                       shard)
from repro_torch.obs import counters


def _bc_width(cfg: ArchConfig) -> int:
    """The channels of B, and of C: ``ssm_state`` a group."""
    return cfg.ssm_groups * cfg.ssm_state


def ssm_param_defs(cfg: ArchConfig, axes: Axes):
    d, di, n, h = cfg.d_model, cfg.d_inner, _bc_width(cfg), cfg.ssm_heads
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


def _pl(base, model, dim=None, partial_batch=False, partial_model=False):
    """Placements from ``base`` (the batch's, or all replicated for a
    weight): ``Shard(dim)`` on the "model" mesh dim (``dim`` None: whole
    there); with ``partial_batch`` a ``Partial`` where the batch is split
    (a weight's gradient, summed over the batch's devices), with
    ``partial_model`` one on "model" (the gradient of a whole operand
    that every head's device uses)."""
    out = []
    for i, pl in enumerate(base):
        if i == model:
            pl = Shard(dim) if dim is not None else (
                Partial() if partial_model else Replicate())
        elif partial_batch and pl == Shard(0):
            pl = Partial()
        out.append(pl)
    return tuple(out)


def _cut(w: torch.Tensor, sizes, split, lead, axes: Axes):
    """A DTensor ``w``'s last dim cut into groups of ``sizes``: the last
    dim first made whole over "model" (``lead`` the spec of the other
    dims), each group then laid out with its last dim over "model" where
    ``split`` says so and whole otherwise, its other dims whole (gathered
    once, here, over "data" too)."""
    groups = shard(w, P(*lead, None)).split(sizes, dim=-1)
    whole = (None,) * len(lead)
    return [shard(shard(g, P(*lead, axes.model)), P(*whole, axes.model))
            if sp else shard(g, P(*whole, None))
            for g, sp in zip(groups, split)]


def _in_proj_groups(p, cfg: ArchConfig, axes: Axes):
    """On a mesh, ``in_proj``'s columns as (z, x, [B C], dt), each split
    over "model" (B and C are gathered where the scan reads them)."""
    di, n, h = cfg.d_inner, _bc_width(cfg), cfg.ssm_heads
    return _cut(p["in_proj"], (di, di, 2 * n, h), (True,) * 4, (axes.data,),
                axes)


def _conv_groups(p, cfg: ArchConfig, axes: Axes):
    """On a mesh, the conv's weight and bias as (x, [B C]) channels, x's
    split over "model" and B and C's whole."""
    sizes = (cfg.d_inner, 2 * _bc_width(cfg))
    return (_cut(p["conv_w"], sizes, (True, False), (None,), axes),
            _cut(p["conv_b"], sizes, (True, False), (), axes))


def _split_proj(x: torch.Tensor, proj, cfg: ArchConfig):
    """(z, the conv's input, dt): ``x``'s projection by ``in_proj``, cut
    by columns.  Un-meshed ``proj`` is ``in_proj`` itself: one product,
    cut into views (the conv's input one view of x, B and C side by
    side).  On a mesh ``proj`` is its column groups
    (:func:`_in_proj_groups`): one product each, z, x and dt split by
    heads over "model", as the JAX package keeps them, the conv's input
    the pair (x, [B C]); the (B, S, 2·di + 2·N + H) projection is never
    made and nothing is gathered here, and the gradients come back laid
    out as the products."""
    if isinstance(proj, torch.Tensor):
        di, n = cfg.d_inner, _bc_width(cfg)
        zxbcdt = x @ proj
        return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
                zxbcdt[..., 2 * di + 2 * n:])
    z, xs, bc, dt = (grad_like(x @ w) for w in proj)
    return z, (xs, bc), dt


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


def _ssd_scan(xbc, dt_raw, conv_w, conv_b, dt_bias, a_log, d_skip, tail,
              h0, seq_mask, cfg: ArchConfig):
    """The chunked SSD of one device's heads, on plain tensors: the conv,
    the intra-chunk quadratic form and the carried state.  xbc (B, S,
    Hl * P + 2N): its heads' x channels, then B and C; dt_raw (B, S, Hl).
    Returns (y (B, S, Hl * P) before the gate, the final state (B, Hl, P,
    N), the conv tail)."""
    b, s, _ = xbc.shape
    n, pdim, g = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_groups
    h = dt_raw.shape[-1]
    q = min(cfg.ssm_chunk, s)
    nc = s // q
    lengths = None if seq_mask is None else seq_mask.sum(dim=1)
    xbc, tail = _causal_conv(xbc, conv_w, conv_b, tail, lengths)
    xi = xbc[..., :h * pdim].reshape(b, s, h, pdim)
    bmat = xbc[..., h * pdim:h * pdim + g * n]              # (B,S,G·N)
    cmat = xbc[..., h * pdim + g * n:]

    dt = F.softplus(dt_raw.float() + dt_bias.float())       # (B,S,H)
    if seq_mask is not None:
        dt = dt * seq_mask[:, :, None].float()
    a = -torch.exp(a_log.float())                           # (H,)
    da = dt * a

    # chunk; the heads as (G, H/G): head h reads group h // (H/G), and B
    # and C broadcast over a group's heads
    hg = h // g
    xf = xi.reshape(b, nc, q, g, hg, pdim).float()
    bm = bmat.reshape(b, nc, q, g, n).float()
    cm = cmat.reshape(b, nc, q, g, n).float()
    dt_c = dt.reshape(b, nc, q, g, hg)
    da_cs = da.reshape(b, nc, q, g, hg).cumsum(dim=2)       # (B,nc,Q,G,Hg)

    # intra-chunk (quadratic, causal-masked):
    # decay L[q1, q2] = exp(da_cs[q1] - da_cs[q2]) for q1 >= q2, 0 above
    # the diagonal: exp(-inf) there, the JAX package's zeros, where the
    # exponent past the diagonal (positive, a chunk's decay) overflows
    # at a published chunk and its gradient (0 * inf) would be NaN
    causal = torch.ones((q, q), dtype=torch.bool, device=xbc.device).tril()
    ldec = torch.exp((da_cs[:, :, :, None] - da_cs[:, :, None])
                     .masked_fill(~causal[None, None, :, :, None, None],
                                  float("-inf")))
    scores = torch.einsum("bcqgn,bckgn->bcqkg", cm, bm)     # (B,nc,Q,K,G)
    w = scores[..., None] * ldec * dt_c[:, :, None]         # (B,nc,Q,K,G,Hg)
    y_intra = torch.einsum("bcqkgh,bckghp->bcqghp", w, xf)

    # chunk states, then the carried state chunk by chunk
    seg_end = torch.exp(da_cs[:, :, -1:] - da_cs)           # to chunk end
    states = torch.einsum("bckgn,bckgh,bckghp->bcghpn", bm, dt_c * seg_end,
                          xf)                               # (B,nc,G,Hg,P,N)
    chunk_decay = torch.exp(da_cs[:, :, -1])                # (B,nc,G,Hg)
    h_cur = h0.float().unflatten(1, (g, hg)) if h0 is not None else \
        torch.zeros_like(states[:, 0])
    h_before = []
    for c in range(nc):
        h_before.append(h_cur)
        h_cur = h_cur * chunk_decay[:, c, ..., None, None] + states[:, c]
    h_before = torch.stack(h_before, dim=1)                 # (B,nc,G,Hg,P,N)

    y_inter = torch.einsum("bcqgn,bcghpn,bcqgh->bcqghp", cm, h_before,
                           torch.exp(da_cs))
    y = (y_intra + y_inter).reshape(b, s, h, pdim)
    y = y + xf.reshape(b, s, h, pdim) \
        * d_skip.float()[None, None, :, None]
    return y.reshape(b, s, h * pdim).to(xbc.dtype), h_cur.flatten(1, 2), \
        tail


def _tails(conv, cfg: ArchConfig, axes: Axes):
    """On a mesh, a conv tail (B, W-1, d_inner + 2N) cut into its x and
    [B C] channels, laid out as :func:`_in_proj_groups` lays the
    conv's."""
    return _cut(conv, (cfg.d_inner, 2 * _bc_width(cfg)), (True, False),
                (axes.batch, None), axes)


def _joined(tail_x, tail_bc, axes: Axes):
    """On a mesh, the x and [B C] channels of a conv tail side by side
    again, whole over "model"."""
    whole = P(axes.batch, None, None)
    return torch.cat([shard(tail_x, whole), shard(tail_bc, whole)], dim=-1)


def _on_heads(body, xbc, dt_raw, conv_w, conv_b, p, tail, h, seq_mask,
              x, axes: Axes, heads_dim: int, cfg: ArchConfig):
    """``body`` (:func:`_ssd_scan` or :func:`_ssd_step`) on each device's
    heads: its x channels, dt and state split over "model" with the
    heads, B and C whole, the batch as ``x``'s; ``xbc``, ``conv_w``,
    ``conv_b`` and ``tail`` the pairs of (x, [B C]) channels, joined on
    the shards.  The weights' gradients are sums over the batch's devices,
    and those of B, C and their conv over the heads' devices too.
    ``heads_dim`` is the heads' dim of xbc and dt (2 over a sequence, 1
    for a step).  Returns (y, the state, the conv tail's (x, [B C]))."""
    if cfg.ssm_groups != 1:
        raise ValueError(f"{cfg.name}: B and C in {cfg.ssm_groups} groups "
                         f"run un-meshed only")
    mesh = x.device_mesh
    model = mesh.mesh_dim_names.index(axes.model)
    m = model if mesh.size(model) > 1 else None
    bt = tuple(Shard(0) if pl == Shard(0) else Replicate()
               for pl in x.placements)
    wt = (Replicate(),) * mesh.ndim
    heads, whole = _pl(bt, m, heads_dim), _pl(bt, m)
    tails = (_pl(bt, m, 2), whole)
    h_pl = _pl(bt, m, 1)
    w_heads = _pl(wt, m, 0)
    w_grad = _pl(bt, m, 0, partial_batch=True)
    bc_w_grad = _pl(bt, m, partial_batch=True, partial_model=True)
    n2 = xbc[1].shape[-1]                                   # B and C

    def local(xs, bc, dt_raw, cw_x, cb_x, cw_bc, cb_bc, dt_bias, a_log,
              d_skip, tail_x, tail_bc, h, seq_mask):
        tail = None if tail_x is None else torch.cat([tail_x, tail_bc], -1)
        y, h, tail = body(torch.cat([xs, bc], -1), dt_raw,
                          torch.cat([cw_x, cw_bc], -1),
                          torch.cat([cb_x, cb_bc], -1), dt_bias, a_log,
                          d_skip, tail, h, seq_mask)
        return y, h, tail[..., :-n2], tail[..., -n2:]

    args = (*xbc, dt_raw, conv_w[0], conv_b[0], conv_w[1], conv_b[1],
            p["dt_bias"], p["a_log"], p["d_skip"], *tail, h, seq_mask)
    in_pl = (heads, whole, heads, _pl(wt, m, 1), w_heads, wt, wt, w_heads,
             w_heads, w_heads, *tails, h_pl, whole)
    grad_pl = (heads, _pl(bt, m, partial_model=True), heads,
               _pl(bt, m, 1, partial_batch=True), w_grad, bc_w_grad,
               bc_w_grad, w_grad, w_grad, w_grad, *tails, h_pl, whole)
    y, h, tail_x, tail_bc = on_shards(local, args, in_pl,
                                      (heads, h_pl, *tails), grad_pl)
    return y, h, (tail_x, tail_bc)


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
    Queue 3).  Under a mesh the layer stays split by heads over "model",
    as the JAX package keeps it: z, x and dt come out of their own column
    groups of ``in_proj`` split by heads, B and C are gathered whole, and
    every device runs the conv and the scan of its own heads
    (:func:`_on_heads`); the gated norm reduces over the devices."""
    b, s, _ = x.shape
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    h0 = cache["h"] if cache else None

    def scan(xbc, dt_raw, conv_w, conv_b, dt_bias, a_log, d_skip, tail, h,
             seq_mask):
        return _ssd_scan(xbc, dt_raw, conv_w, conv_b, dt_bias, a_log,
                         d_skip, tail, h, seq_mask, cfg)

    if not isinstance(x, DTensor):
        z, xbc, dt_raw = _split_proj(x, p["in_proj"], cfg)
        y, h_cur, tail = scan(xbc, dt_raw, p["conv_w"], p["conv_b"],
                              p["dt_bias"], p["a_log"], p["d_skip"],
                              cache["conv"] if cache else None, h0, seq_mask)
    else:
        # whole rows into the projection (the hybrid's residual stream
        # keeps the embedding's d split over "model")
        x = shard(x, P(axes.batch, None, None))
        z, xbc, dt_raw = _split_proj(x, _in_proj_groups(p, cfg, axes), cfg)
        conv_w, conv_b = _conv_groups(p, cfg, axes)
        tails = _tails(cache["conv"], cfg, axes) if cache else (None, None)
        y, h_cur, tails = _on_heads(scan, xbc, dt_raw, conv_w, conv_b, p,
                                    tails, h0, seq_mask, x, axes, 2, cfg)
        tail = _joined(*tails, axes)

    # gated RMSNorm + out projection
    z = F.silu(z.float()).to(x.dtype)
    y = _gated_norm(y * z, p["norm_w"], cfg)
    if axes:
        y = shard(y, P(axes.batch, None, axes.model))
    out = linear(y, p["out_proj"])
    if return_cache:
        return out, {"h": h_cur, "conv": tail.to(torch.bfloat16)}
    return out


def ssm_init_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, *,
                   device: str | torch.device = "cuda"):
    """One layer's empty cache: ``h`` (B, H, P, N) float32 and the conv
    tail (B, W-1, d_inner + 2N) of ``dtype``."""
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             cfg.d_inner + 2 * _bc_width(cfg)), dtype=dtype,
                            device=device),
    }


def ssm_cache_specs(cfg: ArchConfig, axes: Axes):
    """One layer's cache specs: the batch over ("pod","data"), the heads
    of ``h`` and the channels of ``conv`` over "model"."""
    return {"h": P(axes.batch, axes.model, None, None),
            "conv": P(axes.batch, None, axes.model)}


def _conv_step(xbc, conv_w, conv_b, tail):
    """The causal conv of one step over the cached tail window: xbc (B, C)
    and the tail (B, W-1, C).  Returns (the conv's output after SiLU, in
    xbc's dtype, the shifted window); ``win`` is a new tensor, so the
    window does not alias the cache it is copied into."""
    win = torch.cat([tail.to(xbc.dtype), xbc[:, None]], dim=1)
    conv_out = (win * conv_w[None]).sum(dim=1) + conv_b
    return F.silu(conv_out.float()).to(win.dtype), win[:, 1:]


def _ssd_step(xbc, dt_raw, conv_w, conv_b, dt_bias, a_log, d_skip, tail, h,
              cfg: ArchConfig):
    """The recurrent step of one device's heads on a mesh, on plain
    tensors: xbc (B, Hl * P + 2N) its heads' x channels then B and C,
    dt_raw (B, Hl), the conv tail and the state ``h`` (B, Hl, P, N).
    Returns (y (B, Hl * P) before the gate, the new state, the shifted
    conv tail).  The shard's state may be the cache's own storage or a
    redistributed copy, so :func:`ssd_update.ssd_update` (the kernel on
    the card) updates a contiguous copy of it, which leaves as the new
    state for :func:`ssd_decode` to lay out and copy into the cache."""
    xbc, tail = _conv_step(xbc, conv_w, conv_b, tail)
    hstate = h.clone(memory_format=torch.contiguous_format)
    y = ssd_update(xbc, dt_raw, dt_bias, a_log, d_skip, hstate,
                   groups=cfg.ssm_groups)
    return y, hstate, tail


def _gated_norm(yz: torch.Tensor, w: torch.Tensor, cfg: ArchConfig
                ) -> torch.Tensor:
    """The RMSNorm of ``y * silu(z)`` over each group's channels."""
    g = cfg.ssm_groups
    return rmsnorm(yz.unflatten(-1, (g, -1)), w.view(g, -1),
                   cfg.ssm_norm_eps).flatten(-2)


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, ``src`` laid out as ``dst`` first."""
    if isinstance(dst, DTensor) and tuple(src.placements) != \
            tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def ssd_decode(x: torch.Tensor, p, cfg: ArchConfig, cache: dict,
               axes: Axes | None = None) -> torch.Tensor:
    """Recurrent single-token step.  x (B, 1, d) -> (B, 1, d).  Writes the
    new state into ``cache["h"]`` and the shifted conv window into
    ``cache["conv"]`` in place (the JAX package returns them as new
    arrays); reads nothing back to the host.  Un-meshed, the conv window's
    update is PyTorch and the recurrence is
    :func:`ssd_update.ssd_update`, which updates ``cache["h"]`` itself: on
    the card one launch of the fused kernel, which reads and writes the
    state once.  Under a mesh, split by heads as :func:`ssd_forward`
    (:func:`_on_heads`), :func:`_ssd_step` on each shard (the same
    recurrence, on a copy of the shard's state), its new state laid out as
    the cache's and copied in; a step whose batch is whole (one row)
    gathers its small projection, not the weight."""
    if not isinstance(x, DTensor):
        z, xbc, dt_raw = _split_proj(x[:, 0], p["in_proj"], cfg)
        xbc, tail = _conv_step(xbc, p["conv_w"], p["conv_b"], cache["conv"])
        y = ssd_update(xbc, dt_raw, p["dt_bias"], p["a_log"], p["d_skip"],
                       cache["h"], groups=cfg.ssm_groups)
    else:
        def step(xbc, dt_raw, conv_w, conv_b, dt_bias, a_log, d_skip, tail,
                 h, seq_mask):
            return _ssd_step(xbc, dt_raw, conv_w, conv_b, dt_bias, a_log,
                             d_skip, tail, h, cfg)

        # whole rows into the projection (the decode step's residual
        # stream keeps the embedding's d split over "model")
        x = shard(x, P(axes.batch, None, None))
        if Shard(0) in x.placements:
            z, xbc, dt_raw = _split_proj(
                x[:, 0], _in_proj_groups(p, cfg, axes), cfg)  # (B, ·)
        else:
            # a step of one row (the batch whole): its projection is
            # gathered over "model" (2 x 10576 bytes at Mamba2-2.7B), not
            # the weight's column groups (3.4 MB a layer)
            z, xbc, dt_raw = _split_proj(x[:, 0], p["in_proj"], cfg)
            xbc = xbc.split((cfg.d_inner, 2 * _bc_width(cfg)), dim=-1)
        conv_w, conv_b = _conv_groups(p, cfg, axes)
        y, hstate, tails = _on_heads(step, xbc, dt_raw, conv_w, conv_b, p,
                                     _tails(cache["conv"], cfg, axes),
                                     cache["h"], None, x, axes, 1, cfg)
        tail = _joined(*tails, axes)
        _write(cache["h"], hstate)
    _write(cache["conv"], tail)
    counters.count("ssm_update")
    z = F.silu(z.float()).to(x.dtype)
    y = _gated_norm(y * z, p["norm_w"], cfg)
    return (y @ p["out_proj"])[:, None, :]
