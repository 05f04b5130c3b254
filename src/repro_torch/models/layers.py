"""Neural building blocks of the serving and training paths, in plain
PyTorch: norms, RoPE, sinusoidal positions, chunked flash attention, GQA
helpers, the SwiGLU and GELU MLPs, embeddings, the unembedding and the
cross entropy; and the activation constraints of a mesh (:func:`shard`).
All functions take explicit parameter tensors (built from ParamDef trees
in the model files) and follow the JAX package's numerics: reductions,
RoPE and softmax in float32, results cast back to the input's dtype.
Every one of them runs on DTensors as well as on plain tensors."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.models import trips
from repro_torch.models.common import PartitionSpec, placements

# the mesh ``launch.mesh.enter_mesh`` made ambient (None: un-meshed)
_MESH = None


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Make ``mesh`` the one :func:`shard` steers to inside the block,
    the previous one restored after."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def current_mesh():
    """The ambient mesh, or None."""
    return _MESH


def batch_shards(axes) -> int:
    """Devices the batch is split over on the ambient mesh: the sizes of
    ("pod", "data"); 1 un-meshed."""
    if axes is None or _MESH is None:
        return 1
    names = _MESH.mesh_dim_names
    n = 1
    for a in (axes.pod, axes.data):
        if a is not None:
            n *= _MESH.size(names.index(a))
    return n


def shard(x: torch.Tensor, spec: PartitionSpec | None) -> torch.Tensor:
    """The counterpart of ``with_sharding_constraint``: with a mesh
    entered and ``x`` a DTensor, ``x`` redistributed to ``spec``'s
    placements (a gather, a reduction or a local slice, as the placements
    ask); ``x`` itself otherwise (un-meshed runs, as in the JAX
    package).  A dim shorter than the devices it would be split over (a
    decode step's one position under a sequence spec) stays whole, where
    XLA would pad it to one row a device."""
    if spec is None or _MESH is None or not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() if isinstance(pl, Shard)
                 and x.shape[pl.dim] < _MESH.size(i) else pl
                 for i, pl in enumerate(placements(spec, _MESH)))
    if tuple(x.placements) == want:
        return x
    return _Redistribute.apply(x, _MESH, want)


class _Redistribute(torch.autograd.Function):
    """``x.redistribute(mesh, want)`` whose gradient goes back to ``x``'s
    placements, except that a partial sum's gradient stays replicated.
    The gradient of a sum of partials is each partial's: a replicated
    gradient is exact there, where DTensor's own backward would make it a
    partial sum again, and the products it then meets would gather their
    whole weights to keep it partial (Megatron's row-parallel backward is
    this identity too)."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh = mesh
        ctx.back = tuple(Replicate() if pl.is_partial() else pl
                         for pl in x.placements)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.back:
            grad = grad.redistribute(ctx.mesh, ctx.back)
        return grad, None, None


class _GradLike(torch.autograd.Function):
    """``x`` itself; its gradient laid out as ``x`` is (replicated where
    ``x`` is a partial sum, as :class:`_Redistribute`'s)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh = x.device_mesh
        ctx.pl = tuple(Replicate() if pl.is_partial() else pl
                       for pl in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.pl:
            grad = grad.redistribute(ctx.mesh, ctx.pl)
        return grad


def grad_like(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is laid out as ``x`` (a partial sum reduced)
    before it reaches the operation that made ``x``: DTensor would
    otherwise pick a layout for it, which may split a dim past the first
    that the operation's backward then merges."""
    return _GradLike.apply(x) if isinstance(x, DTensor) else x


def split_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x`` (..., prod(sizes)) reshaped to (..., *sizes): a flat head
    dim into (heads, head_dim).  On a DTensor whose last dim is split over
    more devices than divide ``sizes[0]`` (4 KV heads over 16), the last
    dim is gathered first: DTensor cannot cut one head's dims across
    devices, where XLA reshards."""
    if isinstance(x, DTensor):
        last = x.dim() - 1
        mesh = x.device_mesh
        n = 1
        for i, pl in enumerate(x.placements):
            if pl == Shard(last):
                n *= mesh.size(i)
        if sizes[0] % n:
            x = x.redistribute(mesh, [Replicate() if pl == Shard(last)
                                      else pl for pl in x.placements])
    return x.reshape(*x.shape[:-1], *sizes)


class _MergeLast(torch.autograd.Function):
    """The last two dims merged into one; the gradient split back by
    :func:`split_last`, which gathers a dim DTensor cannot split."""

    @staticmethod
    def forward(ctx, x):
        ctx.sizes = tuple(x.shape[-2:])
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, grad):
        return split_last(grad, *ctx.sizes)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., heads, head_dim) -> (..., heads * head_dim), the
    inverse of :func:`split_last`, in the backward pass too (a gradient
    split over "model" by the output projection is gathered where the
    heads do not divide the devices)."""
    return _MergeLast.apply(x)


def seq_split(cache: torch.Tensor) -> bool:
    """Whether a DTensor ``cache``'s sequence (dim 1) is split over more
    than one device (a plain tensor's never is)."""
    if not isinstance(cache, DTensor):
        return False
    mesh = cache.device_mesh
    return any(p == Shard(1) and mesh.size(i) > 1
               for i, p in enumerate(cache.placements))


def write_row(cache: torch.Tensor, pos: torch.Tensor, new: torch.Tensor
              ) -> None:
    """``cache[:, pos] = new[:, 0]`` IN PLACE, by device index (``pos`` a
    0-d integer tensor, nothing read back to the host).  On a DTensor
    cache each device writes its own shard: where the sequence (dim 1) is
    split, the one that holds row ``pos`` writes it and the others write
    their nearest row back to itself (the counterpart of XLA's
    ``dynamic_update_slice`` on a sharded dim)."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, pos.reshape(1).long(), new.to(cache.dtype))
        return
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    row_pl = [Replicate() if p == Shard(1) else p for p in pl]
    new = new.to(cache.dtype)
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim)
    new = new.redistribute(mesh, row_pl).to_local()
    pos = pos.full_tensor() if isinstance(pos, DTensor) else pos
    local = cache.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, pl)
    r = pos.reshape(1).long() - offset[1]
    inside = ((r >= 0) & (r < shape[1])).reshape((1,) * new.dim())
    r = r.clamp(0, max(shape[1] - 1, 0))
    local.index_copy_(1, r, torch.where(inside, new,
                                        local.index_select(1, r)))


def on_shards(fn, args, in_pl, out_pl, grad_pl=None):
    """``fn`` run on every device's shards of ``args``: the counterpart
    of a ``shard_map`` body.  Each tensor of ``args`` is laid out by its
    entry of ``in_pl`` (a plain tensor is taken as replicated first; a
    ``None`` argument passes as it is), ``fn`` gets the local shards, and
    its result (a tensor or a tuple) is read with ``out_pl`` (a tuple of
    placement tuples, one per output).  ``grad_pl`` gives the placements
    of the inputs' gradients where they differ from ``in_pl``: a
    ``Partial`` where the devices each hold a share of the sum (a weight
    that every device's rows use).  The shards must be even: the outputs'
    global shapes are read as the local ones times the splits."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    whole = (Replicate(),) * mesh.ndim
    keep = [i for i, a in enumerate(args) if a is not None]

    def body(*present):
        full = [None] * len(args)
        for i, a in zip(keep, present):
            full[i] = a
        return fn(*full)

    present = [args[i] if isinstance(args[i], DTensor) else
               DTensor.from_local(args[i], mesh, whole, run_check=False)
               for i in keep]
    grad_pl = grad_pl or in_pl
    return local_map(body, out_placements=out_pl,
                     in_placements=tuple(tuple(in_pl[i]) for i in keep),
                     in_grad_placements=tuple(tuple(grad_pl[i])
                                              for i in keep),
                     device_mesh=mesh, redistribute_inputs=True)(*present)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: an activation ``x`` (..., d_in) times a weight ``w``
    (d_in, d_out).  On DTensors the product's gradient comes back laid
    out as the product (:func:`grad_like`: a row-parallel product's
    partial sum replicated), not split along the rows, which the
    product's backward would merge.  Where ``x`` has a split dim past its
    first among the rows (spfsdp: the batch and the sequence), each
    device multiplies its own rows by the whole weight (the weight
    gathered, its gradient a partial sum over the devices that split the
    rows), the product that DTensor makes by merging the row dims and
    PyTorch 2.11 refuses."""
    if not isinstance(x, DTensor):
        return x @ w
    if not any(isinstance(pl, Shard) and 0 < pl.dim < x.dim() - 1
               for pl in x.placements):
        return grad_like(x @ w)
    x = _summed(x)
    mesh = x.device_mesh
    last = x.dim() - 1
    x_pl = tuple(Replicate() if pl == Shard(last) else pl
                 for pl in x.placements)
    w_grad = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                   for pl in x_pl)
    return on_shards(torch.matmul, (x, w),
                     (x_pl, (Replicate(),) * mesh.ndim), (x_pl,),
                     (x_pl, w_grad))


def pad_end(x: torch.Tensor, dim: int, size: int, value: float = 0
            ) -> torch.Tensor:
    """``x`` padded with ``value`` at the end of ``dim`` to ``size``.  On
    a DTensor each device pads its own shard, ``dim`` made whole first
    where it is split (PyTorch 2.11's DTensor has no rule for a pad); a
    partial sum stays partial when the pad is zeros."""
    dim %= x.dim()
    pad = (0, 0) * (x.dim() - 1 - dim) + (0, size - x.shape[dim])
    if not isinstance(x, DTensor):
        return F.pad(x, pad, value=value)
    if value != 0:
        x = _summed(x)
    pl = tuple(Replicate() if p == Shard(dim) else p for p in x.placements)
    return on_shards(lambda t: F.pad(t, pad, value=value), (x,), (pl,),
                     (pl,))


# ----------------------------- norms ---------------------------------- #

def _summed(x: torch.Tensor) -> torch.Tensor:
    """A DTensor that is a partial sum (after a row-parallel product)
    reduced to its sum; anything else as it is.  A norm reads the whole
    sum, and a partial one carried through it would reach the next product
    partial, which DTensor can only multiply by a whole weight."""
    if not isinstance(x, DTensor) or not any(
            pl.is_partial() for pl in x.placements):
        return x
    want = tuple(Replicate() if pl.is_partial() else pl
                 for pl in x.placements)
    return _Redistribute.apply(x, x.device_mesh, want)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    x = _summed(x)
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x = _summed(x)
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
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    q_spec: PartitionSpec | None = None,
                    kv_spec: PartitionSpec | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Memory-safe attention: an outer loop over query chunks, an inner
    loop over KV chunks with an online softmax in float32 (the S1 schedule
    in plain PyTorch; the hand-written decode kernel is the single-query
    version).  Not a kernel of its own: the JAX package writes it in jnp.

    q: (B, Sq, H, D); k/v: (B, Skv, H, D) (already GQA-repeated).
    ``q_offset``: absolute position of q[0] (prefill continuation).
    ``scale``: the scores' factor (None: ``D ** -0.5``).
    Returns (B, Sq, H, Dv).

    On DTensors q is pinned to ``q_spec`` and k, v to ``kv_spec`` (when
    given), and every device runs the loops on its own shards
    (:func:`on_shards`): the batch and heads as split, and where q's
    sequence is split (spfsdp, the only way the model axis divides
    attention when heads cannot) its own rows, from their global
    position, against the whole keys.  The products never see a split
    dim past the first, which PyTorch 2.11's DTensor refuses to merge.
    """
    if not isinstance(q, DTensor):
        return _attention(q, k, v, causal, q_offset, q_chunk, kv_chunk,
                          scale)
    q, k, v = shard(q, q_spec), shard(k, kv_spec), shard(v, kv_spec)
    mesh = q.device_mesh
    q_pl, kv_pl = tuple(q.placements), tuple(k.placements)
    if Shard(1) in kv_pl or tuple(v.placements) != kv_pl:
        raise ValueError(f"attention over keys split along the sequence "
                         f"or laid out unlike the values: {kv_pl}, "
                         f"{tuple(v.placements)}")
    _, offset = compute_local_shape_and_global_offset(q.shape, mesh, q_pl)
    # a device's rows of q see every key: the keys' gradient is a partial
    # sum over the devices that split q's sequence
    kv_grad = tuple(Partial() if qp == Shard(1) and kp == Replicate()
                    else kp for qp, kp in zip(q_pl, kv_pl))

    def local(q, k, v):
        return _attention(q, k, v, causal, q_offset + offset[1], q_chunk,
                          kv_chunk, scale)

    return on_shards(local, (q, k, v), (q_pl, kv_pl, kv_pl), (q_pl,),
                     (q_pl, kv_grad, kv_grad))


def _attention(q, k, v, causal: bool, q_offset: int, q_chunk: int,
               kv_chunk: int, scale: float | None = None) -> torch.Tensor:
    """:func:`flash_attention`'s loops on plain tensors."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    scale = d ** -0.5 if scale is None else scale

    # the chunks cut once (one node, whose backward concatenates their
    # gradients, where a slice per block would add a gradient of all of
    # q, k or v per block)
    q_chunks = q.split(qc, dim=1)
    k_chunks, v_chunks = k.split(kc, dim=1), v.split(kc, dim=1)

    def kv_block(qb, qpos, j, state):
        """KV block ``j``'s online-softmax update of ``state`` (m, l,
        acc); the first block (``state`` None) starts it: from m = -1e30
        and l = acc = 0 the update gives these very values."""
        kb = k_chunks[j].transpose(1, 2).float()                # (B,H,kc,D)
        vb = v_chunks[j].transpose(1, 2).float()
        s = (qb @ kb.transpose(-1, -2)) * scale
        if causal:
            kpos = j * kc + torch.arange(kb.shape[2], device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], _NEG)
        if state is None:
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            return m, p.sum(dim=-1, keepdim=True), p @ vb
        m, l, acc = state
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        return (m_new, l * alpha + p.sum(dim=-1, keepdim=True),
                acc * alpha + p @ vb)

    outs = []
    # every query chunk meets every key chunk (the causal mask does not
    # skip blocks): under ``hlo_stats.count`` one query chunk runs, its
    # first KV block once and one rescaling block for all the others
    for i in trips.loop(range(len(q_chunks))):
        qb = q_chunks[i].transpose(1, 2).float()                # (B,H,qc,D)
        qpos = q_offset + i * qc + torch.arange(qb.shape[2], device=q.device)
        state = kv_block(qb, qpos, 0, None)
        for j in trips.loop(range(1, len(k_chunks))):
            state = kv_block(qb, qpos, j, state)
        _, l, acc = state
        outs.append((acc / l.clamp_min(1e-30)).to(q.dtype).transpose(1, 2))
    if len(outs) < len(q_chunks):
        # counted once: the other chunks stand in, outside the gradient
        outs += [outs[0].detach()] * (len(q_chunks) - len(outs))
    return torch.cat(outs, dim=1)[:, :sq]


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
           w_down: torch.Tensor, ff_spec: PartitionSpec | None = None
           ) -> torch.Tensor:
    g = shard(linear(x, w_gate), ff_spec)
    u = shard(linear(x, w_up), ff_spec)
    return linear(F.silu(g.float()).to(x.dtype) * u, w_down)


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor,
             ff_spec: PartitionSpec | None = None) -> torch.Tensor:
    """The tanh-approximate GELU, as ``jax.nn.gelu``'s default."""
    h = shard(linear(x, w1) + b1, ff_spec)
    return linear(F.gelu(h.float(), approximate="tanh").to(x.dtype), w2) + b2


# --------------------------- embeddings -------------------------------- #

def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On a DTensor table each device looks its own
    tokens up in its own columns of the table, the vocabulary whole
    (:func:`on_shards`): DTensor's own indexing has an ``index_put`` for
    its backward, which PyTorch 2.11 fails among split tensors.  The
    table's gradient is a partial sum over the devices that split the
    tokens."""
    if not isinstance(table, DTensor):
        return table[tokens]
    whole = (Replicate(),) * table.device_mesh.ndim
    tok_pl, w_pl, out_pl, w_grad = [], [], [], []
    for tp, wp in zip(tokens.placements if isinstance(tokens, DTensor)
                      else whole, table.placements):
        if isinstance(tp, Shard):            # the tokens' split wins
            tok_pl.append(tp)
            w_pl.append(Replicate())
            out_pl.append(tp)
            w_grad.append(Partial())
            continue
        wp = Replicate() if wp == Shard(0) or wp.is_partial() else wp
        tok_pl.append(Replicate())
        w_pl.append(wp)
        out_pl.append(Shard(tokens.dim() + wp.dim - 1)
                      if isinstance(wp, Shard) else Replicate())
        w_grad.append(wp)
    return on_shards(lambda t, w: w[t], (tokens, table),
                     (tuple(tok_pl), tuple(w_pl)), (tuple(out_pl),),
                     (tuple(tok_pl), tuple(w_grad)))


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in float32 (the loss's numerics) against a ``(V, d)`` table,
    in full float32 on the card."""
    with full_f32_matmul():
        return x.float() @ table.float().t()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token cross entropy over the valid labels (those not
    ``ignore_id``), the count clamped at 1; logits (..., V) float32."""
    logz = logsumexp(logits)
    gold = gold_logits(logits, labels)
    valid = (labels != ignore_id).float()
    return ((logz - gold) * valid).sum() / valid.sum().clamp_min(1.0)


def logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last dim.  On a DTensor it is written
    out, as ATen computes it (the max, the sum of the shifted exponentials,
    their log plus the max), so that a vocabulary split over devices is
    reduced by a max and a sum of one value a row; DTensor's own rule for
    ``logsumexp`` gathers the whole logits first."""
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    m = logits.amax(dim=-1, keepdim=True).detach()
    return torch.log(_summed(torch.exp(logits - m).sum(dim=-1))) + m[..., 0]


def gold_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., label]`` for every label (-1 read as 0).  On a
    DTensor each device gathers from its own shard of the vocabulary the
    labels that fall in it, 0 for the others, and the shards' values are
    one partial sum (a vocabulary-parallel loss: the whole vocabulary is
    never gathered, forward or backward)."""
    if not isinstance(logits, DTensor):
        idx = labels.clamp_min(0)[..., None].long()
        return logits.gather(-1, idx)[..., 0]
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    last = logits.dim() - 1
    shape, offset = compute_local_shape_and_global_offset(logits.shape, mesh,
                                                          pl)
    n, lo = shape[last], offset[last]
    label_pl = tuple(Replicate() if p == Shard(last) else p for p in pl)
    out_pl = tuple(Partial() if p == Shard(last) else p for p in pl)

    def local(logits, labels):
        idx = labels.clamp_min(0).long() - lo
        inside = (idx >= 0) & (idx < n)
        gold = logits.gather(-1, idx.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(inside, gold, torch.zeros_like(gold))

    return local_map(local, out_placements=(out_pl,),
                     in_placements=(pl, label_pl), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


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
