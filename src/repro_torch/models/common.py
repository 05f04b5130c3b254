"""Model substrate: parameter definitions with sharding, the mesh axes
and the architecture config.

Parameters are defined once as a tree (nested dicts) of ``ParamDef`` —
shape, partition spec, init kind, scale, dtype — and the same tree
materialises as seeded random weights on a device (:func:`init_params`),
as ``meta`` tensors that allocate nothing (:func:`abstract_params`, the
dry run's), or as a tree of partition specs (:func:`param_specs`), which
:func:`placements` turns into DTensor placements on a
``torch.distributed`` ``DeviceMesh``.

Sharding vocabulary, the JAX package's: mesh axes are ("data", "model")
within a pod, with an optional leading "pod" axis for multi-pod (pure
DP).  The ``Axes`` helper abstracts whether "pod" exists.  Rules:

  * TP dims (heads, d_ff, vocab, experts)          -> "model"
  * FSDP/ZeRO storage dim (largest non-TP dim)     -> "data"
  * batch / tokens                                  -> ("pod", "data")
  * sequence-parallel activations (policy B)        -> "model" on seq
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.reference_io import resolve_device


# --------------------------------------------------------------------- #
# Mesh axes and partition specs
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Axes:
    """Names of the mesh axes; ``pod`` is None on a single pod."""

    pod: str | None = None
    data: str = "data"
    model: str = "model"

    @property
    def batch(self) -> tuple[str, ...] | str:
        return (self.pod, self.data) if self.pod else self.data

    @classmethod
    def for_mesh(cls, mesh) -> "Axes":
        return cls(pod="pod" if "pod" in mesh.mesh_dim_names else None)


class PartitionSpec(tuple):
    """How a tensor is laid over a mesh: one entry per dimension, each
    ``None`` (not split), a mesh axis name, or a tuple of axis names
    (split over them, the first the major one).  Trailing dimensions may
    be left out.  A tuple that prints and compares as the JAX package's
    ``PartitionSpec`` does: ``PartitionSpec('data', 'model')``,
    ``PartitionSpec()``, ``PartitionSpec(None,)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


def _axis_names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the tensor's dim ``d`` names that mesh axis,
    ``Replicate()`` where no dim does.  A dim split over several axes
    (``("pod", "data")``) is ``Shard(d)`` on each of them, which DTensor
    applies in mesh order: the spec must name them in that order, the
    major axis first, as JAX reads it.  On a mesh dim of one device every
    placement is ``Replicate()`` (the shard is the whole tensor, and
    DTensor's view rules take a replica where they refuse a shard)."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _axis_names(entry)
        for name in axes:
            if name not in names:
                raise ValueError(f"{spec} names axis {name!r}, which the "
                                 f"mesh {names} does not have")
            if not isinstance(out[names.index(name)], Replicate):
                raise ValueError(f"{spec} names axis {name!r} twice")
            out[names.index(name)] = Shard(dim)
        order = [names.index(name) for name in axes]
        if order != sorted(order):
            raise ValueError(f"{spec} splits dim {dim} over {axes}, not in "
                             f"the mesh's order {names}")
    return tuple(Replicate() if mesh.size(i) == 1 else pl
                 for i, pl in enumerate(out))


def local_shape(shape, spec: PartitionSpec, mesh_shape: dict) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec`` on a mesh of ``mesh_shape`` ({axis: size}), each split dim
    rounded up as XLA pads it (DTensor's last shard may be shorter)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = math.prod(mesh_shape[name] for name in _axis_names(entry))
        out[dim] = -(-out[dim] // n)
    return tuple(out)


# --------------------------------------------------------------------- #
# Parameter definitions
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    spec: PartitionSpec = P()
    init: str = "normal"        # normal | zeros | ones
    scale: float | None = None  # None -> 1/sqrt(fan_in)
    dtype: torch.dtype = torch.bfloat16


def pd(shape, spec=P(), init="normal", scale=None, dtype=torch.bfloat16
       ) -> ParamDef:
    return ParamDef(tuple(shape), spec, init, scale, dtype)


def map_defs(fn, defs):
    """``fn`` applied to every leaf of a tree of dicts (``ParamDef``s,
    tensors, specs), the tree kept."""
    if isinstance(defs, dict):
        return {name: map_defs(fn, sub) for name, sub in defs.items()}
    return fn(defs)


def map_trees(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of dicts of one structure
    (``fn(leaf, *leaves_at_the_same_path)``), the first tree's structure
    kept."""
    if isinstance(tree, dict):
        return {name: map_trees(fn, sub, *(r[name] for r in rest))
                for name, sub in tree.items()}
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves of a tree of dicts, in sorted key order (the order JAX
    flattens a dict in)."""
    if isinstance(tree, dict):
        return [leaf for name in sorted(tree) for leaf in leaves(tree[name])]
    return [tree]


def abstract_params(defs):
    """ParamDef tree -> ``meta``-device tensors of the same shapes and
    dtypes (the dry run's: nothing is allocated)."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def param_specs(defs):
    """ParamDef tree -> PartitionSpec tree."""
    return map_defs(lambda d: d.spec, defs)


def init_params(defs, seed: int = 0, *,
                device: str | torch.device = "cuda"):
    """ParamDef tree -> initialised weights on ``device`` (the card unless
    the caller names the CPU), drawn from a ``torch.Generator`` seeded with
    ``seed`` on that device: ``normal`` draws N(0, 1) in float32 times the
    scale (``1/sqrt(fan_in)`` by default, fan_in the second-to-last dim),
    cast to the def's dtype.  The numbers are not the JAX package's (its
    keys are ``jax.random``'s); carry those across with
    ``reference_io.params_from_numpy``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else fan_in ** -0.5
        w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_(scale).to(d.dtype)

    return map_defs(make, defs)


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for d in leaves(defs))


# --------------------------------------------------------------------- #
# Architecture config
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture (exact numbers from the public pool)."""

    name: str
    family: str                 # dense | moe | ssm | vlm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # attention details
    head_dim: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2)
    attn_every: int = 0         # shared attention block period
    # enc-dec (whisper)
    dec_layers: int = 0
    dec_seq: int = 448
    causal: bool = True
    # sharding policy: "tp" or "spfsdp" (the activation specs the layers
    # pin under a mesh)
    policy: str = "tp"
    # which shape cells run (long_500k only for sub-quadratic archs)
    supports_long: bool = False
    has_decoder: bool = True

    # Class attributes, not fields, so that ``dataclasses.asdict`` stays
    # the JAX package's: every config of the JAX package's registry keeps
    # them, and :class:`Zamba2Config` sets its own.  ``ssm_groups``
    # is how many groups B and C of the SSD layer come in (head ``h``
    # reads group ``h // (heads / groups)``), the gated norm running over
    # each group's channels; ``ssm_norm_eps`` is that norm's epsilon.
    ssm_groups = 1
    ssm_norm_eps = 1e-6

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads
                               if self.n_heads else 0)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the 'model' axis (16) divides it, as in the JAX
        package, so both packages' weights have one shape."""
        return -(-self.vocab // 16) * 16

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, **over) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the JAX package's
        numbers, so both packages reduce an arch alike)."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16 if self.n_heads else None,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            kv_lora_rank=32 if self.mla else 0,
            q_lora_rank=48 if self.mla else 0,
            qk_rope_head_dim=8 if self.mla else 64,
            qk_nope_head_dim=16 if self.mla else 128,
            v_head_dim=16 if self.mla else 128,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            attn_every=2 if self.attn_every else 0,
            dec_layers=2 if self.dec_layers else 0,
            dec_seq=16 if self.dec_layers else 448,
        )
        small.update(over)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ArchConfig):
    """Zamba2 as published (``models/zamba2.py``): a Mamba-2 layer at
    every index, ``num_mem_blocks`` shared attention + MLP blocks used in
    turn on the layers of ``hybrid_layer_ids``, each application with its
    own rank-``adapter_rank`` adapter on the MLP's ``gate_up`` and its
    own ``d x d`` output map.  The attention reads the ``2 d``-wide
    concatenation of the residual stream and the embedding: ``n_heads``
    heads of ``head_dim = 2 d / n_heads``.  ``norm_eps`` is every
    RMSNorm's epsilon but the mixer's gated norm's, which the published
    code fixes at 1e-5."""

    ssm_norm_eps = 1e-5
    ssm_groups: int = 1
    norm_eps: float = 1e-5
    hybrid_layer_ids: tuple[int, ...] = ()
    num_mem_blocks: int = 2
    adapter_rank: int = 128

    def reduced(self, **over) -> "Zamba2Config":
        """A tiny Zamba2 that keeps the structure: d 64, 8 layers, both
        blocks applied twice (layers 1, 3, 5, 7), B and C in the
        published groups, heads of 2 d / n_heads."""
        small = dict(n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
                     head_dim=32, d_ff=128, vocab=256, ssm_state=16,
                     ssm_head_dim=16, ssm_chunk=8,
                     hybrid_layer_ids=(1, 3, 5, 7), adapter_rank=8)
        small.update(over)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class NemotronHConfig(ArchConfig):
    """Nemotron-H with routed experts (``models/nemotron_h.py``): one
    block a letter of ``pattern`` (``hybrid_override_pattern``): ``M`` a
    Mamba-2 mixer, ``E`` routed experts beside a shared one, ``*`` GQA
    attention with no positional encoding; each block
    ``x + mixer(RMSNorm(x))``.  The Mamba-2 layer has ``ssm_n_heads``
    heads of ``ssm_head_dim``, so ``d_inner`` is theirs, not
    ``ssm_expand * d_model``; B and C in ``ssm_groups`` groups.  The
    experts are ``d_ff`` wide (``moe_intermediate_size``), routed by the
    sigmoid with a selection-only bias and scaled by ``routed_scale``,
    relu^2 and not gated; the shared expert is ``shared_expert_ff``
    wide.  ``norm_eps`` is every RMSNorm's epsilon, the gated norms'
    too."""

    ssm_norm_eps = 1e-5
    ssm_groups: int = 8
    ssm_n_heads: int = 64
    norm_eps: float = 1e-5
    pattern: str = ""
    shared_expert_ff: int = 0
    routed_scale: float = 1.0

    @property
    def d_inner(self) -> int:
        return self.ssm_n_heads * self.ssm_head_dim

    @property
    def ssm_heads(self) -> int:
        return self.ssm_n_heads

    def reduced(self, **over) -> "NemotronHConfig":
        """A tiny Nemotron-H that keeps every kind of block and what the
        published one forces: ``MEM*EME*`` (three Mamba-2 layers, three
        expert layers, two attention layers), d 64, 6 Mamba-2 heads of 16
        (d_inner 96, not expand x d) with B and C in 2 groups, attention
        4 / 2 heads of 16, 8 experts of 32, top 2, a shared expert of 48."""
        small = dict(n_layers=8, pattern="MEM*EME*", d_model=64, n_heads=4,
                     n_kv_heads=2, head_dim=16, d_ff=32, vocab=256,
                     n_experts=8, top_k=2, shared_expert_ff=48,
                     ssm_state=16, ssm_head_dim=16, ssm_n_heads=6,
                     ssm_groups=2, ssm_chunk=8)
        small.update(over)
        return dataclasses.replace(self, **small)


# --------------------------------------------------------------------- #
# Shape cells (the assigned input-shape set)
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Whether (arch x shape) runs, and why not, as in the JAX package."""
    if cell.name == "long_500k" and not cfg.supports_long:
        return False, "SKIP: pure full-attention arch at 524k (sub-quadratic required)"
    if cell.kind == "decode" and not cfg.has_decoder:
        return False, "SKIP: encoder-only arch has no decode step"
    return True, "ok"
