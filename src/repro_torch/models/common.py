"""Model substrate: parameter definitions and the architecture config.

Parameters are defined once as a tree (nested dicts) of ``ParamDef`` —
shape, init kind, scale, dtype — and the same tree materialises as seeded
random weights on a device (:func:`init_params`).  The slice is one card,
so the JAX package's sharding vocabulary (``Axes``, ``PartitionSpec``) has
no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.reference_io import resolve_device


# --------------------------------------------------------------------- #
# Parameter definitions
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones
    scale: float | None = None  # None -> 1/sqrt(fan_in)
    dtype: torch.dtype = torch.bfloat16


def pd(shape, init="normal", scale=None, dtype=torch.bfloat16) -> ParamDef:
    return ParamDef(tuple(shape), init, scale, dtype)


def map_defs(fn, defs):
    """``fn`` applied to every leaf of a tree of dicts (``ParamDef``s,
    tensors), the tree kept."""
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
    # the JAX package's sharding policy: "tp" or "spfsdp" (kept for parity
    # of the configs; one card shards nothing)
    policy: str = "tp"
    # which shape cells run (long_500k only for sub-quadratic archs)
    supports_long: bool = False
    has_decoder: bool = True

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads
                               if self.n_heads else 0)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 16, as in the JAX package (its
        'model' mesh axis divides it), so both packages' weights have one
        shape."""
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
