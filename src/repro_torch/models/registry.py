"""Architecture registry: ``--arch <id>`` -> config + model API + input
specs for every shape cell.

Every id of the JAX package's registry, in its order (``ARCH_IDS``): the
transformer family (dense GQA, Chameleon's VLM backbone, DBRX's MoE,
DeepSeek-V2's MLA + MoE), Mamba2's SSM, Zamba2's hybrid and Whisper's
encoder-decoder; then the ids of the port alone (``PORT_IDS``): Zamba2-7B
as published (``models/zamba2.py``) and NVIDIA-Nemotron-3-Nano-30B-A3B
(``models/nemotron_h.py``).  ``SERVED_IDS`` is both."""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Any

import torch

from repro_torch.models import (encdec, hybrid, mamba_lm, nemotron_h,
                                transformer, zamba2)
from repro_torch.models.common import (SHAPES, ArchConfig, Axes, P,
                                       ShapeCell, abstract_params,
                                       cell_applicable, count_params,
                                       init_params, map_defs, param_specs)

_ARCH_MODULES = {
    "deepseek-v2-236b": ("repro_torch.configs.deepseek_v2_236b", transformer),
    "dbrx-132b": ("repro_torch.configs.dbrx_132b", transformer),
    "qwen2.5-32b": ("repro_torch.configs.qwen2_5_32b", transformer),
    "tinyllama-1.1b": ("repro_torch.configs.tinyllama_1_1b", transformer),
    "qwen2-7b": ("repro_torch.configs.qwen2_7b", transformer),
    "qwen2.5-14b": ("repro_torch.configs.qwen2_5_14b", transformer),
    "mamba2-2.7b": ("repro_torch.configs.mamba2_2_7b", mamba_lm),
    "chameleon-34b": ("repro_torch.configs.chameleon_34b", transformer),
    "zamba2-2.7b": ("repro_torch.configs.zamba2_2_7b", hybrid),
    "whisper-medium": ("repro_torch.configs.whisper_medium", encdec),
}

ARCH_IDS = tuple(_ARCH_MODULES)

# ids the JAX package does not have (left out of ARCH_IDS, which the
# parity tests hold to the JAX package's registry)
_PORT_MODULES = {
    "zamba2-7b": ("repro_torch.configs.zamba2_7b", zamba2),
    "nemotron-3-nano-30b-a3b": ("repro_torch.configs.nemotron_3_nano_30b_a3b",
                                nemotron_h),
}

PORT_IDS = tuple(_PORT_MODULES)
SERVED_IDS = ARCH_IDS + PORT_IDS


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """Uniform handle over one architecture."""

    cfg: ArchConfig
    module: Any

    @property
    def meshed(self) -> bool:
        """Whether the model runs on a mesh: a module without mesh rules
        says so by ``MESHED = False``."""
        return getattr(self.module, "MESHED", True)

    # ---- parameters ----------------------------------------------------
    def param_defs(self, axes: Axes | None = None):
        return self.module.param_defs(self.cfg, axes)

    def abstract_params(self, axes: Axes | None = None):
        return abstract_params(self.param_defs(axes))

    def count_params(self) -> int:
        return count_params(self.param_defs())

    def param_specs(self, axes: Axes, layout: str = "train"):
        """PartitionSpec tree.  layout="decode" for spfsdp archs swaps every
        2-D weight to P(model-on-contraction, None): row-parallel decode —
        per-token weight reads are shard-local instead of FSDP-gathered (the
        JAX package's rule); the embedding keeps its gather layout."""
        defs = self.param_defs(axes)
        specs = param_specs(defs)
        if layout != "decode" or self.cfg.policy != "spfsdp":
            return specs

        def flip(d):
            nd = len(d.shape)
            if nd >= 2 and d.shape[-1] > 1 and d.shape[-2] > 256:
                # 2-D weight (possibly layer-stacked): model on the
                # contraction (second-to-last) dim, replicated elsewhere.
                return P(*((None,) * (nd - 2)), axes.model, None)
            return P(*((None,) * nd))

        flipped = map_defs(flip, defs)
        flipped["embed"] = specs["embed"]
        return flipped

    def zero1_specs(self, axes: Axes):
        """Full (data x model) storage specs for optimizer state / grad
        accumulators."""
        return param_specs(self.param_defs(axes))

    def init_params(self, seed: int = 0, *,
                    device: str | torch.device = "cuda"):
        return init_params(self.param_defs(), seed, device=device)

    # ---- step functions -------------------------------------------------
    def loss_fn(self, params, batch, axes: Axes | None = None,
                remat: bool = True):
        return self.module.loss_fn(params, batch, self.cfg, axes,
                                   remat=remat)

    def prefill_fn(self, params, batch, axes: Axes | None = None,
                   max_len: int | None = None):
        return self.module.prefill_fn(params, batch, self.cfg, axes,
                                      max_len=max_len)

    def decode_fn(self, params, cache, tokens, pos,
                  axes: Axes | None = None):
        return self.module.decode_fn(params, cache, tokens, pos, self.cfg,
                                     axes)

    # ---- caches ----------------------------------------------------------
    def cache_defs(self, batch: int, max_len: int, axes: Axes | None = None):
        return self.module.cache_defs(self.cfg, batch, max_len, axes)

    def step_writes(self, cache, pos: int) -> list:
        return self.module.step_writes(self.cfg, cache, pos)

    def last_pos(self, cache) -> int:
        return self.module.last_pos(self.cfg, cache)

    # ---- dry-run inputs ---------------------------------------------------
    def input_specs(self, cell: ShapeCell, axes: Axes | None = None):
        """``meta`` stand-ins and PartitionSpecs for one shape cell, the
        JAX package's: (abstract_inputs: dict, partition_specs: dict).
        Tokens are int32.  Decode cells include the abstract cache under
        key "cache", of ``seq_len`` rows (the port's prefill rounds its
        caches up to the decode kernel's rows; the cell's cache is the
        reference's)."""
        cfg = self.cfg
        b, s = cell.global_batch, cell.seq_len
        batch_axis = axes.batch if axes and b > 1 else None
        tok_spec = P(batch_axis, None)

        def meta(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if cell.kind == "train":
            if cfg.family == "audio":
                inputs = {"frames": meta((b, s, cfg.d_model), torch.bfloat16),
                          "tokens": meta((b, cfg.dec_seq)),
                          "labels": meta((b, cfg.dec_seq))}
                specs = {"frames": P(batch_axis, None, None),
                         "tokens": tok_spec, "labels": tok_spec}
            else:
                inputs = {"tokens": meta((b, s)), "labels": meta((b, s))}
                specs = {"tokens": tok_spec, "labels": tok_spec}
            return inputs, specs

        if cell.kind == "prefill":
            if cfg.family == "audio":
                inputs = {"frames": meta((b, s, cfg.d_model), torch.bfloat16)}
                specs = {"frames": P(batch_axis, None, None)}
            else:
                inputs = {"tokens": meta((b, s))}
                specs = {"tokens": tok_spec}
            return inputs, specs

        # decode: one new token against a seq_len cache
        cache_d = self.cache_defs(b, s, axes)
        inputs = {"cache": abstract_params(cache_d),
                  "tokens": meta((b, 1)),
                  "pos": meta(())}
        specs = {"cache": param_specs(cache_d),
                 "tokens": P(batch_axis, None),
                 "pos": P()}
        return inputs, specs

    def applicable_cells(self):
        return [(cell, *cell_applicable(self.cfg, cell))
                for cell in SHAPES.values()]


@functools.lru_cache(maxsize=None)
def get(arch_id: str) -> ModelApi:
    modules = {**_ARCH_MODULES, **_PORT_MODULES}
    if arch_id not in modules:
        raise KeyError(f"unknown arch '{arch_id}'; have {SERVED_IDS}")
    cfg_mod, model_mod = modules[arch_id]
    cfg = importlib.import_module(cfg_mod).CONFIG
    return ModelApi(cfg=cfg, module=model_mod)


def get_reduced(arch_id: str, **over) -> ModelApi:
    """Reduced same-family config for CPU smoke tests."""
    api = get(arch_id)
    return ModelApi(cfg=api.cfg.reduced(**over), module=api.module)
