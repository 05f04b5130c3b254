"""Architecture registry: ``--arch <id>`` -> config + model API.

Every id of the JAX package's registry, in its order: the transformer
family (dense GQA, Chameleon's VLM backbone, DBRX's MoE, DeepSeek-V2's MLA
+ MoE), Mamba2's SSM, Zamba2's hybrid and Whisper's encoder-decoder."""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Any

import torch

from repro_torch.models import encdec, hybrid, mamba_lm, transformer
from repro_torch.models.common import ArchConfig, count_params, init_params

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


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """Uniform handle over one architecture."""

    cfg: ArchConfig
    module: Any

    def param_defs(self):
        return self.module.param_defs(self.cfg)

    def count_params(self) -> int:
        return count_params(self.param_defs())

    def init_params(self, seed: int = 0, *,
                    device: str | torch.device = "cuda"):
        return init_params(self.param_defs(), seed, device=device)

    def loss_fn(self, params, batch, remat: bool = True):
        return self.module.loss_fn(params, batch, self.cfg, remat=remat)

    def prefill_fn(self, params, batch, max_len: int | None = None):
        return self.module.prefill_fn(params, batch, self.cfg,
                                      max_len=max_len)

    def decode_fn(self, params, cache, tokens, pos):
        return self.module.decode_fn(params, cache, tokens, pos, self.cfg)

    def cache_defs(self, batch: int, max_len: int):
        return self.module.cache_defs(self.cfg, batch, max_len)

    def step_writes(self, cache, pos: int) -> list:
        return self.module.step_writes(self.cfg, cache, pos)

    def last_pos(self, cache) -> int:
        return self.module.last_pos(self.cfg, cache)


@functools.lru_cache(maxsize=None)
def get(arch_id: str) -> ModelApi:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; have {ARCH_IDS}")
    cfg_mod, model_mod = _ARCH_MODULES[arch_id]
    cfg = importlib.import_module(cfg_mod).CONFIG
    return ModelApi(cfg=cfg, module=model_mod)


def get_reduced(arch_id: str, **over) -> ModelApi:
    """Reduced same-family config for CPU smoke tests."""
    api = get(arch_id)
    return ModelApi(cfg=api.cfg.reduced(**over), module=api.module)
