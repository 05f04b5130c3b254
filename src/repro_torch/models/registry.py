"""Architecture registry: ``--arch <id>`` -> config + model API.

Only the architectures whose model code is ported are listed; the JAX
package's other ids (MoE, MLA, SSM, hybrid, encoder-decoder families)
come with the ROADMAP.md Queue 1 entry "Remaining model families"."""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Any

import torch

from repro_torch.models import transformer
from repro_torch.models.common import ArchConfig, count_params, init_params

_ARCH_MODULES = {
    "tinyllama-1.1b": ("repro_torch.configs.tinyllama_1_1b", transformer),
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

    def prefill_fn(self, params, batch, max_len: int | None = None):
        return self.module.prefill_fn(params, batch, self.cfg,
                                      max_len=max_len)

    def decode_fn(self, params, cache, tokens, pos: int):
        return self.module.decode_fn(params, cache, tokens, pos, self.cfg)

    def cache_defs(self, batch: int, max_len: int):
        return self.module.cache_defs(self.cfg, batch, max_len)


@functools.lru_cache(maxsize=None)
def get(arch_id: str) -> ModelApi:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown or not yet ported arch '{arch_id}'; "
                       f"have {ARCH_IDS}")
    cfg_mod, model_mod = _ARCH_MODULES[arch_id]
    cfg = importlib.import_module(cfg_mod).CONFIG
    return ModelApi(cfg=cfg, module=model_mod)


def get_reduced(arch_id: str, **over) -> ModelApi:
    """Reduced same-family config for CPU smoke tests."""
    api = get(arch_id)
    return ModelApi(cfg=api.cfg.reduced(**over), module=api.module)
