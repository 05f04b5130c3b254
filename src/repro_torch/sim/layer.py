"""Convolution layer description + data (paper Sec 6: "convolution layer
class contains all the parameters and data (patches, pixels and kernels)
required for computation")."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.conv_spec import ConvSpec


@dataclasses.dataclass
class ConvLayer:
    """Problem instance: spec + concrete tensors (input already padded)."""

    spec: ConvSpec
    input: np.ndarray      # (C_in, H_in, W_in)
    kernels: np.ndarray    # (N, C_in, H_K, W_K)

    def __post_init__(self):
        s = self.spec
        if self.input.shape != (s.c_in, s.h_in, s.w_in):
            raise ValueError(f"input shape {self.input.shape} != spec "
                             f"{(s.c_in, s.h_in, s.w_in)}")
        if self.kernels.shape != (s.n_kernels, s.c_in, s.h_k, s.w_k):
            raise ValueError(f"kernel shape {self.kernels.shape} != spec "
                             f"{(s.n_kernels, s.c_in, s.h_k, s.w_k)}")

    @classmethod
    def random(cls, spec: ConvSpec, seed: int = 0) -> "ConvLayer":
        rng = np.random.default_rng(seed)
        return cls(spec=spec,
                   input=rng.standard_normal(
                       (spec.c_in, spec.h_in, spec.w_in)).astype(np.float32),
                   kernels=rng.standard_normal(
                       (spec.n_kernels, spec.c_in, spec.h_k, spec.w_k)
                   ).astype(np.float32))
