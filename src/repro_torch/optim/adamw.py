"""AdamW over a parameter tree, on one card.

The moments are float32 for every parameter, whatever its dtype; the
update is computed in float32 and cast back to the parameter's dtype
(bfloat16 weights, float32 moments: the JAX package's trade-off, with no
float32 master copy).  Not ``torch.optim.AdamW``: that keeps the moments
in the parameter's dtype and rounds the weight decay and the bias
correction in another order.  The JAX package's ``abstract_state`` and
``state_specs`` (its sharded state) wait for the mesh.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import leaves, map_defs


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init(params):
    """Zero float32 moments ``m`` and ``v`` shaped as ``params``, and the
    step count, a 0-d int32 tensor on the parameters' device."""
    dev = leaves(params)[0].device
    return {
        "m": map_defs(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        "v": map_defs(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(grads) -> torch.Tensor:
    """The float32 2-norm of every gradient together (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(grads)))


@torch.no_grad()
def update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping: the gradients scaled by
    ``min(1, grad_clip / max(gnorm, 1e-9))``, then the moments, the bias
    corrections and the decoupled weight decay in float32, in the JAX
    package's order of operations.  The step is taken IN PLACE: the
    tensors of ``params`` and ``state`` are updated and returned, as
    ``(params, state, gnorm)``, gnorm the norm before clipping."""
    step = state["step"].add_(1)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    bias1 = 1 - cfg.b1 ** stepf
    bias2 = 1 - cfg.b2 ** stepf
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), strict=True):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / bias1) / (torch.sqrt(v / bias2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - cfg.lr * delta)
    return params, state, gnorm
