"""AdamW over a parameter tree, on one card.

The moments are float32 for every parameter, whatever its dtype; the
update is computed in float32 and cast back to the parameter's dtype
(bfloat16 weights, float32 moments: the JAX package's trade-off, with no
float32 master copy).  Not ``torch.optim.AdamW``: that keeps the moments
in the parameter's dtype and rounds the weight decay and the bias
correction in another order.

On a mesh the moments inherit the parameters' 2-D (data, model) sharding
(:func:`state_specs`), so the state is already fully sharded (the ZeRO-1
property falls out of the storage sharding), and on the multi-pod mesh
they also shard over "pod".  :func:`update` runs on DTensors as it is.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import P, PartitionSpec, leaves, map_defs


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


def abstract_state(abstract_params):
    """The state of ``abstract_params`` (``meta`` tensors) as ``meta``
    tensors: float32 moments, the int32 step."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {"m": map_defs(f32, abstract_params),
            "v": map_defs(f32, abstract_params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_specs(param_spec_tree, axes=None):
    """Moment sharding = param sharding, plus ZeRO-1 across pods: on the
    multi-pod mesh the f32 moments additionally shard over "pod" on the
    dim that already carries "data" (params stay bf16-replicated per pod;
    the update's delta is gathered once per step — far cheaper than
    holding 2x f32 moments per pod)."""
    def extend(s: PartitionSpec) -> PartitionSpec:
        if axes is None or axes.pod is None:
            return s
        out = []
        for e in s:
            if e == axes.data:
                out.append((axes.pod, axes.data))
            elif isinstance(e, tuple) and axes.data in e \
                    and axes.pod not in e:
                out.append((axes.pod,) + tuple(e))
            else:
                out.append(e)
        return P(*out)

    mv = map_defs(extend, param_spec_tree)
    return {"m": mv, "v": mv, "step": P()}


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
