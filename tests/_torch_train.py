"""Shared by the training tests of the port (``test_torch_train*.py``):
one reduced id in both packages with the JAX package's weights carried
across, a seeded numpy batch, and each package's loss and gradients.

Tolerances of the loss and gradient parity, per dtype:

* float32: both packages compute in float32, their sums in another order
  (XLA's CPU kernels against PyTorch's); measured on the ten ids: loss
  within 2e-7 of itself, every gradient within 2.5e-6 of its Frobenius
  norm.  Held to 1e-5 and 1e-4.
* bfloat16: parameters and activations are bfloat16 in both packages,
  every product rounds once to bfloat16, and where a rounding falls the
  other way the difference travels on through the layers; measured: loss
  within 4.7e-4, gradients within 2e-2.  Held to 1e-2 and 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import registry as jregistry
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.reference_io import params_from_numpy

LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# tokens a row: not a multiple of the reduced SSD chunk (8), so the SSD
# families' training backbones pad
SEQ = 13
BATCH = 2


def both(arch, dtype, seed=1):
    """The reduced ``arch`` in both packages: (JAX api, JAX params, port
    api, port params), the JAX package's ``init_params`` cast to
    ``dtype`` (float32, or each leaf's own) and carried across."""
    japi = jregistry.get_reduced(arch)
    api = registry.get_reduced(arch)
    jparams = japi.init_params(jax.random.key(seed))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jparams), api.cfg, device="cpu",
        dtype=torch.float32 if dtype == "float32" else None)
    return japi, jparams, api, params


def batch_np(cfg, seed=5, b=BATCH, t=SEQ):
    """A next-token batch: tokens and labels (B, T) int32, the first row's
    first three labels -1 (ignored); an encoder-decoder's tokens are
    ``dec_seq`` long and its stub frames (B, T, d) float32 go beside."""
    rng = np.random.default_rng(seed)
    t_tok = cfg.dec_seq if cfg.family == "audio" else t
    toks = rng.integers(0, cfg.vocab, size=(b, t_tok + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    out["labels"][0, :3] = -1
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((b, t, cfg.d_model)
                                            ).astype(np.float32)
    return out


def jax_batch(batch, dtype):
    fdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return {k: jnp.asarray(v, fdt) if k == "frames" else jnp.asarray(v)
            for k, v in batch.items()}


def torch_batch(batch, dtype):
    fdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return {k: torch.from_numpy(v).to(fdt) if k == "frames"
            else torch.from_numpy(v) for k, v in batch.items()}


def jax_loss_and_grads(japi, jparams, batch, dtype):
    """``jax.value_and_grad`` of the JAX package's ``loss_fn``: (loss,
    gradient leaves as float32 numpy, in ``jax.tree.leaves`` order)."""
    jb = jax_batch(batch, dtype)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, jb)))(jparams)
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]


def port_loss_and_grads(api, params, batch, dtype):
    """The port's ``steps.value_and_grad``: (loss, gradient leaves as
    float32 numpy, in ``leaves`` order, which is JAX's)."""
    loss, grads = steps.value_and_grad(api, params, torch_batch(batch, dtype))
    return float(loss), [g.float().numpy() for g in grads]


def rel_fro(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))
