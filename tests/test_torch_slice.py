"""The first slice of the port as a whole, at a small size on the CPU: a
conv network is planned by the reference, the solved plan and the arrays
are carried across with ``repro_torch.reference_io``, and the same layers
run through ``EmittedConv.run`` of both packages (the JAX side in Pallas
interpret mode, the port through its plain versions, as a CPU tensor
makes it).  Then the port plans the same networks itself under the H100's
shared-memory budget and runs them.

Tolerances as in ``test_torch_conv_kernels.py``: float32
``rtol = atol = 1e-4`` (f32 sums of at most 288 products here, in another
order); bfloat16 in f32 ``rtol = 1.6e-2, atol = 1e-2`` (one final
rounding to bfloat16 apart).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro.analysis.kerncheck import network_budget
from repro.configs.networks import NETWORKS as J_NETWORKS
from repro.kernels import emit as jemit
from repro.kernels import ref as jref
from repro_torch.configs.networks import NETWORKS
from repro_torch.core.cost_model import H100_SXM
from repro_torch.kernels import KernelShapeError, ops, ref
from repro_torch.kernels.emit import (EmittedConv, emit_layer_kernel,
                                      kernel_vmem_elements,
                                      plan_emitable_network)
from repro_torch.reference_io import emitted_from_fields, layer_from_numpy

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=1.6e-2, atol=1e-2)}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# name -> how many leading layers (ResNet-8 at full depth belongs to the
# run on the card, not to the CPU tests)
SLICES = {"tight4": None, "lenet5": None, "resnet8": 2}


def _specs(networks, name):
    specs = list(networks[name])
    return specs[:SLICES[name]] if SLICES[name] else specs


def _layer_arrays(rng, spec):
    x = rng.standard_normal(
        (spec.c_in, spec.h_in, spec.w_in)).astype(np.float32)
    w = rng.standard_normal(
        (spec.c_out, spec.c_in, spec.h_k, spec.w_k)).astype(np.float32)
    return x, w


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = want.float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SLICES))
def test_reference_plan_runs_alike_through_both_packages(name, dtype):
    rng = np.random.default_rng(11)
    jspecs = _specs(J_NETWORKS, name)
    jplan = jemit.plan_emitable_network(jspecs, network_budget(jspecs),
                                        name=name)
    for jlp in jplan.layers:
        jem = jemit.emit_layer_kernel(jlp)
        em = emitted_from_fields(dataclasses.asdict(jem.spec), jem.t_run,
                                 jem.order, jem.layer_index)
        assert isinstance(em, EmittedConv)
        assert (em.t_run, em.order, em.grid_meta.grid, em.layer_index) == \
            (jem.t_run, jem.order, jem.grid_meta.grid, jem.layer_index)
        assert em.vmem_elements == kernel_vmem_elements(em.spec, em.t_run)
        x, w = _layer_arrays(rng, jem.spec)
        xt, wt = layer_from_numpy(x, w, device="cpu",
                                  dtype=TORCH_DTYPE[dtype])
        xj = jnp.asarray(x, JAX_DTYPE[dtype])
        wj = jnp.asarray(w, JAX_DTYPE[dtype])
        out = em.run(xt, wt)
        assert out.dtype == TORCH_DTYPE[dtype] and out.is_contiguous()
        assert bool(torch.isfinite(out.float()).all())
        _close(out, jem.run(xj, wj, interpret=True), dtype)
        _close(out, jref.conv2d(xj, wj, jem.spec.s_h, jem.spec.s_w), dtype)
        _close(out, ref.conv2d(xt, wt, em.spec.s_h, em.spec.s_w), dtype)


@pytest.mark.parametrize("name", list(SLICES))
def test_port_plans_and_runs_under_the_h100_budget(name):
    """The port's own main path: plan under ``H100_SXM``'s budget, emit
    every layer, run it, and get the oracle's convolution; ``ops.conv2d``
    (the second way in) gives the same."""
    rng = np.random.default_rng(12)
    specs = _specs(NETWORKS, name)
    hw = H100_SXM.as_hardware_model(dtype_bytes=4)
    plan = plan_emitable_network(specs, hw, name=name)
    assert plan.n_layers == len(specs) and plan.n_s2_layers == 0
    for lp in plan.layers:
        em = emit_layer_kernel(lp)
        assert em.vmem_elements <= hw.size_mem
        x, w = layer_from_numpy(*_layer_arrays(rng, lp.spec), device="cpu")
        want = ref.conv2d(x, w, lp.spec.s_h, lp.spec.s_w)
        assert tuple(want.shape) == \
            (lp.spec.c_out, lp.spec.h_out, lp.spec.w_out)
        _close(em.run(x, w), want, "float32")
        _close(ops.conv2d(x, w, s_h=lp.spec.s_h, s_w=lp.spec.s_w), want,
               "float32")


def test_layer_from_numpy_makes_contiguous_tensors_of_the_asked_type():
    rng = np.random.default_rng(13)
    x = np.asfortranarray(rng.standard_normal((2, 5, 6)))      # float64, F
    w = rng.standard_normal((3, 2, 3, 3)).astype(np.float32)
    xt, wt = layer_from_numpy(x, w, device="cpu", dtype=torch.bfloat16)
    assert xt.dtype == wt.dtype == torch.bfloat16
    assert xt.is_contiguous() and wt.is_contiguous()
    assert xt.device.type == "cpu"
    np.testing.assert_array_equal(
        xt.float().numpy(),
        torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy())
    with pytest.raises(KernelShapeError, match="want x"):
        layer_from_numpy(x[0], w, device="cpu")


def test_emitted_from_fields_refuses_what_no_grid_realises():
    fields = dict(c_in=2, h_in=10, w_in=12, n_kernels=3, h_k=3, w_k=3,
                  s_h=1, s_w=1)
    em = emitted_from_fields(fields, 5, "zigzag", 0)
    assert em.grid_meta.grid == (8, 2)
    with pytest.raises(KernelShapeError, match="must divide"):
        emitted_from_fields(fields, 4, "zigzag", 0)
    with pytest.raises(KernelShapeError, match="unknown grid order"):
        emitted_from_fields(fields, 5, "spiral", 0)
