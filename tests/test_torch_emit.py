"""Plan -> kernel emission in the port: the cases of ``tests/test_emit.py``
on ``repro_torch``, and the port's planner held against the reference's —
the same network under the same ``HardwareModel`` gives the same plan,
field by field (exact equality: both are the same integer and float
arithmetic)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro.configs.networks import NETWORKS as J_NETWORKS
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.kernels import emit as jemit
from repro_torch.configs.networks import NETWORKS
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import H100_SXM, HardwareModel
from repro_torch.core.strategies import row_by_row, tiled, zigzag
from repro_torch.kernels import KernelShapeError, ref
from repro_torch.kernels.conv2d_offload import planned_smem_elements
from repro_torch.kernels.emit import (
    KernelEmitError, emit_layer_kernel, grid_solve, kernel_vmem_elements,
    plan_emitable_network)
from repro_torch.reference_io import layer_from_numpy

SPEC = ConvSpec(2, 10, 12, 3, 3, 3)


def _network_budget(specs, cls=HardwareModel):
    """The budget the reference's kernel checker plans under: twice the
    largest kernel set."""
    return cls(nbop_pe=1 << 20,
               size_mem=2 * max(s.kernel_elements for s in specs))


# --------------------------------------------------------------------- #
# Strategy -> grid recognition
# --------------------------------------------------------------------- #

def test_as_grid_recognises_zigzag_and_row_sweeps():
    for t in (2, 5, SPEC.w_out):
        meta = zigzag(SPEC, t).as_grid()
        assert meta is not None
        assert (meta.t_run, meta.h_out, meta.w_out_tiles) == \
            (t, SPEC.h_out, SPEC.w_out // t)
        assert meta.order == "zigzag"
        assert meta.grid == (SPEC.h_out, SPEC.w_out // t)
    meta = row_by_row(SPEC, 5).as_grid()
    assert meta is not None and meta.order == "row"


def test_as_grid_rejects_non_grid_strategies():
    assert tiled(SPEC, 6).as_grid() is None            # 2-D tiles
    assert zigzag(SPEC, 7).as_grid() is None           # 7 does not divide 12
    zz = zigzag(SPEC, 4)
    shuffled = dataclasses.replace(
        zz, groups=list(reversed(zz.groups)))
    assert shuffled.as_grid() is None                  # right runs, bad order


# --------------------------------------------------------------------- #
# The footprint is the CUDA kernel's own
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("t_run", [1, 2, 5, 10])
def test_kernel_vmem_elements_is_what_the_cuda_kernel_allocates(t_run):
    """Λ + window + column delta + row delta, as the one block of
    ``conv2d_offload_planned.cu`` carves its shared memory; no output
    term, where the reference counts two double-buffered output blocks."""
    s = SPEC
    t_in = (t_run - 1) * s.s_w + s.w_k
    want = (s.kernel_elements + s.c_in * s.h_k * t_in
            + s.c_in * s.h_k * t_run * s.s_w
            + s.c_in * max(1, min(s.s_h, s.h_k)) * t_in)
    assert kernel_vmem_elements(s, t_run) == want
    assert kernel_vmem_elements(s, t_run) == planned_smem_elements(
        s.c_in, s.c_out, s.h_k, s.w_k, s.s_h, s.s_w, t_run)
    from repro.core.conv_spec import ConvSpec as JConvSpec
    jspec = JConvSpec(**dataclasses.asdict(s))
    assert jemit.kernel_vmem_elements(jspec, t_run) - want == \
        2 * s.c_out * t_run


def test_resnet8_deepest_layer_fits_one_blocks_shared_memory():
    spec = NETWORKS["resnet8"][-1]                     # 64x10x10 -> 64
    assert kernel_vmem_elements(spec, 8) * 4 == 163_840
    assert kernel_vmem_elements(spec, 8) * 4 <= H100_SXM.smem_bytes_per_block


# --------------------------------------------------------------------- #
# Emitable solving
# --------------------------------------------------------------------- #

def test_grid_solve_respects_kernel_vmem_budget():
    tight = HardwareModel(nbop_pe=1 << 20,
                          size_mem=kernel_vmem_elements(SPEC, 2))
    res = grid_solve(SPEC, 10, tight)
    meta = res.strategy.as_grid()
    assert meta is not None
    assert kernel_vmem_elements(SPEC, meta.t_run) <= tight.size_mem
    roomy = HardwareModel(nbop_pe=1 << 20, size_mem=10 ** 9)
    wide = grid_solve(SPEC, SPEC.w_out, roomy)
    assert wide.objective <= res.objective


def test_grid_solve_raises_when_nothing_fits():
    hw = HardwareModel(nbop_pe=1 << 20,
                       size_mem=kernel_vmem_elements(SPEC, 1) - 1)
    with pytest.raises(ValueError, match="no emitable"):
        grid_solve(SPEC, 4, hw)


def test_grid_solve_never_spills_a_kernel_set_that_does_not_fit():
    """Λ of a 512->512 3x3 layer is 9 MB in f32: no run length fits one
    block's shared memory, and the solve says so."""
    spec = ConvSpec(512, 6, 6, 512, 3, 3)
    with pytest.raises(ValueError, match="no emitable zigzag strategy fits"):
        grid_solve(spec, 4, H100_SXM.as_hardware_model(dtype_bytes=4))


# --------------------------------------------------------------------- #
# Emission refusals
# --------------------------------------------------------------------- #

def _planned_layer(spec=SPEC):
    hw = HardwareModel(nbop_pe=1 << 20,
                       size_mem=kernel_vmem_elements(spec, spec.w_out))
    plan = plan_emitable_network([spec], hw, name="one")
    return plan.layers[0]


def test_emit_refuses_s2_plans():
    lp = _planned_layer()
    bad = dataclasses.replace(
        lp, result=dataclasses.replace(lp.result, mode="s2"))
    with pytest.raises(KernelEmitError, match="swapping"):
        emit_layer_kernel(bad)


def test_emit_refuses_non_grid_strategies():
    lp = _planned_layer()
    bad = dataclasses.replace(
        lp, result=dataclasses.replace(lp.result, strategy=tiled(SPEC, 6)))
    with pytest.raises(KernelEmitError, match="not a uniform grid"):
        emit_layer_kernel(bad)


def test_emit_refuses_row_order_with_overlapping_rows():
    lp = _planned_layer()
    bad = dataclasses.replace(
        lp, result=dataclasses.replace(lp.result,
                                       strategy=row_by_row(SPEC, 5)))
    with pytest.raises(KernelEmitError, match="row-order"):
        emit_layer_kernel(bad)


def test_emit_allows_row_order_single_tile():
    spec = ConvSpec(1, 8, 6, 2, 3, 3)        # w_out == 4, one tile of 4
    lp = _planned_layer(spec)
    row = dataclasses.replace(
        lp, result=dataclasses.replace(lp.result,
                                       strategy=row_by_row(spec, 4)))
    emitted = emit_layer_kernel(row)
    assert emitted.order in ("zigzag", "row")
    assert emitted.t_run == 4


def test_emitted_run_checks_shapes_against_the_plan():
    emitted = emit_layer_kernel(_planned_layer())
    x = torch.zeros((2, 10, 12))
    w = torch.zeros((3, 2, 3, 3))
    with pytest.raises(KernelShapeError, match="input"):
        emitted.run(torch.zeros((2, 10, 13)), w)
    with pytest.raises(KernelShapeError, match="kernels"):
        emitted.run(x, torch.zeros((4, 2, 3, 3)))
    assert tuple(emitted.run(x, w).shape) == (3, 8, 10)


# --------------------------------------------------------------------- #
# End to end: emitted kernels reproduce the reference convolution
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["lenet5", "tight2", "tight4"])
def test_emitted_network_layers_match_reference(name):
    rng = np.random.default_rng(7)
    specs = list(NETWORKS[name])
    plan = plan_emitable_network(specs, _network_budget(specs), name=name)
    for lp in plan.layers:
        emitted = emit_layer_kernel(lp)
        spec = lp.spec
        x, w = layer_from_numpy(
            rng.standard_normal((spec.c_in, spec.h_in, spec.w_in)),
            rng.standard_normal((spec.c_out, spec.c_in, spec.h_k, spec.w_k)),
            device="cpu")
        out = emitted.run(x, w)
        exp = ref.conv2d(x, w, spec.s_h, spec.s_w)
        # f32 sums of at most 150 products, taken in another order
        np.testing.assert_allclose(out.numpy(), exp.numpy(),
                                   rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# The port plans what the reference plans
# --------------------------------------------------------------------- #

def _layer_fields(lp, emitted):
    return dict(
        mode=lp.mode, p=lp.p, t_run=emitted.t_run, order=emitted.order,
        grid=emitted.grid_meta.grid, strategy=lp.strategy.name,
        n_steps=lp.strategy.n_steps, groups=lp.strategy.groups,
        spec=dataclasses.astuple(lp.spec),
        gross_duration=lp.gross_duration, duration=lp.duration,
        objective=lp.result.objective, lower_bound=lp.result.lower_bound,
        reload_ok=lp.result.reload_ok,
        reuse_input=lp.reuse_input, reuse_output=lp.reuse_output)


def _budgets(name):
    specs = list(NETWORKS[name])
    h100 = H100_SXM.as_hardware_model(dtype_bytes=4)
    return [("2xLambda", dataclasses.asdict(_network_budget(specs))),
            ("H100_SXM f32", dataclasses.asdict(h100))]


@pytest.mark.parametrize("budget", [0, 1])
@pytest.mark.parametrize("name", ["lenet5", "resnet8", "tight2", "tight4"])
def test_port_and_reference_plan_the_same_network_alike(name, budget):
    _, hw_fields = _budgets(name)[budget]
    specs = list(NETWORKS[name])
    jspecs = list(J_NETWORKS[name])
    assert [dataclasses.astuple(s) for s in specs] == \
        [dataclasses.astuple(s) for s in jspecs]
    plan = plan_emitable_network(specs, HardwareModel(**hw_fields),
                                 name=name)
    jplan = jemit.plan_emitable_network(jspecs, JHardwareModel(**hw_fields),
                                        name=name)
    assert plan.n_layers == jplan.n_layers
    for lp, jlp in zip(plan.layers, jplan.layers):
        assert _layer_fields(lp, emit_layer_kernel(lp)) == \
            _layer_fields(jlp, jemit.emit_layer_kernel(jlp))
    assert plan.total_duration == jplan.total_duration
    assert plan.gross_duration == jplan.gross_duration
    assert plan.baseline_duration == jplan.baseline_duration


def test_resnet8_under_the_h100_budget_is_all_s1_zigzag():
    specs = list(NETWORKS["resnet8"])
    plan = plan_emitable_network(
        specs, H100_SXM.as_hardware_model(dtype_bytes=4), name="resnet8")
    emitted = [emit_layer_kernel(lp) for lp in plan.layers]
    assert [lp.mode for lp in plan.layers] == ["s1"] * 7
    assert [e.order for e in emitted] == ["zigzag"] * 7
    assert [e.t_run for e in emitted] == [16, 16, 16, 16, 16, 8, 8]
    assert [e.grid_meta.grid for e in emitted] == \
        [(32, 2), (32, 2), (32, 2), (16, 1), (16, 1), (8, 1), (8, 1)]
    assert max(e.vmem_elements for e in emitted) * 4 == 163_840


def test_port_fits_where_the_reference_budgets_output_blocks():
    """The one knowing difference: under a budget of exactly the port's
    footprint at ``t = w_out`` the port plans the full-row sweep, while
    the reference, which also counts two on-chip output blocks, must take
    a shorter run."""
    from repro.core.conv_spec import ConvSpec as JConvSpec
    size = kernel_vmem_elements(SPEC, SPEC.w_out)
    port = grid_solve(SPEC, SPEC.w_out,
                      HardwareModel(nbop_pe=1 << 20, size_mem=size))
    refr = jemit.grid_solve(JConvSpec(**dataclasses.asdict(SPEC)),
                            SPEC.w_out,
                            JHardwareModel(nbop_pe=1 << 20, size_mem=size))
    assert port.strategy.as_grid().t_run == SPEC.w_out
    assert refr.strategy.as_grid().t_run < SPEC.w_out
