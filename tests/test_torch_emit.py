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
from repro_torch.core import planner
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import H100_SXM, HardwareModel
from repro_torch.core.strategies import row_by_row, tiled, zigzag
from repro_torch.kernels import KernelShapeError, ref
from repro_torch.kernels import conv2d_offload
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

def _parts(ts, nr, k_total):
    """The bfloat16 product's f32 partial tiles, in elements: one (ts x
    nr) tile for each warp that splits a 16 x 8 output tile's k chunks of
    16 (as many as 8 warps spread over the tiles, at most one a chunk),
    none without a split."""
    tiles = -(-ts // 16) * -(-nr // 8)
    split = 1 if tiles >= 8 else min(8 // tiles, -(-k_total // 16))
    assert split == conv2d_offload.conv_k_split(ts, nr, k_total)
    return 2 * split * ts * nr if split > 1 else 0


@pytest.mark.parametrize("t_run", [1, 2, 5, 10])
def test_kernel_vmem_elements_is_what_the_cuda_kernel_allocates(t_run):
    """What one block of ``conv2d_offload_planned.cu``'s cluster carves
    out of its shared memory: its ``1/cs_n`` of Λ, the window, a pad to a
    multiple of 8 elements, a ring of two slots each holding the larger of
    the column-delta and row-delta boxes (its cs shares each from a
    multiple of 8 elements, so that a bulk copy can push it) and the
    bfloat16 product's f32 partial tiles (two elements a value); no
    output term,
    where the reference counts two double-buffered output blocks and one
    buffer for each delta.  ``SPEC`` has 3 kernel channels: one channel
    group; a run of 10 columns splits into two column groups."""
    s = SPEC
    cs_n, cs_t = planner.conv_cluster_shape(s.c_out, t_run)
    assert (cs_n, cs_t) == ((1, 2) if t_run == 10 else (1, 1))
    t_in = (t_run - 1) * s.s_w + s.w_k
    col = s.c_in * s.h_k * t_run * s.s_w
    row = s.c_in * max(1, min(s.s_h, s.h_k)) * t_in
    share = -(-(-(-max(col, row) // cs_t)) // 8) * 8
    window = s.c_in * s.h_k * t_in
    pad = -(s.kernel_elements + window) % 8
    parts = _parts(t_run // cs_t, s.c_out, s.c_in * s.h_k * s.w_k)
    want = s.kernel_elements + window + pad + 2 * cs_t * share + parts
    assert kernel_vmem_elements(s, t_run) == want
    assert kernel_vmem_elements(s, t_run) == planned_smem_elements(
        s.c_in, s.c_out, s.h_k, s.w_k, s.s_h, s.s_w, t_run)
    from repro.core.conv_spec import ConvSpec as JConvSpec
    jspec = JConvSpec(**dataclasses.asdict(s))
    assert jemit.kernel_vmem_elements(jspec, t_run) - want == \
        2 * s.c_out * t_run + col + row - 2 * cs_t * share - parts - pad


@pytest.mark.parametrize("spec", list(NETWORKS["resnet8"]),
                         ids=lambda s: f"{s.c_in}x{s.h_in}->{s.c_out}")
def test_kernel_vmem_elements_is_one_blocks_share_of_the_cluster(spec):
    """ResNet-8's layers run clusters of 2 x 4, 4 x 2 and 8 x 1 blocks:
    each block holds ``N / cs_n`` of Λ's columns, the whole window, a ring
    of two slots of the 16 (or 8) new columns of a within-row move (larger
    than the new row of a row turn), each share of a slot from a multiple
    of 8 elements, and eight f32 partial tiles of its (t_run/cs_t x
    N/cs_n) part of a step (one 16 x 8 output tile, its k chunks split
    over the 8 warps; two for the first layer's 27 taps)."""
    t_run = 16 if spec.w_out >= 16 else 8
    cs_n, cs_t = planner.conv_cluster_shape(spec.c_out, t_run)
    assert (cs_n, cs_t) == {16: (2, 4), 32: (4, 2), 64: (8, 1)}[spec.c_out]
    cs = cs_n * cs_t
    assert cs == 8
    t_in = t_run + 2
    col = spec.c_in * 3 * t_run
    row = spec.c_in * 1 * t_in
    assert col > row
    share = -(-(-(-col // cs)) // 8) * 8
    lam, window = spec.kernel_elements // cs_n, spec.c_in * 3 * t_in
    parts = _parts(t_run // cs_t, spec.c_out // cs_n, spec.c_in * 9)
    split = 2 if spec.c_in == 3 else 8          # 27 taps: two chunks
    assert parts == 2 * split * (t_run // cs_t) * (spec.c_out // cs_n)
    want = lam + window + -(lam + window) % 8 + 2 * cs * share + parts
    assert kernel_vmem_elements(spec, t_run) == want


def test_resnet8_deepest_layer_fits_one_blocks_shared_memory():
    spec = NETWORKS["resnet8"][-1]                     # 64x10x10 -> 64
    assert kernel_vmem_elements(spec, 8) * 4 == 42_496
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
    assert max(e.vmem_elements for e in emitted) * 4 == 42_496
    assert [planner.conv_cluster_shape(lp.spec.c_out, e.t_run)
            for lp, e in zip(plan.layers, emitted)] == \
        [(2, 4)] * 3 + [(4, 2)] * 2 + [(8, 1)] * 2


def test_port_budgets_its_ring_where_the_reference_budgets_output_blocks():
    """The knowing difference: the reference counts two on-chip output
    blocks and one buffer per delta, the port a ring of two whole boxes
    and the f32 sums of its column group.  On ``SPEC`` (one channel group,
    two column groups at ``t = w_out``) the port's occupancy is the larger
    one: under a budget of exactly the reference's footprint at ``t =
    w_out`` the reference plans the full-row sweep, while the port must
    take a shorter run."""
    from repro.core.conv_spec import ConvSpec as JConvSpec
    jspec = JConvSpec(**dataclasses.asdict(SPEC))
    size = jemit.kernel_vmem_elements(jspec, SPEC.w_out)
    assert kernel_vmem_elements(SPEC, SPEC.w_out) > size
    port = grid_solve(SPEC, SPEC.w_out,
                      HardwareModel(nbop_pe=1 << 20, size_mem=size))
    refr = jemit.grid_solve(jspec, SPEC.w_out,
                            JHardwareModel(nbop_pe=1 << 20, size_mem=size))
    assert refr.strategy.as_grid().t_run == SPEC.w_out
    assert port.strategy.as_grid().t_run < SPEC.w_out


# --------------------------------------------------------------------- #
# grid_solve's budget: the plan's peak footprint, as plan_network checks
# --------------------------------------------------------------------- #

# budgets of 0.5-5 times a layer's kernel set, and none
BUDGET_MULTS = (0.5, 1, 1.5, 2, 2.5, 3, 3.5, 4, 5, None)
ALL_LAYERS = [(name, i) for name in ("lenet5", "resnet8", "tight2", "tight4")
              for i in range(len(NETWORKS[name]))]


def _one_layer_plans(spec, jspec, size):
    """(the port plans it, the reference plans it) as a one-layer
    network under ``size_mem = size``."""
    from repro.core.network_planner import \
        InfeasibleNetworkError as JInfeasible
    from repro_torch.core.network_planner import InfeasibleNetworkError
    try:
        plan_emitable_network([spec], HardwareModel(nbop_pe=1 << 20,
                                                    size_mem=size),
                              name="one")
        port = True
    except InfeasibleNetworkError:
        port = False
    try:
        jemit.plan_emitable_network([jspec], JHardwareModel(
            nbop_pe=1 << 20, size_mem=size), name="one")
        refr = True
    except JInfeasible:
        refr = False
    return port, refr


@pytest.mark.parametrize("name,index", ALL_LAYERS,
                         ids=[f"{n}-L{i}" for n, i in ALL_LAYERS])
def test_grid_solve_keeps_the_plans_peak_within_size_mem(name, index):
    """At every budget the port's ``grid_solve`` either raises or returns
    a sweep whose Def-3 peak footprint fits ``size_mem`` (the check
    ``plan_network`` makes after the solve), and as a one-layer network
    the port plans every case the reference plans."""
    spec = NETWORKS[name][index]
    jspec = J_NETWORKS[name][index]
    for mult in BUDGET_MULTS:
        size = None if mult is None else int(mult * spec.kernel_elements)
        hw = HardwareModel(nbop_pe=1 << 20, size_mem=size)
        try:
            res = grid_solve(spec, spec.w_out, hw)
        except ValueError:
            res = None
        if res is not None and size is not None:
            assert res.strategy.peak_footprint_elements() <= size, mult
            assert kernel_vmem_elements(
                spec, res.strategy.as_grid().t_run) <= size, mult
        port, refr = _one_layer_plans(spec, jspec, size)
        assert port or not refr, (mult, size)
        assert port == (res is not None), (mult, size)


@pytest.mark.parametrize("name,size,ref_t", [("resnet8", 1000, 8),
                                             ("tight4", 144, 2)])
def test_layer_zero_plans_where_the_plan_peak_alone_limits(name, size,
                                                           ref_t):
    """ResNet-8's 3->16 layer at 1000 elements and tight4's 1->8 layer at
    144: the kernel's own occupancy admits a longer run than the plan's
    peak does, and the port used to pick it and fail in ``plan_network``.
    It now plans a run whose peak fits, as the reference does."""
    spec = NETWORKS[name][0]
    jspec = J_NETWORKS[name][0]
    hw = HardwareModel(nbop_pe=1 << 20, size_mem=size)
    res = grid_solve(spec, spec.w_out, hw)
    assert res.strategy.peak_footprint_elements() <= size
    plan = plan_emitable_network([spec], hw, name=name)
    emitted = emit_layer_kernel(plan.layers[0])
    assert emitted.t_run == res.strategy.as_grid().t_run
    assert emitted.order == "zigzag"
    jplan = jemit.plan_emitable_network(
        [jspec], JHardwareModel(nbop_pe=1 << 20, size_mem=size), name=name)
    assert jemit.emit_layer_kernel(jplan.layers[0]).t_run == ref_t
    # the longest run the kernel's occupancy alone admits is refused:
    # its peak exceeds the budget
    longest = max(t for t in range(1, spec.w_out + 1)
                  if spec.w_out % t == 0
                  and kernel_vmem_elements(spec, t) <= size)
    assert zigzag(spec, longest).peak_footprint_elements() > size
