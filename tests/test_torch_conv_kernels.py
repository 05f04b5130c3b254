"""The port's conv kernels against the JAX package and the oracles, on the
CPU: the same numpy inputs go through ``repro`` (Pallas, interpret mode)
and through ``repro_torch`` (on CPU tensors the wrappers run the plain
PyTorch versions that sit beside the CUDA kernels).

Tolerances.  float32: ``rtol = atol = 1e-4`` — both sides sum at most 576
products in f32, in another order.  bfloat16, compared in f32:
``rtol = 1.6e-2, atol = 1e-2`` — products and sum are exact in f32 on both
sides, so the results differ by the final rounding to bfloat16, one unit
in the last place (2**-7 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro.kernels import conv2d_offload as jconv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.networks import NETWORKS
from repro_torch.core import planner
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import H100_SXM
from repro_torch.core.strategies import row_by_row, zigzag
from repro_torch.kernels import KernelShapeError, ops, ref
from repro_torch.kernels import conv2d_offload as conv
from repro_torch.obs.counters import COUNTS
from repro_torch.reference_io import layer_from_numpy

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=1.6e-2, atol=1e-2)}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# tests/test_kernels.py:18-25 — the simple kernel through ops.conv2d
SIMPLE_CASES = [
    (1, 6, 6, 1, 3, 3, 1, 1, 2),
    (3, 12, 14, 5, 3, 3, 1, 1, 4),
    (2, 9, 11, 4, 2, 2, 1, 1, 5),
    (4, 16, 16, 8, 5, 5, 1, 1, 4),
    (2, 11, 13, 3, 3, 3, 2, 2, 3),
    (1, 8, 8, 2, 1, 1, 1, 1, 8),
]
# tests/test_kernels.py:149-157 — the planned kernel's geometry crossings
PLANNED_CASES = [
    (2, 10, 12, 3, 3, 3, 1, 1, 5),     # col-delta within rows + row turns
    (1, 9, 9, 2, 3, 3, 1, 1, 7),       # one tile per row: row-delta only
    (2, 11, 13, 3, 3, 3, 2, 2, 3),     # strides 2: every window disjoint rows
    (3, 12, 14, 4, 5, 3, 1, 2, 2),     # tall kernel, stride-2 columns
    (1, 8, 8, 2, 1, 1, 1, 1, 4),       # 1x1 kernel: full fetch per tile
    (2, 13, 11, 3, 3, 3, 3, 1, 9),     # s_h >= h_k: no row-to-row reuse
]


def _arrays(seed, c_in, h, w, n, kh, kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c_in, h, w)).astype(np.float32)
    k = rng.standard_normal((n, c_in, kh, kw)).astype(np.float32)
    return x, k


def _both(x, k, dtype):
    """The same arrays as tensors of the port (CPU) and as JAX arrays."""
    xt, kt = layer_from_numpy(x, k, device="cpu", dtype=TORCH_DTYPE[dtype])
    return xt, kt, jnp.asarray(x, JAX_DTYPE[dtype]), \
        jnp.asarray(k, JAX_DTYPE[dtype])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, dtype):
    assert got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


# ------------------------- simple kernel (K2) ------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,h,w,n,kh,kw,sh,sw,t_run", SIMPLE_CASES)
def test_ops_conv2d_matches_jax_kernel_and_oracles(c_in, h, w, n, kh, kw,
                                                   sh, sw, t_run, dtype):
    x, k = _arrays(42, c_in, h, w, n, kh, kw)
    xt, kt, xj, kj = _both(x, k, dtype)
    out = ops.conv2d(xt, kt, t_run=t_run, s_h=sh, s_w=sw)
    assert out.dtype == TORCH_DTYPE[dtype]
    _close(out, jops.conv2d(xj, kj, t_run=t_run, s_h=sh, s_w=sw), dtype)
    _close(out, jref.conv2d(xj, kj, sh, sw), dtype)
    _close(out, ref.conv2d(xt, kt, sh, sw), dtype)


@pytest.mark.parametrize("order", ["zigzag", "row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_conv2d_orders_dtypes(order, dtype):
    x, k = _arrays(43, 2, 10, 12, 3, 3, 3)
    xt, kt, xj, kj = _both(x, k, dtype)
    out = ops.conv2d(xt, kt, t_run=5, order=order)
    _close(out, jops.conv2d(xj, kj, t_run=5, order=order), dtype)
    _close(out, ref.conv2d(xt, kt), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_conv2d_planner_chooses_t_run(dtype):
    """``t_run=None``: the port asks its own planner (H100 budget), the
    reference its own; the run lengths may differ, the result may not."""
    x, k = _arrays(44, 2, 10, 12, 3, 3, 3)
    xt, kt, xj, kj = _both(x, k, dtype)
    out = ops.conv2d(xt, kt)
    assert tuple(out.shape) == (3, 8, 10)
    _close(out, jops.conv2d(xj, kj), dtype)
    _close(out, ref.conv2d(xt, kt), dtype)


def test_ops_conv2d_pads_when_t_run_does_not_divide():
    x, k = _arrays(45, 2, 9, 13, 3, 3, 3)          # w_out = 11
    xt, kt, xj, kj = _both(x, k, "float32")
    out = ops.conv2d(xt, kt, t_run=4)              # padded to 12, cut to 11
    assert tuple(out.shape) == (3, 7, 11)
    _close(out, jops.conv2d(xj, kj, t_run=4), "float32")


def test_ops_conv2d_dispatches_to_the_simple_kernel(monkeypatch):
    """As in the reference (``ops.py:50``), ``ops.conv2d`` reaches the
    simple kernel; only ``EmittedConv.run`` reaches the planned one."""
    seen = []
    real = conv.conv2d_offload
    monkeypatch.setattr(conv, "conv2d_offload",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    monkeypatch.setattr(
        conv, "conv2d_offload_planned",
        lambda *a, **kw: pytest.fail("ops.conv2d reached the planned kernel"))
    x, k = _arrays(46, 1, 6, 6, 1, 3, 3)
    xt, kt = layer_from_numpy(x, k, device="cpu")
    ops.conv2d(xt, kt, t_run=2)
    assert len(seen) == 1 and seen[0]["t_run"] == 2


# ------------------------- planned kernel (K1) ------------------------ #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["zigzag", "row"])
@pytest.mark.parametrize("c_in,h,w,n,kh,kw,sh,sw,t_run", PLANNED_CASES)
def test_planned_matches_jax_kernel_and_oracles(order, c_in, h, w, n, kh, kw,
                                                sh, sw, t_run, dtype):
    x, k = _arrays(47, c_in, h, w, n, kh, kw)
    xt, kt, xj, kj = _both(x, k, dtype)
    kw_ = dict(t_run=t_run, s_h=sh, s_w=sw, order=order)
    out = conv.conv2d_offload_planned(xt, kt, **kw_)
    assert out.dtype == TORCH_DTYPE[dtype]
    _close(out, jconv.conv2d_offload_planned(xj, kj, interpret=True, **kw_),
           dtype)
    _close(out, jref.conv2d(xj, kj, sh, sw), dtype)
    _close(out, ref.conv2d(xt, kt, sh, sw), dtype)
    # the two kernels of the port agree with each other as well
    _close(out, conv.conv2d_offload(xt, kt, **kw_), dtype)


@pytest.mark.parametrize("order", ["zigzag", "row"])
@pytest.mark.parametrize("c_in,h,w,n,kh,kw,sh,sw,t_run", PLANNED_CASES)
def test_planned_plain_fetches_are_step_case_boxes(order, c_in, h, w, n, kh,
                                                   kw, sh, sw, t_run):
    """The plain version really slices, step by step, the box that
    ``step_case`` names — same case names as the reference's
    ``step_case`` — and every box lies inside the input."""
    x, k = _arrays(48, c_in, h, w, n, kh, kw)
    xt, kt = layer_from_numpy(x, k, device="cpu")
    out, fetches = conv.conv2d_offload_planned_plain(
        xt, kt, t_run=t_run, s_h=sh, s_w=sw, order=order,
        return_fetches=True)
    _close(out, ref.conv2d(xt, kt, sh, sw), "float32")
    h_out = (h - kh) // sh + 1
    tiles = ((w - kw) // sw + 1) // t_run
    seq = conv.grid_sequence(h_out, tiles)
    assert seq == jconv.grid_sequence(h_out, tiles)
    assert len(fetches) == len(seq)
    geo = dict(t_run=t_run, s_h=sh, s_w=sw, h_k=kh, w_k=kw,
               w_out_tiles=tiles, order=order)
    t_in = conv.t_in_cols(t_run, sw, kw)
    for (i, jt), (case, h0, h1, w0, w1) in zip(seq, fetches):
        assert case == conv.step_case(i, jt, **geo)
        assert case == jconv.step_case(i, jt, **geo)
        assert 0 <= h0 < h1 <= h and 0 <= w0 < w1 <= w
        want = {conv.CASE_FULL: (kh, t_in), conv.CASE_ROW: (sh, t_in),
                conv.CASE_COL: (kh, t_run * sw)}[case]
        assert (h1 - h0, w1 - w0) == want
        tile = conv.eff_tile(i, jt, tiles, order == "zigzag")
        assert tile == jconv.eff_tile(i, jt, tiles, order == "zigzag")


@pytest.mark.parametrize("c_in,h,w,n,kh,kw,sh,sw,t_run", PLANNED_CASES)
def test_planned_plain_fetch_total_is_the_plans_charged_loads(
        c_in, h, w, n, kh, kw, sh, sw, t_run):
    """Traffic contract: over a zigzag sweep the boxes the plain version
    fetched hold exactly the pixels the plan charges to ``t_l``
    (``pixels_loaded() * c_in`` elements), step by step."""
    x, k = _arrays(49, c_in, h, w, n, kh, kw)
    xt, kt = layer_from_numpy(x, k, device="cpu")
    _, fetches = conv.conv2d_offload_planned_plain(
        xt, kt, t_run=t_run, s_h=sh, s_w=sw, order="zigzag",
        return_fetches=True)
    spec = ConvSpec(c_in, h, w, n, kh, kw, sh, sw)
    strat = zigzag(spec, t_run)
    assert strat.as_grid() is not None
    fetched = [(h1 - h0) * (w1 - w0) for _, h0, h1, w0, w1 in fetches]
    charged, prev = [], 0
    for g in strat.groups:
        cur = spec.group_mask(g)
        charged.append((cur & ~prev).bit_count())
        prev = cur
    assert fetched == charged
    assert sum(fetched) * c_in == strat.pixels_loaded() * c_in


def test_planned_plain_row_order_with_overlap_refetches_full_windows():
    """Why ``emit`` refuses row order with overlapping rows and several
    tiles: at each row turn the kernel fetches a full window, more than
    the plan charges."""
    spec = ConvSpec(2, 10, 12, 3, 3, 3)
    x, k = _arrays(50, 2, 10, 12, 3, 3, 3)
    xt, kt = layer_from_numpy(x, k, device="cpu")
    _, fetches = conv.conv2d_offload_planned_plain(
        xt, kt, t_run=5, order="row", return_fetches=True)
    fetched = sum((h1 - h0) * (w1 - w0) for _, h0, h1, w0, w1 in fetches)
    assert fetched > row_by_row(spec, 5).pixels_loaded()


def test_plain_versions_never_count_as_launches():
    before = dict(COUNTS)
    x, k = _arrays(51, 2, 10, 12, 3, 3, 3)
    xt, kt = layer_from_numpy(x, k, device="cpu")
    conv.conv2d_offload(xt, kt, t_run=5)
    conv.conv2d_offload_planned(xt, kt, t_run=5)
    assert COUNTS == before
    assert {"conv2d_offload", "conv2d_offload_planned"} <= set(before)


# ----------------------------- typed errors --------------------------- #

def test_kernel_geometry_errors_are_typed():
    """tests/test_kernels.py:171-186 for the conv kernels, same messages
    as the reference raises."""
    x = torch.zeros((2, 8, 8))
    k = torch.zeros((3, 2, 3, 3))
    xj, kj = jnp.zeros((2, 8, 8)), jnp.zeros((3, 2, 3, 3))
    with pytest.raises(KernelShapeError, match="unknown grid order"):
        conv.conv2d_offload_planned(x, k, t_run=4, order="spiral")
    with pytest.raises(KernelShapeError) as e_port:    # 4 does not divide 6
        conv.conv2d_offload_planned(x, k, t_run=4, order="zigzag")
    with pytest.raises(jconv.KernelShapeError) as e_ref:
        jconv.conv2d_offload_planned(xj, kj, t_run=4, order="zigzag",
                                     interpret=True)
    assert str(e_port.value) == str(e_ref.value)
    with pytest.raises(KernelShapeError) as e_port:    # channel mismatch
        conv.conv2d_offload(x, torch.zeros((3, 1, 3, 3)), t_run=3)
    with pytest.raises(jconv.KernelShapeError) as e_ref:
        jconv.conv2d_offload(xj, jnp.zeros((3, 1, 3, 3)), t_run=3,
                             interpret=True)
    assert str(e_port.value) == str(e_ref.value)
    with pytest.raises(KernelShapeError, match="does not fit"):
        conv.conv2d_offload(torch.zeros((2, 2, 8)), k, t_run=3)
    assert issubclass(KernelShapeError, ValueError)


@pytest.mark.parametrize("fn", [conv.conv2d_offload,
                                conv.conv2d_offload_planned])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn):
    x = torch.zeros((2, 8, 8))
    k = torch.zeros((3, 2, 3, 3))
    with pytest.raises(KernelShapeError, match="float32 or both bfloat16"):
        fn(x.double(), k.double(), t_run=3)
    with pytest.raises(KernelShapeError, match="float32 or both bfloat16"):
        fn(x, k.bfloat16(), t_run=3)
    with pytest.raises(KernelShapeError, match="contiguous"):
        fn(torch.zeros((2, 8, 16))[:, :, ::2], k, t_run=3)
    with pytest.raises(KernelShapeError, match="want x"):
        fn(x[None], k, t_run=3)


# ------------------------------- planner ------------------------------ #

def test_plan_conv_budgets_the_simple_kernels_shared_memory():
    spec = ConvSpec(3, 64, 64, 8, 3, 3)
    p = planner.plan_conv(spec, dtype_bytes=4)
    t = p.tiles["t"]
    assert t > 1                               # grouping beats S1-baseline
    # the window, then each reduction group's f32 partial (8, t) block
    # from a 16-byte boundary
    window = 3 * 3 * ((t - 1) + 3) * 4
    kg = planner.conv_simple_k_groups(t, 8, 27)
    assert kg > 1
    assert p.smem_bytes == -(-window // 16) * 16 + 4 * kg * t * 8
    assert p.smem_bytes <= H100_SXM.smem_bytes_per_block
    assert p.duration_overlapped <= p.duration_additive


@pytest.mark.parametrize("spec", list(NETWORKS["resnet8"])
                         + [ConvSpec(128, 6, 6, 256, 3, 3)],
                         ids=lambda s: f"{s.c_in}x{s.h_in}->{s.c_out}")
def test_the_simple_kernel_splits_its_sum_over_groups_of_threads(spec):
    """K2 at the run length the planner gives: the reduction is split over
    groups of threads, one thread per 4 x 4 tile of the output block in
    each group and each group at least four terms deep; at every ResNet-8
    layer that is 4-8 groups, and the partial blocks fit beside the
    window."""
    p = planner.plan_conv(spec, dtype_bytes=4)
    t = p.tiles["t"]
    k_total = spec.c_in * spec.h_k * spec.w_k
    kg = planner.conv_simple_k_groups(t, spec.c_out, k_total)
    tiles = -(-t // 4) * -(-spec.c_out // 4)
    assert kg * tiles <= planner.CONV_SIMPLE_THREADS or kg == 1
    assert kg == 1 or k_total // kg >= planner.CONV_SIMPLE_MIN_K
    if spec.c_out <= 64:
        assert kg in (4, 8)
    assert p.smem_bytes == planner.conv_simple_smem_bytes(spec, t, 4) \
        <= H100_SXM.smem_bytes_per_block


def test_plan_conv_refuses_a_window_no_block_can_hold():
    spec = ConvSpec(4096, 8, 8, 1, 5, 5)       # 4096*5*5 f32 > 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        planner.plan_conv(spec, dtype_bytes=4)


def test_h100_preset_is_the_cards_own():
    """Data-sheet constants of the H100 SXM; none is the TPU preset's."""
    from repro_torch.core.cost_model import TPU_V5E
    assert H100_SXM.smem_bytes_per_block == 232_448
    assert H100_SXM.n_sms == 132
    assert H100_SXM.hbm_bw == 3.35e12
    assert H100_SXM.peak_flops == 989e12
    assert H100_SXM.nvlink_bw_per_dir == 450e9
    hw = H100_SXM.as_hardware_model(dtype_bytes=4)
    assert hw.size_mem == 232_448 // 4
    assert hw.t_l == hw.t_w == 4 / 3.35e12
    assert hw.size_mem != TPU_V5E.as_hardware_model(4).size_mem
    cl = H100_SXM.as_cluster(4, dtype_bytes=2)
    assert cl.n_chips == 4 and cl.t_ici == 2 / 450e9
    assert cl.chip == H100_SXM.as_hardware_model(2)


# ------------------------ K1's cluster of blocks ---------------------- #

@pytest.mark.parametrize("n,cs", [(6, 1), (8, 1), (16, 2), (24, 2), (32, 4),
                                  (64, 8), (128, 8)])
def test_conv_cluster_size_is_one_rule_of_the_channel_count(n, cs):
    """The channel split ``cs_n``: the largest power of two up to 8 that
    divides N and leaves every group at least 8 kernel channels, whatever
    the run length."""
    for t_run in (1, 2, 5, 8, 16, 64):
        cs_n, cs_t = planner.conv_cluster_shape(n, t_run)
        assert cs_n == cs
        assert cs_n * cs_t <= planner.CONV_MAX_CLUSTER
    assert n % cs == 0 and (cs == 1 or n // cs >= 8)


@pytest.mark.parametrize("n,t_run,shape", [
    (16, 16, (2, 4)), (32, 16, (4, 2)), (64, 8, (8, 1)),    # ResNet-8
    (6, 14, (1, 2)), (16, 10, (2, 2)),                      # LeNet-5
    (8, 10, (1, 2)), (16, 8, (2, 2)), (32, 6, (4, 1)),      # tight nets
    (8, 32, (1, 8)), (8, 7, (1, 1)), (3, 5, (1, 1)),
    (16, 4, (2, 1)), (24, 12, (2, 2)), (8, 24, (1, 4))])
def test_conv_cluster_shape_is_one_rule_of_channels_and_columns(
        n, t_run, shape):
    """``cs_t``: the largest power of two that divides ``t_run``, leaves
    every block at least 4 output columns and keeps the cluster at 8
    blocks; a ragged run length keeps its step on one column group."""
    assert planner.conv_cluster_shape(n, t_run) == shape
    cs_n, cs_t = shape
    assert t_run % cs_t == 0 and (cs_t == 1 or t_run // cs_t >= 4)
    assert cs_n * cs_t <= planner.CONV_MAX_CLUSTER
    # no larger column split would do
    assert not (cs_n * cs_t * 2 <= 8 and t_run % (2 * cs_t) == 0
                and t_run // (2 * cs_t) >= 4)


@pytest.mark.parametrize("cs", [1, 2, 4, 8])
@pytest.mark.parametrize("elements", [1, 7, 48, 54, 125])
def test_fetch_shares_are_disjoint_and_cover_the_box(elements, cs):
    shares = conv.fetch_shares(elements, cs)
    assert len(shares) == cs
    assert shares[0][0] == 0 and shares[-1][1] == elements
    for (lo, hi), (lo2, _) in zip(shares, shares[1:]):
        assert lo <= hi == lo2
    sizes = [hi - lo for lo, hi in shares]
    assert max(sizes) - min(sizes) <= 1
    assert max(sizes) == -(-elements // cs)


def _clusters(n, t_run):
    """The rule's cluster for (n, t_run) and the forced ones a test also
    runs: one block, all channel groups, all column groups, and a mix."""
    out = {planner.conv_cluster_shape(n, t_run), (1, 1)}
    for cs_n, cs_t in ((8, 1), (1, 8), (2, 4), (4, 2), (2, 2)):
        while cs_n > 1 and n % cs_n:
            cs_n //= 2
        while cs_t > 1 and t_run % cs_t:
            cs_t //= 2
        out.add((cs_n, cs_t))
    return sorted(out)


@pytest.mark.parametrize("order", ["zigzag", "row"])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("c_in,h,w,_n,kh,kw,sh,sw,t_run", PLANNED_CASES
                         + [(3, 9, 34, 16, 3, 3, 1, 1, 16),
                            (2, 8, 18, 32, 3, 3, 1, 1, 8)])
def test_planned_plain_shares_split_each_step_box_over_the_cluster(
        order, n, c_in, h, w, _n, kh, kw, sh, sw, t_run):
    """The box the kernel's cluster splits into shares at each step is
    ``step_fetch_box``'s; the plain version, as the kernel, takes one
    ``fetch_shares`` share per rank, which cover the box once, and writes
    one (channel group x column group) block per rank, which cover the
    step's output block once.  Its output does not depend on the cluster,
    the rule's or a forced one of 1 to 8 blocks."""
    x, k = _arrays(52, c_in, h, w, n, kh, kw)
    xt, kt = layer_from_numpy(x, k, device="cpu")
    kw_ = dict(t_run=t_run, s_h=sh, s_w=sw, order=order)
    want = ref.conv2d(xt, kt, sh, sw)
    tiles = ((w - kw) // sw + 1) // t_run
    geo = dict(t_run=t_run, s_h=sh, s_w=sw, h_k=kh, w_k=kw,
               w_out_tiles=tiles, order=order)
    steps = conv.grid_sequence((h - kh) // sh + 1, tiles)
    for cluster in _clusters(n, t_run):
        cs = cluster[0] * cluster[1]
        ledger = []
        out, fetches = conv.conv2d_offload_planned_plain(
            xt, kt, return_fetches=True, cluster=cluster, ledger=ledger,
            **kw_)
        _close(out, want, "float32")
        assert len(fetches) == len(steps) and len(ledger) == len(steps) * cs
        for s, ((i, jt), box) in enumerate(zip(steps, fetches)):
            assert box == conv.step_fetch_box(i, jt, **geo)
            _, h0, h1, w0, w1 = box
            rows = [e for e in ledger if e[0] == s]
            assert [e[1] for e in rows] == list(range(cs))
            shares = sorted(e[2] for e in rows)
            at = 0
            for lo, hi in shares:
                assert lo == at
                at = hi
            assert at == c_in * (h1 - h0) * (w1 - w0)
            tile = conv.eff_tile(i, jt, tiles, order == "zigzag")
            written = np.zeros((n, t_run), dtype=int)
            for _, _, _, (c0, c1), (j0, j1) in rows:
                written[c0:c1, j0 - tile * t_run:j1 - tile * t_run] += 1
            assert (written == 1).all()
    # seven of the kernel channels run as one channel group: the same sums
    out1 = conv.conv2d_offload_planned_plain(xt, kt[:7].contiguous(), **kw_)
    assert planner.conv_cluster_shape(7, t_run)[0] == 1
    _close(out1, want[:7], "float32")
