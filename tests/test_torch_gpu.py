"""Tests that need the card: the CUDA kernels against their plain PyTorch
versions on CUDA tensors.  Marked ``gpu``; without a CUDA device they skip
(decided inside the fixture, never at import).  Run them on a machine with
an NVIDIA GPU and ``nvcc``::

    python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` makes the same comparisons at full width (ResNet-8's
layers, TinyLlama-1.1B's projections and decode attention, the graph-
replayed decode step of every id of the registry).
"""
import ctypes
import itertools

import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro_torch.analysis import kerncheck
from repro_torch.configs.networks import NETWORKS
from repro_torch.core.cost_model import H100_SXM
from repro_torch.core import planner
from repro_torch.core.planner import (conv_cluster_shape, decode_smem_bytes,
                                      matmul_smem_bytes)
from repro_torch.kernels import KernelShapeError, _build, ops, ref
from repro_torch.kernels import block_matmul as bm
from repro_torch.kernels import conv2d_offload as conv
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.emit import emit_layer_kernel, plan_emitable_network
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.models.common import leaves
from repro_torch.obs import adapters, spans
from repro_torch.obs.counters import COUNTS
from repro_torch.reference_io import layer_from_numpy
from repro_torch.sim import ConvLayer, simulate_network

pytestmark = pytest.mark.gpu

# float32: f32 sums of O(1) terms in another order; bfloat16: one final
# rounding to bfloat16 apart (products and sums are f32 on both sides).
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}

CASES = [
    (2, 10, 12, 3, 3, 3, 1, 1, 5),
    (1, 9, 9, 2, 3, 3, 1, 1, 7),
    (2, 11, 13, 3, 3, 3, 2, 2, 3),
    (3, 12, 14, 4, 5, 3, 1, 2, 2),
    (1, 8, 8, 2, 1, 1, 1, 1, 4),
    (2, 13, 11, 3, 3, 3, 3, 1, 9),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["zigzag", "row"])
@pytest.mark.parametrize("c_in,h,w,n,kh,kw,sh,sw,t_run", CASES)
def test_cuda_kernels_match_their_plain_versions(card, order, c_in, h, w, n,
                                                 kh, kw, sh, sw, t_run,
                                                 dtype):
    rng = np.random.default_rng(5)
    x, k = layer_from_numpy(rng.standard_normal((c_in, h, w)),
                            rng.standard_normal((n, c_in, kh, kw)),
                            device=card, dtype=dtype)
    kw_ = dict(t_run=t_run, s_h=sh, s_w=sw, order=order)
    before = dict(COUNTS)
    for name, kernel, plain in (
            ("conv2d_offload", conv.conv2d_offload,
             conv.conv2d_offload_plain),
            ("conv2d_offload_planned", conv.conv2d_offload_planned,
             conv.conv2d_offload_planned_plain)):
        got = kernel(x, k, **kw_)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == dtype
        assert COUNTS[name] == before[name] + 1
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   plain(x, k, **kw_).float().cpu().numpy(),
                                   **TOL[dtype])


def test_planned_kernel_refuses_more_than_one_blocks_shared_memory(card):
    """The limit is one block's share: Λ of 512 -> 512 3x3 kernels is 9 MB,
    its eighth 1.2 MB, refused; Λ of 128 -> 64 is 294 912 bytes, more than
    one block holds, but its eighth fits, and the kernel runs."""
    x = torch.zeros((512, 6, 6), device=card)
    k = torch.zeros((512, 512, 3, 3), device=card)       # Λ alone is 9 MB
    with pytest.raises(KernelShapeError, match="shared memory"):
        conv.conv2d_offload_planned(x, k, t_run=4)
    rng = np.random.default_rng(12)
    x, k = layer_from_numpy(rng.standard_normal((128, 6, 6)),
                            rng.standard_normal((64, 128, 3, 3)), device=card)
    assert k.numel() * 4 > conv.SMEM_LIMIT_BYTES
    got = conv.conv2d_offload_planned(x, k, t_run=4)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        got.cpu().numpy(),
        conv.conv2d_offload_planned_plain(x, k, t_run=4).cpu().numpy(),
        rtol=1e-4, atol=1e-4)


def _resnet8_layers():
    plan = plan_emitable_network(list(NETWORKS["resnet8"]),
                                 H100_SXM.as_hardware_model(dtype_bytes=4),
                                 name="resnet8")
    return [(lp, emit_layer_kernel(lp)) for lp in plan.layers]


# the planned kernel's cluster of 1, 2, 4 and 8 channel groups: the
# geometry cases with N = 8, 16, 32, 64 kernel channels, and every ResNet-8
# layer at its planned run length (N = 16, 32, 64; 2 x 4, 4 x 2 and 8 x 1
# blocks)
CLUSTER_CASES = [case[:3] + (n,) + case[4:] for case in CASES
                 for n in (8, 16, 32, 64)]
CLUSTER_CASES += [(s.c_in, s.h_in, s.w_in, s.c_out, s.h_k, s.w_k, s.s_h,
                   s.s_w, t_run) for s, t_run in zip(
                       NETWORKS["resnet8"], (16, 16, 16, 16, 16, 8, 8))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["zigzag", "row"])
@pytest.mark.parametrize("c_in,h,w,n,kh,kw,sh,sw,t_run", CLUSTER_CASES)
def test_planned_kernel_over_a_cluster_matches_its_plain_version(
        card, order, c_in, h, w, n, kh, kw, sh, sw, t_run, dtype):
    """Each rank of the cluster computes its channels and columns; every
    step's box is fetched once per cluster, so the fetch counter grows by
    the boxes the plain version sliced plus Λ, whatever the cluster."""
    rng = np.random.default_rng(13)
    x, k = layer_from_numpy(rng.standard_normal((c_in, h, w)),
                            rng.standard_normal((n, c_in, kh, kw)),
                            device=card, dtype=dtype)
    kw_ = dict(t_run=t_run, s_h=sh, s_w=sw, order=order)
    counter = conv.fetched_counter(card)
    before = int(counter.item())
    got = conv.conv2d_offload_planned(x, k, **kw_)
    torch.cuda.synchronize()
    want, fetches = conv.conv2d_offload_planned_plain(
        x, k, return_fetches=True, **kw_)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    boxes = sum((h1 - h0) * (w1 - w0) for _, h0, h1, w0, w1 in fetches)
    assert int(counter.item()) - before == boxes * c_in + k.numel()


def test_planned_kernel_fetches_what_the_resnet8_plan_charges(card):
    """Over a planned ResNet-8 pass the blocks' own count of what they
    fetched is the plans' charged loads plus the kernel sets, exactly."""
    rng = np.random.default_rng(14)
    counter = conv.fetched_counter(card)
    counter.zero_()
    want = 0
    for lp, em in _resnet8_layers():
        s = em.spec
        x, k = layer_from_numpy(rng.standard_normal((s.c_in, s.h_in, s.w_in)),
                                rng.standard_normal((s.c_out, s.c_in, s.h_k,
                                                     s.w_k)), device=card)
        em.run(x, k)
        want += lp.strategy.pixels_loaded() * s.c_in + s.kernel_elements
    torch.cuda.synchronize()
    assert int(counter.item()) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emitted_conv_through_its_record_equals_an_uncached_call(card,
                                                                 dtype):
    """At every ResNet-8 layer, ``EmittedConv.run`` (its kept record and
    Λ) gives bit for bit what an uncached ``conv2d_offload_planned`` call
    gives: on repeat calls, after the weights changed in place between
    calls, on other weights and back.  Each call fetches the plan's
    charge into a fresh output; Λ is made anew exactly where the weights
    changed."""
    rng = np.random.default_rng(32)
    counter = conv.fetched_counter(card)
    for lp, em in _resnet8_layers():
        s = em.spec
        x, k = layer_from_numpy(rng.standard_normal((s.c_in, s.h_in, s.w_in)),
                                rng.standard_normal((s.c_out, s.c_in, s.h_k,
                                                     s.w_k)),
                                device=card, dtype=dtype)
        other = k.flip(0).contiguous()
        charge = lp.strategy.pixels_loaded() * s.c_in + s.kernel_elements
        before = dict(conv.LAMBDA)
        outs = []
        for step in ("first", "repeat", "repeat", "in place", "other",
                     "back"):
            if step == "in place":
                k.mul_(0.5)
            w = other if step == "other" else k
            counter.zero_()
            got = em.run(x, w)
            torch.cuda.synchronize()
            assert int(counter.item()) == charge, (em.layer_index, step)
            want = conv.conv2d_offload_planned(
                x, w, t_run=em.t_run, s_h=s.s_h, s_w=s.s_w, order=em.order)
            assert torch.equal(got, want), (em.layer_index, step)
            assert all(got.data_ptr() != o.data_ptr() for o in outs)
            outs.append(got)
        assert conv.LAMBDA["built"] - before["built"] == 4
        assert conv.LAMBDA["reused"] - before["reused"] == 2


@pytest.mark.parametrize("name", ["tight2", "resnet8"])
def test_k1_fetches_per_layer_what_simulator_kerncheck_and_plan_count(
        card, name):
    """Phase 8 of ``chip_smoke.py`` on a small network and on ResNet-8:
    under the H100's budget, each layer run on the simulator's seeded
    arrays fetches on the card exactly the simulator's DRAM reads,
    kerncheck's ``kern/traffic`` total, the plan's charge and the kernel
    timeline's ``dma_in`` elements, and gives the simulator's output."""
    hw = H100_SXM.as_hardware_model(dtype_bytes=4)
    plan = plan_emitable_network(list(NETWORKS[name]), hw, name=name)
    sim = simulate_network(plan, seed=31)
    assert sim.correct and sim.accounting_exact and sim.peak_within_budget
    timeline = adapters.kernel_timeline(plan)
    counter = conv.fetched_counter(card)
    for lp, rep in zip(plan.layers, sim.layer_reports):
        em = emit_layer_kernel(lp)
        layer = ConvLayer.random(lp.spec, seed=31 + lp.index)
        x, k = layer_from_numpy(layer.input, layer.kernels, device=card)
        counter.zero_()
        out = em.run(x, k)
        torch.cuda.synchronize()
        trace = kerncheck.build_conv_trace(em)
        assert kerncheck.check_conv_trace(trace, lp.strategy,
                                          hw.size_mem) == []
        charge = (lp.strategy.pixels_loaded() * lp.spec.c_in
                  + lp.spec.kernel_elements)
        assert int(counter.item()) == rep.elements_read \
            == trace.fetched_elements == charge == timeline.element_sum(
                layer=lp.index, chip=0, lane="dma_in")
        np.testing.assert_allclose(out.cpu().numpy(), rep.output,
                                   **TOL[torch.float32])


def test_cluster_size_and_footprint_are_the_cuda_sources_own(card):
    shape_c = _build.bind("conv2d_offload_planned",
                          "conv2d_offload_planned_cluster_shape",
                          [ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_int)])
    elems_c = _build.bind("conv2d_offload_planned",
                          "conv2d_offload_planned_smem_elements",
                          [ctypes.c_int] * 10, ctypes.c_longlong)
    cs_n, cs_t = ctypes.c_int(), ctypes.c_int()
    for n in range(1, 200):
        for t in range(1, 65):
            shape_c(n, t, ctypes.byref(cs_n), ctypes.byref(cs_t))
            assert (cs_n.value, cs_t.value) == conv_cluster_shape(n, t)
    for c_in, n, kh, kw, sh, sw, t in [(3, 16, 3, 3, 1, 1, 16),
                                       (64, 64, 3, 3, 1, 1, 8),
                                       (2, 24, 5, 3, 1, 2, 2),
                                       (2, 40, 3, 3, 3, 1, 9),
                                       (1, 8, 1, 1, 1, 1, 4),
                                       (3, 7, 3, 3, 1, 1, 12)]:
        for row_delta in (0, 1):
            assert elems_c(c_in, n, kh, kw, sh, sw, t, row_delta,
                           *conv_cluster_shape(n, t)) == \
                conv.planned_smem_elements(c_in, n, kh, kw, sh, sw, t,
                                           row_delta=bool(row_delta))
            for cluster in ((1, 1), (1, 2), (2, 1)):
                if n % cluster[0] == 0 and t % cluster[1] == 0:
                    assert elems_c(c_in, n, kh, kw, sh, sw, t, row_delta,
                                   *cluster) == conv.planned_layout(
                        c_in, n, kh, kw, sh, sw, t,
                        row_delta=bool(row_delta), cluster=cluster).total


def _forced_clusters(n, t_run):
    """Every cluster of 1 to 8 blocks the kernel takes for (n, t_run)."""
    return [(cn, ct) for cn in (1, 2, 4, 8) for ct in (1, 2, 4, 8)
            if cn * ct <= 8 and n % cn == 0 and t_run % ct == 0]


# geometry cases whose run lengths split over column groups: the rule's
# 2 x 4 (ResNet-8's first layers, ragged rows of 34 columns), runs of 6
# (column groups of 3: odd bfloat16 starts in every group), stride 2 and
# a 5 x 3 kernel
FORCED_CASES = CASES + [(3, 9, 34, 16, 3, 3, 1, 1, 16),
                        (2, 9, 20, 24, 3, 3, 1, 1, 6),
                        (2, 11, 25, 16, 3, 3, 2, 2, 4),
                        (3, 12, 17, 8, 5, 3, 1, 2, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["zigzag", "row"])
@pytest.mark.parametrize("c_in,h,w,n,kh,kw,sh,sw,t_run", FORCED_CASES)
def test_planned_kernel_at_every_cluster_it_takes(card, order, c_in, h, w,
                                                   n, kh, kw, sh, sw, t_run,
                                                   dtype):
    """Launched as every cluster of 1 to 8 blocks that divides the
    channels and the run, the kernel gives its plain version's output
    (the plain version split the same way) and fetches the boxes plus Λ
    once."""
    rng = np.random.default_rng(15)
    x, k = layer_from_numpy(rng.standard_normal((c_in, h, w)),
                            rng.standard_normal((n, c_in, kh, kw)),
                            device=card, dtype=dtype)
    geo = dict(t_run=t_run, s_h=sh, s_w=sw, order=order)
    counter = torch.zeros(1, dtype=torch.int64, device=card)
    for cluster in _forced_clusters(n, t_run):
        counter.zero_()
        got = conv.planned_launch(x, k, cluster=cluster, counter=counter,
                                  **geo).run(x, k, conv._lambda_matrix)
        torch.cuda.synchronize()
        want, fetches = conv.conv2d_offload_planned_plain(
            x, k, return_fetches=True, cluster=cluster, **geo)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **TOL[dtype],
                                   err_msg=str(cluster))
        boxes = sum((h1 - h0) * (w1 - w0) for _, h0, h1, w0, w1 in fetches)
        assert int(counter.item()) == boxes * c_in + k.numel(), cluster


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["resnet8", "lenet5", "tight2", "tight4"])
def test_planned_kernel_at_every_networks_planned_clusters(card, name,
                                                           dtype):
    """Every layer of the registered networks, planned under the H100's
    budget and under kerncheck's, runs on the cluster the rule gives it
    (``EmittedConv.run``), matches the plain version and fetches, layer
    by layer, the plan's charge."""
    rng = np.random.default_rng(16)
    counter = conv.fetched_counter(card)
    specs = list(NETWORKS[name])
    for hw in (H100_SXM.as_hardware_model(dtype_bytes=4),
               kerncheck.network_budget(specs)):
        plan = plan_emitable_network(specs, hw, name=name)
        for lp in plan.layers:
            em = emit_layer_kernel(lp)
            s = em.spec
            x, k = layer_from_numpy(
                rng.standard_normal((s.c_in, s.h_in, s.w_in)),
                rng.standard_normal((s.c_out, s.c_in, s.h_k, s.w_k)),
                device=card, dtype=dtype)
            counter.zero_()
            got = em.run(x, k)
            torch.cuda.synchronize()
            want = conv.conv2d_offload_planned_plain(
                x, k, t_run=em.t_run, s_h=s.s_h, s_w=s.s_w, order=em.order)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       **TOL[dtype])
            assert int(counter.item()) == (
                lp.strategy.pixels_loaded() * s.c_in + s.kernel_elements)


# ------------------------ block GeMM (K3, K4) ------------------------ #

# tests/test_kernels.py:57-62, padded to the tiles by ops.matmul; then the
# smallest tiles (one fragment row of warps, idle warps), a 16-row tile
# with a full-width one, K4's inner loops split raggedly over 8 blocks, and
# tiles of an odd number of 16-row fragments (the last warp row short)
MATMUL_CASES = [
    (64, 64, 64, 32, 32, 32),
    (200, 150, 300, 64, 64, 64),
    (128, 128, 128, 128, 128, 128),
    (96, 257, 130, 32, 64, 64),
    (48, 80, 48, 16, 16, 16),
    (144, 640, 160, 16, 128, 32),
    (320, 288, 96, 32, 32, 32),
    (96, 160, 96, 48, 32, 32),
    (160, 240, 64, 80, 80, 32),
]
ORDERS = ("mnk", "nmk", "mkn", "nkm", "kmn", "knm")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("m,n,k,bm_,bn_,bk_", MATMUL_CASES)
def test_block_matmul_kernels_match_their_plain_version(card, m, n, k, bm_,
                                                        bn_, bk_, order,
                                                        dtype):
    """Inputs scaled so each product's sum is O(1): float32 sums differ by
    their order only; bfloat16 by one final rounding."""
    rng = np.random.default_rng(6)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=dtype, device=card)
    b = torch.tensor(rng.standard_normal((k, n)) / np.sqrt(k), dtype=dtype,
                     device=card)
    name = "block_matmul_osta" if order[2] == "k" else "block_matmul_rmw"
    if matmul_smem_bytes(bm_, bn_, bk_, a.element_size()) \
            > conv.SMEM_LIMIT_BYTES:
        # two float32 stages of 128x128x128 tiles do not fit one block's
        # shared memory: the kernel refuses them, and runs bk = 64
        with pytest.raises(KernelShapeError, match="shared memory"):
            ops.matmul(a, b, bm=bm_, bn=bn_, bk=bk_, order=order)
        bk_ //= 2
    before = COUNTS[name]
    got = ops.matmul(a, b, bm=bm_, bn=bn_, bk=bk_, order=order)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == dtype and got.shape == (m, n)
    assert COUNTS[name] > before
    a_p = ops._pad_to(ops._pad_to(a, 0, bm_), 1, bk_)
    b_p = ops._pad_to(ops._pad_to(b, 0, bk_), 1, bn_)
    want = bm.block_matmul_plain(a_p, b_p, bm=bm_, bn=bn_, bk=bk_,
                                 order=order)[:m, :n]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


def test_block_matmul_orders_agree_bit_for_bit_on_the_card(card):
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.standard_normal((128, 192)), dtype=torch.bfloat16,
                     device=card)
    b = torch.tensor(rng.standard_normal((192, 96)), dtype=torch.bfloat16,
                     device=card)
    outs = [bm.block_matmul(a, b, bm=32, bn=32, bk=64, order=o)
            for o in ORDERS]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_matmul_orders_agree_bit_for_bit_over_ragged_clusters(
        card, dtype):
    """m and n trips 10 and 9: K4's clusters of 8 leave some ranks a tile
    short; every order still gives the same bits, and K4 launched as a
    cluster."""
    rng = np.random.default_rng(10)
    a = torch.tensor(rng.standard_normal((320, 96)), dtype=dtype,
                     device=card)
    b = torch.tensor(rng.standard_normal((96, 288)) / np.sqrt(96),
                     dtype=dtype, device=card)
    outs = []
    for o in ORDERS:
        outs.append(bm.block_matmul(a, b, bm=32, bn=32, bk=32, order=o))
        if o[2] != "k":
            assert bm.LAST_LAUNCH["name"] == "block_matmul_rmw"
            assert bm.LAST_LAUNCH["cluster"] == 8
            outer = 10 if o[2] == "n" else 9
            assert bm.LAST_LAUNCH["grid"] == (outer * 8, 1)
    torch.cuda.synchronize()
    for o, got in zip(ORDERS, outs):
        assert torch.equal(got, outs[0]), o
    want = bm.block_matmul_plain(a, b, bm=32, bn=32, bk=32, order="mkn")
    np.testing.assert_allclose(outs[0].float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


# The wgmma core (bfloat16, bm 64 or 128): bn 16-128, whose rows of B
# swizzle by 32, 64 or 128 bytes (48 and 80 by 32, 96 by 64), and bk 16,
# 48 (A by 32 bytes), 128 and 512 (B in boxes of 256 rows); K4 clusters
# of 6, 8 and 3 blocks
WGMMA_CASES = [
    (128, 96, 64, 64, 16, 16),
    (256, 160, 256, 128, 32, 128),
    (192, 64, 1024, 64, 32, 512),
    (384, 384, 256, 128, 128, 128),
    (128, 640, 64, 64, 128, 16),
    (128, 160, 96, 64, 80, 48),
    (256, 192, 192, 128, 96, 64),
]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("m,n,k,bm_,bn_,bk_", WGMMA_CASES)
def test_wgmma_core_matches_the_plain_version(card, m, n, k, bm_, bn_, bk_,
                                              order):
    """K3 and K4 on the wgmma core against the plain version: one final
    bfloat16 rounding apart (f32 products and sums on both sides)."""
    rng = np.random.default_rng(12)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=torch.bfloat16,
                     device=card)
    b = torch.tensor(rng.standard_normal((k, n)) / np.sqrt(k),
                     dtype=torch.bfloat16, device=card)
    got = bm.block_matmul(a, b, bm=bm_, bn=bn_, bk=bk_, order=order)
    assert bm.LAST_LAUNCH["core"] == "wgmma"
    torch.cuda.synchronize()
    want = bm.block_matmul_plain(a, b, bm=bm_, bn=bn_, bk=bk_, order=order)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("tiles", [(64, 64, 32), (128, 128, 64)])
def test_wgmma_orders_agree_bit_for_bit(card, tiles):
    """Each step's product formed from zero over bk, added in k order and
    rounded once: the six orders give the same bits on the wgmma core."""
    rng = np.random.default_rng(13)
    a = torch.tensor(rng.standard_normal((256, 192)), dtype=torch.bfloat16,
                     device=card)
    b = torch.tensor(rng.standard_normal((192, 384)) / np.sqrt(192),
                     dtype=torch.bfloat16, device=card)
    bm_, bn_, bk_ = tiles
    outs = []
    for o in ORDERS:
        outs.append(bm.block_matmul(a, b, bm=bm_, bn=bn_, bk=bk_, order=o))
        assert bm.LAST_LAUNCH["core"] == "wgmma"
    torch.cuda.synchronize()
    for o, got in zip(ORDERS, outs):
        assert torch.equal(got, outs[0]), o


def test_wgmma_orders_agree_bit_for_bit_over_ragged_clusters(card):
    """640 x 576 in 64-tiles: 10 x 9 trips, K4's clusters of 8 leave some
    ranks a tile short, and rank 0 pushes the resident tile to 7 peers;
    the six orders still give the same bits."""
    rng = np.random.default_rng(14)
    a = torch.tensor(rng.standard_normal((640, 128)), dtype=torch.bfloat16,
                     device=card)
    b = torch.tensor(rng.standard_normal((128, 576)) / np.sqrt(128),
                     dtype=torch.bfloat16, device=card)
    outs = []
    for o in ORDERS:
        outs.append(bm.block_matmul(a, b, bm=64, bn=64, bk=64, order=o))
        assert bm.LAST_LAUNCH["core"] == "wgmma"
        if o[2] != "k":
            assert bm.LAST_LAUNCH["cluster"] == 8
            assert bm.LAST_LAUNCH["grid"] == ((10 if o[2] == "n" else 9)
                                              * 8, 1)
    torch.cuda.synchronize()
    for o, got in zip(ORDERS, outs):
        assert torch.equal(got, outs[0]), o
    want = bm.block_matmul_plain(a, b, bm=64, bn=64, bk=64, order="mkn")
    np.testing.assert_allclose(outs[0].float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **TOL[torch.bfloat16])


# K3 on 128 x 256 tiles (products of 128 columns, a producer warpgroup)
# and 64 x 256, and on every cluster shape it takes: (cm, cn) ranks along m
# and n sharing A (a tile row) and B (a tile column) by TMA multicast; bk
# 16 splits B's 16-row boxes into 8-row shares
K3_CLUSTER_CASES = [
    (256, 512, 256, 128, 256, 64, (1, 1)),
    (256, 512, 256, 128, 256, 64, (2, 1)),
    (256, 512, 256, 128, 256, 64, (1, 2)),
    (256, 512, 256, 128, 256, 64, (2, 2)),
    (128, 512, 128, 64, 256, 128, (2, 2)),
    (512, 256, 192, 128, 128, 64, (2, 2)),
    (256, 256, 64, 64, 128, 16, (2, 1)),
    (384, 1024, 512, 128, 256, 128, (1, 2)),
]


@pytest.mark.parametrize("order", ["mnk", "nmk"])
@pytest.mark.parametrize("m,n,k,bm_,bn_,bk_,cluster", K3_CLUSTER_CASES)
def test_k3_wide_tiles_and_multicast_clusters_match_the_plain_version(
        card, m, n, k, bm_, bn_, bk_, cluster, order):
    """K3 at bn 256 and over every cluster shape against the plain version
    split the same way: one final bfloat16 rounding apart; the launch's
    cluster lies along the grid's axes as the planner counts it."""
    rng = np.random.default_rng(16)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=torch.bfloat16,
                     device=card)
    b = torch.tensor(rng.standard_normal((k, n)) / np.sqrt(k),
                     dtype=torch.bfloat16, device=card)
    got = bm.block_matmul(a, b, bm=bm_, bn=bn_, bk=bk_, order=order,
                          cluster=cluster)
    launch = dict(bm.LAST_LAUNCH)
    torch.cuda.synchronize()
    assert launch["core"] == "wgmma" and launch["k3_cluster"] == cluster
    assert launch["cluster"] == cluster[0] * cluster[1]
    assert launch["grid_cluster"] == planner.k3_grid_cluster(order, cluster)
    want = bm.block_matmul_plain(a, b, bm=bm_, bn=bn_, bk=bk_, order=order,
                                 cluster=cluster)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **TOL[torch.bfloat16])


def test_wide_tiles_and_clusters_agree_bit_for_bit_over_the_orders(card):
    """At 128 x 256 x 64: the six orders (K4 on m64n256k16 products, K3 on
    two m64n128k16 products a step) and K3 on each of its clusters give
    the same bits."""
    rng = np.random.default_rng(17)
    a = torch.tensor(rng.standard_normal((256, 320)), dtype=torch.bfloat16,
                     device=card)
    b = torch.tensor(rng.standard_normal((320, 512)) / np.sqrt(320),
                     dtype=torch.bfloat16, device=card)
    outs = {o: bm.block_matmul(a, b, bm=128, bn=256, bk=64, order=o)
            for o in ORDERS}
    for cluster in [(2, 1), (1, 2), (2, 2)]:
        for o in ("mnk", "nmk"):
            outs[(o, cluster)] = bm.block_matmul(
                a, b, bm=128, bn=256, bk=64, order=o, cluster=cluster)
    torch.cuda.synchronize()
    first = outs["mnk"]
    for key, got in outs.items():
        assert torch.equal(got, first), key


def test_k3_clusters_the_planner_offers_fit_the_card(card):
    """Every K3 cluster the planner takes at TinyLlama's prefill
    projections and at 8192^3 fits at once in clusters that fill at least
    ``sms_in_clusters_of_4`` (4) or all (1, 2) SMs, and the source's
    cluster rule is the planner's over bk 16-256, bn 16-256, trips 1-4."""
    fit = _build.bind("block_matmul", "block_matmul_k3_max_active_clusters",
                      [ctypes.c_int] * 5)
    ok = _build.bind("block_matmul", "block_matmul_k3_cluster_ok",
                     [ctypes.c_int] * 8)
    for m, n, k in [(1920, 2048, 2048), (1920, 256, 2048),
                    (1920, 5632, 2048), (1920, 2048, 5632),
                    (8192, 8192, 8192)]:
        p = planner.plan_matmul(m, n, k, 2)
        t = p.tiles
        if p.order[2] != "k":
            continue
        size = p.cluster[0] * p.cluster[1]
        clusters = fit(t["bm"], t["bn"], *p.cluster, p.smem_bytes)
        want = H100_SXM.sms_in_clusters_of_4 if size == 4 else H100_SXM.n_sms
        assert clusters * size >= want, (m, n, k, p.cluster, clusters)
    for bm_, bn_, bk_, m_t, n_t, cm, cn in itertools.product(
            (64, 128), (16, 32, 64, 128, 256), (16, 32, 64, 128, 256),
            (1, 2, 3, 4), (1, 2, 3), (1, 2), (1, 2)):
        assert bool(ok(bm_, bn_, bk_, m_t, n_t, cm, cn, 2)) == \
            planner.k3_cluster_ok(bm_, bn_, bk_, m_t, n_t, cm, cn, 2)


def test_block_matmul_refuses_clusters_it_cannot_take(card):
    a = torch.zeros((384, 256), dtype=torch.bfloat16, device=card)
    b = torch.zeros((256, 512), dtype=torch.bfloat16, device=card)
    with pytest.raises(KernelShapeError, match="cluster"):    # 3 tile rows
        bm.block_matmul(a, b, bm=128, bn=128, bk=64, cluster=(2, 1))
    with pytest.raises(KernelShapeError, match="only K3"):
        bm.block_matmul(a, b, bm=128, bn=128, bk=64, order="mkn",
                        cluster=(1, 2))
    with pytest.raises(KernelShapeError, match="cluster"):    # mma.sync
        bm.block_matmul(a, b, bm=32, bn=128, bk=64, cluster=(1, 2))


@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 256), (2048, 5632),
                                 (5632, 2048)])
def test_the_planned_prefill_tiles_run_on_the_wgmma_core(card, k, n):
    """TinyLlama's prefill projections (m = 4 x 480) through ops.matmul
    with the planner's tiles: bfloat16 runs on the wgmma core."""
    rng = np.random.default_rng(15)
    a = torch.tensor(rng.standard_normal((1920, k)), dtype=torch.bfloat16,
                     device=card)
    b = torch.tensor(rng.standard_normal((k, n)) / np.sqrt(k),
                     dtype=torch.bfloat16, device=card)
    got = ops.matmul(a, b)
    assert bm.LAST_LAUNCH["core"] == "wgmma"
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.matmul(a, b).float().cpu().numpy(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("m,n,k,tile_m", [(40, 8192, 2048, 48),
                                          (80, 8192, 2048, 80),
                                          (4, 2048, 2048, 16)])
def test_planned_matmul_at_every_tile_the_planner_gives(card, m, n, k,
                                                        tile_m):
    """``ops.matmul`` with the planner's tiles: 48 and 80 rows (an odd
    number of 16-row fragments) and, for m = 4, tiles clamped to 16."""
    assert ops._planned_matmul(m, n, k, 2)[0] == tile_m
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=torch.bfloat16,
                     device=card)
    b = torch.tensor(rng.standard_normal((k, n)) / np.sqrt(k),
                     dtype=torch.bfloat16, device=card)
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.matmul(a, b).float().cpu().numpy(),
                               **TOL[torch.bfloat16])


def test_block_matmul_refuses_tiles_it_cannot_hold(card):
    a = torch.zeros((256, 256), device=card)
    with pytest.raises(KernelShapeError, match="bm, bn <= 128"):
        bm.block_matmul(a, a, bm=256, bn=128, bk=16)
    with pytest.raises(KernelShapeError, match="bm, bn <= 128"):
        bm.block_matmul(a, a, bm=32, bn=256, bk=16)   # mma.sync: bn 128
    with pytest.raises(KernelShapeError, match="shared memory"):
        bm.block_matmul(a, a, bm=128, bn=128, bk=256)
    with pytest.raises(KernelShapeError, match="multiples of 16"):
        bm.block_matmul(a, a, bm=8, bn=32, bk=32)
    whole = torch.zeros(256 * 256 + 4, device=card)
    view = whole[2:2 + 256 * 256].view(256, 256)     # 8 bytes past the start
    with pytest.raises(KernelShapeError, match="16 bytes"):
        bm.block_matmul(view, a, bm=32, bn=32, bk=32)


# -------------------------- decode attention (K5) -------------------- #

# tests/test_kernels.py:84-89
DECODE_CASES = [
    (1, 4, 4, 32, 128, 64),
    (2, 8, 2, 64, 256, 64),
    (2, 8, 1, 64, 256, 128),
    (1, 16, 4, 128, 512, 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,d,s,bkv", DECODE_CASES)
def test_decode_kernel_matches_its_plain_version(card, b, hq, hkv, d, s,
                                                 bkv, dtype):
    rng = np.random.default_rng(8)
    q = torch.tensor(rng.standard_normal((b, hq, d)), dtype=dtype,
                     device=card)
    k = torch.tensor(rng.standard_normal((b, s, hkv, d)), dtype=dtype,
                     device=card)
    v = torch.tensor(rng.standard_normal((b, s, hkv, d)), dtype=dtype,
                     device=card)
    lengths = torch.tensor(rng.integers(0, s + 1, size=(b,)),
                           dtype=torch.int32, device=card)
    lengths[0] = 1
    before = COUNTS["flash_decode"]
    got = fd.decode_attention(q, k, v, lengths, bkv=bkv)
    torch.cuda.synchronize()
    assert COUNTS["flash_decode"] == before + 1
    want = fd.decode_attention_plain(q, k, v, lengths, bkv=bkv)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


def test_decode_kernel_reads_a_layer_of_a_stacked_cache_in_place(card):
    """K and V are strided views into a larger cache; an empty length
    gives the mean of v, as the TPU kernel does."""
    rng = np.random.default_rng(9)
    cache = torch.tensor(rng.standard_normal((2, 3, 96, 2, 32)),
                         dtype=torch.bfloat16, device=card)
    q = torch.tensor(rng.standard_normal((3, 8, 32)), dtype=torch.float32,
                     device=card)
    lengths = torch.tensor([0, 17, 64], dtype=torch.int32, device=card)
    k, v = cache[0, :, :64], cache[1, :, :64]
    assert not k.is_contiguous()
    got = fd.decode_attention(q, k, v, lengths, bkv=32)
    want = fd.decode_attention_plain(q, k, v, lengths, bkv=32)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    mean_v = v[0].float().mean(dim=0).repeat_interleave(4, dim=0)
    np.testing.assert_allclose(got[0].cpu().numpy(), mean_v.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


# ------------- decode attention split over blocks, and its combine ------- #

def _decode_inputs(card, seed, b, hq, hkv, d, s, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape), dtype=dtype,
                              device=card)
                 for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits,bkv", [(2, 64), (4, 32), (8, 16), (8, 64)])
def test_split_decode_matches_its_plain_version_at_the_range_edges(
        card, splits, bkv, dtype):
    """Lengths 0, 1, one range, one row past a range, a range past the
    middle, and S: the split kernel and the combine against the plain
    split-then-combine on the same splits, and the combine counted once."""
    s = 512
    q, k, v = _decode_inputs(card, 15, 6, 32, 4, 64, s, dtype)
    rng_len = s // splits
    lengths = torch.tensor([0, 1, rng_len, rng_len + 1,
                            (splits // 2) * rng_len + 3, s],
                           dtype=torch.int32, device=card)
    before = dict(COUNTS)
    got = fd.decode_attention(q, k, v, lengths, bkv=bkv, splits=splits)
    torch.cuda.synchronize()
    assert COUNTS["flash_decode"] == before["flash_decode"] + 1
    assert COUNTS["flash_decode_combine"] == \
        before["flash_decode_combine"] + 1
    want = fd.decode_attention_plain(q, k, v, lengths, bkv=bkv,
                                     splits=splits)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [48, 200, 512])
def test_planned_split_decode_pads_and_matches_the_oracle(card, s, dtype):
    """``ops.decode_attention`` with the planner's bkv and splits (S = 48
    and 200 pad to the rule's grain) against the plain version and, in
    float32, against ``ref.decode_attention`` head by head."""
    b, hq, hkv, d = 4, 32, 4, 64
    q, k, v = _decode_inputs(card, 16, b, hq, hkv, d, s, dtype)
    lengths = torch.tensor([1, s // 2, s - 1, s], dtype=torch.int32,
                           device=card)
    bkv, splits = ops._planned_split(s, d, hq // hkv, b * hkv,
                                     k.element_size())
    before = COUNTS["flash_decode_combine"]
    got = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert COUNTS["flash_decode_combine"] == before + int(splits > 1)
    k_p, v_p = (ops._pad_to(t, 1, bkv * splits) for t in (k, v))
    want = fd.decode_attention_plain(q, k_p, v_p, lengths, bkv=bkv,
                                     splits=splits)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    if dtype == torch.float32:
        for bi in range(b):
            for h in range(0, hq, 7):
                exp = ref.decode_attention(q[bi, h:h + 1],
                                           k[bi, :, h // 8], v[bi, :, h // 8],
                                           int(lengths[bi]))[0]
                np.testing.assert_allclose(got[bi, h].cpu().numpy(),
                                           exp.cpu().numpy(), **TOL[dtype])


def test_split_decode_reads_a_layer_of_a_stacked_cache_in_place(card):
    """Strided K and V views, a float32 query against a bfloat16 cache,
    four splits: an empty length still gives the mean of v."""
    rng = np.random.default_rng(17)
    cache = torch.tensor(rng.standard_normal((2, 3, 160, 2, 32)),
                         dtype=torch.bfloat16, device=card)
    q = torch.tensor(rng.standard_normal((3, 8, 32)), dtype=torch.float32,
                     device=card)
    lengths = torch.tensor([0, 40, 128], dtype=torch.int32, device=card)
    k, v = cache[0, :, :128], cache[1, :, :128]
    assert not k.is_contiguous()
    got = fd.decode_attention(q, k, v, lengths, bkv=16, splits=4)
    want = fd.decode_attention_plain(q, k, v, lengths, bkv=16, splits=4)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    mean_v = v[0].float().mean(dim=0).repeat_interleave(4, dim=0)
    np.testing.assert_allclose(got[0].cpu().numpy(), mean_v.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits,bkv", [(1, 64), (1, 256), (4, 32)])
def test_split_kernel_partials_match_their_plain_version(card, splits, bkv,
                                                         dtype):
    """``decode_partials``: the split kernel writing every range's
    partial to the workspace, one split included (the kernel writes
    ``acc / l`` itself only without a workspace), against the plain
    split's partials, with lengths 0, 1, one row past a range and S."""
    s = 512
    q, k, v = _decode_inputs(card, 19, 4, 32, 4, 64, s, dtype)
    lengths = torch.tensor([0, 1, s // splits + 1, s], dtype=torch.int32,
                           device=card)
    before = dict(COUNTS)
    got = fd.decode_partials(q, k, v, lengths, bkv=bkv, splits=splits)
    torch.cuda.synchronize()
    assert COUNTS["flash_decode"] == before["flash_decode"] + 1
    assert COUNTS["flash_decode_combine"] == \
        before["flash_decode_combine"]
    want = fd.decode_partials_plain(q, k, v, lengths, bkv=bkv,
                                    splits=splits)
    assert got.shape == want.shape == (4, 4, splits, 8, 66)
    # m and l are f32 on both sides; acc and l sum O(1) terms in f32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_a_sharded_caches_partials_combine_to_the_whole_attention(
        card, shards, dtype):
    """The cache's sequence cut as DTensor cuts it over ``shards``
    devices, each shard's ``ops.decode_partials`` (lengths counted from
    its first row, planned for the largest shard), the partials side by
    side through the combine kernel: ``ops.decode_attention`` of the
    whole cache."""
    s = 512
    q, k, v = _decode_inputs(card, 20, 4, 32, 4, 64, s, dtype)
    lengths = torch.tensor([1, 100, 300, s], dtype=torch.int32, device=card)
    rows = -(-s // shards)
    parts = [ops.decode_partials(
        q, k[:, i:i + rows], v[:, i:i + rows],
        (lengths - i).clamp(0, min(rows, s - i)).to(torch.int32),
        rows=rows) for i in range(0, s, rows)]
    got = ops.decode_combine(torch.cat(parts, dim=2), dtype)
    want = ops.decode_attention(q, k, v, lengths)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernel_matches_its_plain_version(card, dtype):
    """The combine alone, fed the plain split's partials (a range wholly
    past a length among them), against the plain combine."""
    q, k, v = _decode_inputs(card, 18, 4, 32, 4, 64, 512, torch.float32)
    lengths = torch.tensor([3, 512, 200, 0], dtype=torch.int32, device=card)
    part = fd.decode_partials_plain(q, k, v, lengths, bkv=64, splits=8)
    before = COUNTS["flash_decode_combine"]
    got = fd.decode_combine(part, dtype)
    torch.cuda.synchronize()
    assert COUNTS["flash_decode_combine"] == before + 1
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        fd.decode_combine_plain(part, dtype).float().cpu().numpy(),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(32, 32, 80), (12, 1, 80), (16, 1, 48),
                                      (20, 2, 96), (4, 1, 128)])
def test_split_decode_takes_wide_query_groups_and_padded_head_dims(
        card, hq, hkv, d, dtype):
    """Zamba2-2.7B's heads (G = 1, D = 80: 10 or 20 vectors of 16 bytes,
    lanes rounded up to 16 or 32), G = 10-16 query rows per KV head (two
    blocks of at most 8 each), and a row that fills a warp, at the range
    edges, against the plain split-then-combine."""
    s, splits, bkv = 256, 4, 32
    q, k, v = _decode_inputs(card, 21, 3, hq, hkv, d, s, dtype)
    lengths = torch.tensor([0, s // splits + 1, s], dtype=torch.int32,
                           device=card)
    got = fd.decode_attention(q, k, v, lengths, bkv=bkv, splits=splits)
    want = fd.decode_attention_plain(q, k, v, lengths, bkv=bkv,
                                     splits=splits)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    one = fd.decode_attention(q, k, v, lengths, bkv=bkv)
    np.testing.assert_allclose(
        one.float().cpu().numpy(),
        fd.decode_attention_plain(q, k, v, lengths,
                                  bkv=bkv).float().cpu().numpy(),
        **TOL[dtype])


def test_decode_refuses_shapes_the_split_kernel_does_not_take(card):
    lengths = torch.tensor([128], dtype=torch.int32, device=card)
    q, k, v = _decode_inputs(card, 19, 1, 4, 1, 36, 128, torch.bfloat16)
    with pytest.raises(KernelShapeError, match="head dim"):
        fd.decode_attention(q, k, v, lengths, bkv=32)      # D = 36: 72 B
    q, k, v = _decode_inputs(card, 19, 1, 4, 1, 256, 128, torch.float32)
    with pytest.raises(KernelShapeError, match="head dim"):
        fd.decode_attention(q, k, v, lengths, bkv=32)      # 64 f32 vectors
    q, k, v = _decode_inputs(card, 19, 1, 4, 1, 64, 128, torch.bfloat16)
    with pytest.raises(KernelShapeError, match="multiples of 16"):
        fd.decode_attention(q, k, v, lengths, bkv=8)


def test_decode_shared_memory_is_the_cuda_sources_own(card):
    smem_c = _build.bind("flash_decode", "flash_decode_smem_bytes",
                         [ctypes.c_int] * 6, ctypes.c_longlong)
    for g, d, eb in [(8, 64, 2), (4, 32, 4), (1, 128, 4), (7, 128, 2),
                     (12, 80, 2), (16, 48, 4), (1, 224, 2), (3, 256, 2)]:
        for ring in itertools.product(planner.DECODE_TILES,
                                      planner.DECODE_STAGES, (4, 8)):
            assert smem_c(g, d, *ring, eb) == \
                decode_smem_bytes(g, d, *ring, eb)


# K5 at the decode cells' shapes, (B, H_q, H_kv, D, cache rows, lengths):
# Qwen2-7B's long cell (G 7, D 128, 8448 rows, ragged lengths about the
# cell's 8193-8448) and Zamba2-7B's chat cell (G 1, D 224, 768 rows)
K5_CELLS = {
    "qwen2-7b.decode.long": (32, 28, 4, 128, 8448,
                             [8193, 8448, 1, 4224, 4225, 8447, 5000, 8300]),
    "zamba2-7b.decode.chat": (64, 32, 32, 224, 768,
                              [513, 768, 1, 640, 700, 767, 600, 0]),
}


def _cell_lengths(card, b, some):
    """``b`` lengths: the cell's own edge cases, then the rest spread
    over the cache from a generator of their own."""
    rng = np.random.default_rng(31)
    rest = rng.integers(max(some) // 2, max(some) + 1, size=b - len(some))
    return torch.tensor(list(some) + [int(x) for x in rest],
                        dtype=torch.int32, device=card)


@pytest.mark.parametrize("cell", sorted(K5_CELLS))
def test_split_kernel_at_the_decode_cells_shapes(card, cell):
    """``ops.decode_attention`` at the cells' shapes, bf16, with the
    planner's splits and ring, against the plain split-then-combine on
    the same ranges; the split kernel counted once, the tensor-core
    scores once at G 7 and not at G 1, the combine once if split."""
    b, hq, hkv, d, s, some = K5_CELLS[cell]
    q, k, v = _decode_inputs(card, 30, b, hq, hkv, d, s, torch.bfloat16)
    lengths = _cell_lengths(card, b, some)
    bkv, splits = ops._planned_split(s, d, hq // hkv, b * hkv, 2)
    assert s % (bkv * splits) == 0
    before = dict(COUNTS)
    got = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert COUNTS["flash_decode"] == before["flash_decode"] + 1
    assert COUNTS["flash_decode_mma"] == \
        before["flash_decode_mma"] + int(hq // hkv >= 2)
    assert COUNTS["flash_decode_combine"] == \
        before["flash_decode_combine"] + int(splits > 1)
    want = fd.decode_attention_plain(q, k, v, lengths, bkv=bkv,
                                     splits=splits)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **TOL[torch.bfloat16])


# Every class of the walk: (q dtype, cache dtype, H_q, H_kv, D): f32; a
# f32 query on a bf16 cache and the other way round; D 64, 80 (10
# vectors, 5 k-steps), 224 and 256; G 1, 2, 7, 8 and 16 (two blocks a
# range); on the tensor cores wherever the shape lets it
WALK_CLASSES = [
    (torch.float32, torch.float32, 8, 2, 64),
    (torch.float32, torch.float32, 4, 4, 128),
    (torch.float32, torch.bfloat16, 8, 2, 32),
    (torch.bfloat16, torch.float32, 16, 2, 64),
    (torch.bfloat16, torch.bfloat16, 16, 2, 64),
    (torch.bfloat16, torch.bfloat16, 8, 8, 80),
    (torch.bfloat16, torch.bfloat16, 8, 4, 80),
    (torch.bfloat16, torch.bfloat16, 14, 2, 128),
    (torch.bfloat16, torch.bfloat16, 6, 2, 224),
    (torch.bfloat16, torch.bfloat16, 32, 2, 256),
    (torch.bfloat16, torch.bfloat16, 4, 4, 256),
]


@pytest.mark.parametrize("qt,kt,hq,hkv,d", WALK_CLASSES)
def test_split_kernel_walk_classes_match_their_plain_version(card, qt, kt,
                                                             hq, hkv, d):
    """At lengths 0, 1, one row past a range, a range wholly past the
    length (split 3 of 4 at length 100), and S: four splits through the
    combine, one split writing acc / l, and one split into the
    workspace; the tensor-core scores counted where they run."""
    s, bkv = 256, 16
    q = _decode_inputs(card, 32, 5, hq, hkv, d, s, qt)[0]
    _, k, v = _decode_inputs(card, 33, 5, hq, hkv, d, s, kt)
    lengths = torch.tensor([0, 1, s // 4 + 1, 100, s], dtype=torch.int32,
                           device=card)
    mma = fd.uses_mma(qt, kt, hq // hkv, d)
    assert mma == (qt == kt == torch.bfloat16 and hq // hkv >= 2
                   and d % 16 == 0)
    tol = TOL[torch.bfloat16 if torch.bfloat16 in (qt, kt)
              else torch.float32]
    for splits in (4, 1):
        before = COUNTS["flash_decode_mma"]
        got = fd.decode_attention(q, k, v, lengths, bkv=bkv, splits=splits)
        torch.cuda.synchronize()
        assert COUNTS["flash_decode_mma"] == before + int(mma)
        want = fd.decode_attention_plain(q, k, v, lengths, bkv=bkv,
                                         splits=splits)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)
    part = fd.decode_partials(q, k, v, lengths, bkv=bkv, splits=1)
    want = fd.decode_partials_plain(q, k, v, lengths, bkv=bkv, splits=1)
    np.testing.assert_allclose(part.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("cell", sorted(K5_CELLS))
def test_the_split_kernel_keeps_sixteen_warps_resident_an_sm(card, cell):
    """The card's own occupancy of the instance each cell launches (the
    short cell's is the long cell's), with its ring's threads and shared
    memory: at least 16 warps an SM, within the launch bounds' registers
    (``core.planner.decode_regs``) and without spills, and as many blocks as
    ``core.planner.decode_blocks_per_sm`` prices."""
    _, hq, hkv, d, _, _ = K5_CELLS[cell]
    g = hq // hkv
    occ = fd.occupancy(torch.bfloat16, torch.bfloat16, g, d)
    tile, stages, warps = fd.ring(g, d, 2)
    assert occ["blocks"] * warps >= 16
    regs = planner.decode_regs(g)
    assert occ["regs"] <= regs and occ["local_bytes"] == 0
    smem = decode_smem_bytes(g, d, tile, stages, warps, 2)
    assert occ["blocks"] >= planner.decode_blocks_per_sm(smem, warps, regs)


# ------------------- simple conv kernel (K2), redesigned -------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["zigzag", "row"])
@pytest.mark.parametrize("layer", range(7))
def test_simple_kernel_at_every_resnet8_layer(card, layer, order, dtype):
    """K2 at the run length ``ops.conv2d`` plans (one block per output row,
    the reduction split over 4-8 groups) against its plain version and
    the oracle ``ref.conv2d``."""
    s = NETWORKS["resnet8"][layer]
    rng = np.random.default_rng(20 + layer)
    x, k = layer_from_numpy(rng.standard_normal((s.c_in, s.h_in, s.w_in)),
                            rng.standard_normal((s.c_out, s.c_in, s.h_k,
                                                 s.w_k)),
                            device=card, dtype=dtype)
    t_run = ops._planned_t_run(s, x.element_size())
    before = COUNTS["conv2d_offload"]
    got = conv.conv2d_offload(x, k, t_run=t_run, s_h=s.s_h, s_w=s.s_w,
                              order=order)
    torch.cuda.synchronize()
    assert COUNTS["conv2d_offload"] == before + 1
    want = conv.conv2d_offload_plain(x, k, t_run=t_run, s_h=s.s_h,
                                     s_w=s.s_w, order=order)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(
        ops.conv2d(x, k, s_h=s.s_h, s_w=s.s_w).float().cpu().numpy(),
        ref.conv2d(x, k, s.s_h, s.s_w).float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,h,w,n,kh,kw,sh,sw,t_run", CASES)
def test_simple_kernel_matches_the_oracle_at_the_geometry_cases(
        card, c_in, h, w, n, kh, kw, sh, sw, t_run, dtype):
    rng = np.random.default_rng(21)
    x, k = layer_from_numpy(rng.standard_normal((c_in, h, w)),
                            rng.standard_normal((n, c_in, kh, kw)),
                            device=card, dtype=dtype)
    got = ops.conv2d(x, k, t_run=t_run, s_h=sh, s_w=sw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.conv2d(x, k, sh, sw).float().cpu().numpy(),
                               **TOL[dtype])


def test_simple_kernel_groups_and_shared_memory_are_the_cuda_sources_own(
        card):
    from repro_torch.core.conv_spec import ConvSpec
    from repro_torch.core.planner import (conv_simple_k_groups,
                                          conv_simple_smem_bytes)
    groups_c = _build.bind("conv2d_offload", "conv2d_offload_k_groups",
                           [ctypes.c_int] * 3, ctypes.c_int)
    smem_c = _build.bind("conv2d_offload", "conv2d_offload_smem_bytes",
                         [ctypes.c_int] * 7, ctypes.c_longlong)
    for t_run in (1, 3, 8, 16, 32, 64):
        for n in (1, 3, 16, 64, 256):
            for k_total in (1, 9, 27, 576):
                assert groups_c(t_run, n, k_total) == \
                    conv_simple_k_groups(t_run, n, k_total)
    for s in list(NETWORKS["resnet8"]) + [ConvSpec(*c[:8]) for c in CASES] \
            + [ConvSpec(128, 6, 6, 256, 3, 3)]:
        for t_run in (1, 2, 4, s.w_out):
            for eb in (4, 2):
                assert smem_c(s.c_in, s.h_k, s.w_k, s.s_w, t_run, s.c_out,
                              eb) == conv_simple_smem_bytes(s, t_run, eb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_simple_kernel_at_a_kernel_set_larger_than_shared_memory(card,
                                                                  dtype):
    """Λ of 128 -> 256 3x3 kernels is 1.2 MB in f32, far more than one
    block's shared memory: the kernel reads it through L1 in w's own
    layout, 1152 terms split over two groups, and agrees all the same."""
    rng = np.random.default_rng(22)
    x, k = layer_from_numpy(rng.standard_normal((128, 6, 6)),
                            rng.standard_normal((256, 128, 3, 3)) / 8,
                            device=card, dtype=dtype)
    got = conv.conv2d_offload(x, k, t_run=4)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        conv.conv2d_offload_plain(x, k, t_run=4).float().cpu().numpy(),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(40, 8), (48, 8), (28, 4)])
def test_decode_kernel_at_the_transformer_families_query_groups(card, hq,
                                                                hkv, dtype):
    """G = 5, 6 and 7 query rows per KV head at D = 128 (Qwen2.5's 40/8,
    DBRX's 48/8, Qwen2-7B's 28/4), the planner's splits at S = 512,
    against the plain split-then-combine."""
    b, s, d = 4, 512, 128
    q, k, v = _decode_inputs(card, 23, b, hq, hkv, d, s, dtype)
    lengths = torch.tensor([1, 200, 481, s], dtype=torch.int32, device=card)
    bkv, splits = ops._planned_split(s, d, hq // hkv, b * hkv,
                                     k.element_size())
    got = ops.decode_attention(q, k, v, lengths)
    want = fd.decode_attention_plain(q, k, v, lengths, bkv=bkv,
                                     splits=splits)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("arch", ["qwen2-7b", "dbrx-132b",
                                  "deepseek-v2-236b"])
def test_graph_replay_equals_eager_decode(card, arch):
    """The decode step captured as a CUDA graph against ``decode_fn`` run
    eagerly on the same cache state, at three teacher-forced positions of
    the reduced config: a dense, an MoE and an MLA id.  Both run the same
    kernels on the same inputs; within ``1e-3`` of the largest logit, in
    case cuBLAS picks another algorithm under capture (``chip_smoke.py``
    prints whether they are bit-identical at full width).  K5's launches
    per replay are the GQA layers (none for MLA)."""
    api = registry.get_reduced(arch)
    params = api.init_params(3, device=card)
    rng = np.random.default_rng(24)
    toks = torch.from_numpy(rng.integers(0, api.cfg.vocab, size=(2, 12))
                            ).to(card)
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :8]}, max_len=16)
    step = steps.graph_decode_step(api, params, cache, 2)
    want = 0 if api.cfg.mla else api.cfg.n_layers
    assert step.launches_per_replay["flash_decode"] == want
    for pos in range(8, 11):
        eager, _ = api.decode_fn(params, cache, toks[:, pos:pos + 1], pos)
        eager = eager.clone()
        got = step(toks[:, pos:pos + 1], pos).clone()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        rel = ((got - eager).abs().max() / eager.abs().max()).item()
        assert rel <= 1e-3, (pos, rel)
    assert step.replays == 3


def test_graph_decode_step_raises_on_cpu_tensors(card):
    """Parameters on the card with a cache on the CPU, or everything on
    the CPU: refused before anything is captured."""
    api = registry.get_reduced("tinyllama-1.1b")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    for dev in ("cpu", card):
        params = api.init_params(0, device=dev)
        _, cache = api.prefill_fn(params, {"tokens": toks.to(dev)},
                                  max_len=8)
        cache = {name: c.cpu() for name, c in cache.items()}
        with pytest.raises(ValueError, match="make_decode_step"):
            steps.graph_decode_step(api, params, cache, 1)


def _serving_inputs(api, card, seed, b, t):
    """A prefill batch of ``api``'s family (Whisper's frames, else tokens)
    and teacher-forced tokens, on the card."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, api.cfg.vocab, size=(b, t + 3))
                            ).to(card)
    if api.cfg.family == "audio":
        frames = torch.from_numpy(rng.standard_normal(
            (b, t, api.cfg.d_model))).to(card, torch.bfloat16)
        return {"frames": frames}, toks[:, t:], 1
    return {"tokens": toks[:, :t]}, toks[:, t:], t


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_graph_replay_equals_eager_decode_bit_for_bit(card, arch):
    """The SSM, hybrid and encoder-decoder steps captured as a CUDA graph
    against ``decode_fn`` run eagerly from the same cache state (what the
    step writes is put back between the two), at three teacher-forced
    positions of the reduced config: the same kernels on the same inputs,
    so the logits are equal bit for bit.  K5's launches per replay: none
    for Mamba2, one per shared block application for Zamba2, two per
    decoder layer for Whisper."""
    api = registry.get_reduced(arch)
    cfg = api.cfg
    params = api.init_params(3, device=card)
    batch, toks, start = _serving_inputs(api, card, 25, 2, 8)
    _, cache = api.prefill_fn(params, batch, max_len=16)
    step = steps.graph_decode_step(api, params, cache, 2)
    want = (2 * cfg.dec_layers if cfg.family == "audio" else
            cfg.n_layers // cfg.attn_every if cfg.attn_every else 0)
    assert step.launches_per_replay["flash_decode"] == want
    for i, pos in enumerate(range(start, start + 3)):
        tok = toks[:, i:i + 1]
        written = api.step_writes(cache, pos)
        before = [t.clone() for t in written]
        eager = api.decode_fn(params, cache, tok, pos)[0].clone()
        for t, b in zip(written, before):
            t.copy_(b)
        got = step(tok, pos).clone()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert torch.equal(got, eager), pos
    assert step.replays == 3


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_a_second_capture_leaves_the_prefill_state_unchanged(card, arch):
    """The warm-up steps and the capture run the step for real; the graph
    step puts back what they wrote (the SSM state whole, the warm-up
    position's KV row), so after one capture and after a second over the
    same cache, every cache tensor is the prefill's."""
    api = registry.get_reduced(arch)
    params = api.init_params(4, device=card)
    batch, _, _ = _serving_inputs(api, card, 26, 2, 8)
    _, cache = api.prefill_fn(params, batch, max_len=16)
    prefilled = [t.clone() for t in leaves(cache)]
    for _ in range(2):
        steps.graph_decode_step(api, params, cache, 2)
        torch.cuda.synchronize()
        for t, want in zip(leaves(cache), prefilled, strict=True):
            assert torch.equal(t, want)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-7b",
                                  "zamba2-2.7b"])
def test_the_decode_kernel_reads_the_cache_in_place(card, arch):
    """Prefill sizes the GQA cache to the rows K5's plan walks (49 ->
    64 at batch 4), so every launch of a decode step reads the cache's
    own layer views: the k and v that reach the kernel's wrapper share
    their storage (data pointer) with the cache."""
    api = registry.get_reduced(arch)
    params = api.init_params(2, device=card)
    toks = torch.zeros((4, 33), dtype=torch.int64, device=card)
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :32]}, max_len=49)
    kv = cache["attn"] if api.cfg.family == "hybrid" else cache
    seen = []
    real = fd.decode_attention

    def spy(q, k, v, lengths, **kw):
        seen.append((k.data_ptr(), v.data_ptr()))
        return real(q, k, v, lengths, **kw)

    fd.decode_attention = spy
    try:
        api.decode_fn(params, cache, toks[:, 32:], 32)
    finally:
        fd.decode_attention = real
    torch.cuda.synchronize()
    want = [(kv["k"][i].data_ptr(), kv["v"][i].data_ptr())
            for i in range(kv["k"].shape[0])]
    assert kv["k"].shape[2] == 64 and seen == want


def test_a_train_step_on_the_card_equals_the_cpus(card):
    """The reduced TinyLlama in float32, one batch: the loss and every
    gradient on the card against the CPU's (float32 sums in another
    order: 1e-5 and 1e-4, as against the JAX package), then one AdamW
    step of ``make_train_step`` with 2 microbatches, its loss and norm."""
    from repro_torch.models.common import map_defs
    from repro_torch.optim import adamw
    api = registry.get_reduced("tinyllama-1.1b")
    cpu = map_defs(lambda t: t.float(), api.init_params(3, device="cpu"))
    rng = np.random.default_rng(27)
    toks = torch.from_numpy(rng.integers(0, api.cfg.vocab, size=(4, 14)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    gpu = map_defs(lambda t: t.to(card), cpu)
    gbatch = {k: v.to(card) for k, v in batch.items()}
    loss_c, grads_c = steps.value_and_grad(api, cpu, batch)
    loss_g, grads_g = steps.value_and_grad(api, gpu, gbatch)
    assert abs(loss_g.item() - loss_c.item()) <= 1e-5 * abs(loss_c.item())
    for g, c in zip(grads_g, grads_c, strict=True):
        assert (g.cpu() - c).norm() <= 1e-4 * c.norm()
    step = steps.make_train_step(api, num_microbatches=2)
    out_c = step(cpu, adamw.init(cpu), batch)
    out_g = step(gpu, adamw.init(gpu), gbatch)
    for a, b in zip(out_g[:2], out_c[:2]):
        assert abs(a.item() - b.item()) <= 1e-4 * abs(b.item())
    assert all(t.device.type == "cuda" for t in leaves(out_g[2]))


def test_the_rate_probe_reads_its_clock_and_both_rates_under_load(card):
    """``tools/l2_probe.py --rates``, one variant of each case: in case (c)
    (K3's boxes landing while K3's m64n256k16 chain runs in every block)
    the SM clock read in the kernel lies between 0.8 and 2.0 GHz, the
    tensor rate below 1024 FLOP a tensor core a clock (the data sheet's
    4096 an SM), and neither rate is 0."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "l2_probe.py"
    spec = importlib.util.spec_from_file_location("l2_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    res = probe.measure_rates(seconds=0.3, turns=1, quick=True,
                              warmup_max_s=2.0)
    (c,) = [r for r in res["runs"] if r["case"] == "c"]
    assert 0.8e9 <= c["clock_hz"] <= 2.0e9
    assert 0 < c["flops_per_tensor_core_clock"] < 1024
    assert c["tensor_flops"] > 0 and c["landed_bytes_per_s"] > 0


CONV_SPANS = ["conv.run", "conv.check", "conv.geometry", "conv.lambda",
              "conv.alloc", "conv.launch"]
DECODE_SPANS = ["decode.step", "decode.tokens", "decode.pos",
                "decode.replay"]


def test_host_spans_hold_their_runtime_calls_on_the_trace_clock(card):
    """Under the benchmark's profiler session (the card's activity only)
    the gate is on, and one planned ResNet-8 conv call and one replay of
    the decode step record their span trees.  At the offset fitted
    between the host's clock and the trace's, K1's
    ``cudaLaunchKernelExC`` lies inside ``conv.launch`` and the replay's
    ``cudaGraphLaunch`` inside ``decode.replay``."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "bench"))
    from harness import spans as hs
    from harness import trace as trace_mod
    _, em = _resnet8_layers()[1]
    s = em.spec
    rng = np.random.default_rng(31)
    x, k = layer_from_numpy(rng.standard_normal((s.c_in, s.h_in, s.w_in)),
                            rng.standard_normal((s.c_out, s.c_in, s.h_k,
                                                 s.w_k)), device=card)
    api = registry.get_reduced("qwen2-7b")
    params = api.init_params(3, device=card)
    toks = torch.from_numpy(rng.integers(0, api.cfg.vocab, size=(2, 10))
                            ).to(card)
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :8]}, max_len=16)
    step = steps.graph_decode_step(api, params, cache, 2)
    em.run(x, k)
    torch.cuda.synchronize()
    spans.clear()
    gate = []

    def work():
        gate.append(spans.GATE._is_profiler_enabled)
        em.run(x, k)
        step(toks[:, 8:9], 8)

    trace, _ = trace_mod.record(torch, card, work)
    snap = spans.snapshot()
    spans.clear()
    assert gate == [True] and not spans.GATE._is_profiler_enabled
    assert [sp.name for sp in snap.spans] == CONV_SPANS + DECODE_SPANS
    assert [sp.parent for sp in snap.spans] == \
        [-1] + [0] * 5 + [-1] + [6] * 3
    assert snap.spans[0].arg == em.layer_index and snap.dropped == 0
    assert all(sp.end_ns > sp.start_ns for sp in snap.spans)
    assert trace.matching("conv2d_offload_planned_kernel")
    for span_name, call_name in (hs.CONV_CALL, hs.DECODE_CALL):
        fit = hs.fit_clock(snap, trace, span_name, call_name)
        assert fit is not None and fit.matched == fit.spans == 1, span_name
        (host,) = [sp for sp in snap.spans if sp.name == span_name]
        a, b = hs.on_trace(host.start_ns, host.end_ns, fit)
        assert any(a <= c0 and c1 <= b for name, c0, c1, _ in trace.runtime
                   if name == call_name), span_name


def test_the_profiler_sees_the_split_kernel_by_name(card):
    """The benchmark finds K5 by the substrings of its kernels' names in
    its trace (``bench/harness/trace.py``, as ``readers.k5_seconds``
    reads it) and multiplies by the launches counted: three calls, each
    counting one split kernel (on the tensor cores at G 7) and one
    combine, and the trace holding each kernel, at most as often as
    counted (the profiler drops an event at random now and then, as
    ``chip_smoke.PROFILE_SESSIONS`` says, more as the process ages)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "bench"))
    from harness import readers
    from harness import trace as trace_mod
    b, hq, hkv, d, s = 4, 28, 4, 128, 1024
    q, k, v = _decode_inputs(card, 34, b, hq, hkv, d, s, torch.bfloat16)
    lengths = torch.tensor([1, 500, 1000, 1024], dtype=torch.int32,
                           device=card)
    ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    before = dict(COUNTS)
    trace, _ = trace_mod.record(
        torch, card,
        lambda: [ops.decode_attention(q, k, v, lengths) for _ in range(3)])
    _, splits = ops._planned_split(s, d, hq // hkv, b * hkv, 2)
    assert COUNTS["flash_decode"] == before["flash_decode"] + 3
    assert COUNTS["flash_decode_mma"] == before["flash_decode_mma"] + 3
    assert COUNTS["flash_decode_combine"] == \
        before["flash_decode_combine"] + 3 * int(splits > 1)
    for kernel, counter in readers.K5_KERNELS.items():
        counted = COUNTS[counter] - before[counter]
        assert min(1, counted) <= len(trace.matching(kernel)) <= counted, \
            kernel


def test_decode_kernel_at_zamba2_7b_heads_with_its_scale(card):
    """Zamba2-7B's attention: G = 1, D = 224 (28 of the 32 16-byte vectors
    a row may take), the scores scaled by (D / 2) ** -0.5, at the
    planner's splits of a 768-row context, against the plain
    split-then-combine at the same scale; the default scale gives
    another answer, so the argument reaches the kernel."""
    b, h, d = 4, 32, 224
    s = ops.decode_cache_rows(768, d, 1, b * h)
    q, k, v = _decode_inputs(card, 27, b, h, h, d, s, torch.bfloat16)
    lengths = torch.tensor([1, 300, 513, 768], dtype=torch.int32,
                           device=card)
    scale = (d / 2) ** -0.5
    bkv, splits = ops._planned_split(s, d, 1, b * h, 2)
    got = ops.decode_attention(q, k, v, lengths, scale=scale)
    want = fd.decode_attention_plain(q, k, v, lengths, bkv=bkv,
                                     splits=splits, scale=scale)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **TOL[torch.bfloat16])
    plain = ops.decode_attention(q, k, v, lengths)
    assert not torch.allclose(plain.float(), got.float(), rtol=1e-2,
                              atol=1e-2)


def _zamba2_counts(cfg) -> dict:
    apps = len(cfg.hybrid_layer_ids)
    return {"flash_decode": apps, "ssm_update": cfg.n_layers,
            "ssd_update_kernel": cfg.n_layers,
            "zamba2_block0": (apps + 1) // 2, "zamba2_block1": apps // 2}


def test_zamba2_graph_replay_equals_eager_decode_bit_for_bit(card):
    """Zamba2 as published, reduced (8 layers, both blocks applied
    twice): the step captured as a CUDA graph against ``decode_fn`` run
    eagerly from the same cache state, bit for bit, at three
    teacher-forced positions; a replay counts every layer's recurrent
    update and one launch of the fused update kernel for each, each
    application by block, and K5 once an application."""
    api = registry.get_reduced("zamba2-7b")
    params = api.init_params(3, device=card)
    batch, toks, start = _serving_inputs(api, card, 28, 2, 8)
    _, cache = api.prefill_fn(params, batch, max_len=16)
    step = steps.graph_decode_step(api, params, cache, 2)
    for name, want in _zamba2_counts(api.cfg).items():
        assert step.launches_per_replay[name] == want, name
    for i, pos in enumerate(range(start, start + 3)):
        tok = toks[:, i:i + 1]
        written = api.step_writes(cache, pos)
        before = [t.clone() for t in written]
        eager = api.decode_fn(params, cache, tok, pos)[0].clone()
        for t, b in zip(written, before):
            t.copy_(b)
        got = step(tok, pos).clone()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert torch.equal(got, eager), pos
    assert step.replays == 3


def test_zamba2_at_the_published_depth_counts_81_updates_and_13_applications(
        card):
    """81 layers with the published hybrid layers, at the reduced widths:
    a replay makes 81 recurrent updates (81 launches of the fused update
    kernel), 7 applications of block 0 and 6 of block 1, and 13 K5
    launches."""
    published = registry.get("zamba2-7b").cfg
    api = registry.get_reduced("zamba2-7b", n_layers=published.n_layers,
                               hybrid_layer_ids=published.hybrid_layer_ids)
    params = api.init_params(5, device=card)
    batch, _, _ = _serving_inputs(api, card, 29, 2, 8)
    _, cache = api.prefill_fn(params, batch, max_len=16)
    step = steps.graph_decode_step(api, params, cache, 2)
    counts = _zamba2_counts(api.cfg)
    assert (counts["ssm_update"], counts["zamba2_block0"],
            counts["zamba2_block1"], counts["flash_decode"]) == (81, 7, 6, 13)
    for name, want in counts.items():
        assert step.launches_per_replay[name] == want, name
