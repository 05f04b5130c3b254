"""Tests that need the card: the CUDA kernels against their plain PyTorch
versions on CUDA tensors.  Marked ``gpu``; without a CUDA device they skip
(decided inside the fixture, never at import).  Run them on a machine with
an NVIDIA GPU and ``nvcc``::

    python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` makes the same comparisons at full width (ResNet-8's
layers, TinyLlama-1.1B's projections and decode attention).
"""
import ctypes

import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro_torch.configs.networks import NETWORKS
from repro_torch.core.cost_model import H100_SXM
from repro_torch.core.planner import (conv_cluster_size, decode_smem_bytes,
                                      matmul_smem_bytes)
from repro_torch.kernels import KernelShapeError, _build, ops, ref
from repro_torch.kernels import block_matmul as bm
from repro_torch.kernels import conv2d_offload as conv
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.emit import emit_layer_kernel, plan_emitable_network
from repro_torch.reference_io import layer_from_numpy

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
    before = dict(conv.LAUNCHES)
    for name, kernel, plain in (
            ("conv2d_offload", conv.conv2d_offload,
             conv.conv2d_offload_plain),
            ("conv2d_offload_planned", conv.conv2d_offload_planned,
             conv.conv2d_offload_planned_plain)):
        got = kernel(x, k, **kw_)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == dtype
        assert conv.LAUNCHES[name] == before[name] + 1
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


# the planned kernel's cluster of 1, 2, 4 and 8 blocks: the geometry cases
# with N = 8, 16, 32, 64 kernel channels, and every ResNet-8 layer at its
# planned run length (N = 16, 32, 64)
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
    """Each rank of the cluster computes its channels; every step's box
    is fetched once per cluster, so the fetch counter grows by the boxes
    the plain version sliced plus Λ, whatever the cluster size."""
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


def test_cluster_size_and_footprint_are_the_cuda_sources_own(card):
    cs_c = _build.bind("conv2d_offload_planned",
                       "conv2d_offload_planned_cluster_size",
                       [ctypes.c_int], ctypes.c_int)
    elems_c = _build.bind("conv2d_offload_planned",
                          "conv2d_offload_planned_smem_elements",
                          [ctypes.c_int] * 9, ctypes.c_longlong)
    for n in range(1, 200):
        assert cs_c(n) == conv_cluster_size(n)
    for c_in, n, kh, kw, sh, sw, t in [(3, 16, 3, 3, 1, 1, 16),
                                       (64, 64, 3, 3, 1, 1, 8),
                                       (2, 24, 5, 3, 1, 2, 2),
                                       (2, 40, 3, 3, 3, 1, 9),
                                       (1, 8, 1, 1, 1, 1, 4)]:
        for row_delta in (0, 1):
            assert elems_c(c_in, n, kh, kw, sh, sw, t, row_delta,
                           conv_cluster_size(n)) == \
                conv.planned_smem_elements(c_in, n, kh, kw, sh, sw, t,
                                           row_delta=bool(row_delta))


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
    before = bm.LAUNCHES[name]
    got = ops.matmul(a, b, bm=bm_, bn=bn_, bk=bk_, order=order)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == dtype and got.shape == (m, n)
    assert bm.LAUNCHES[name] > before
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
    if decode_smem_bytes(hq // hkv, d, bkv, k.element_size()) \
            > conv.SMEM_LIMIT_BYTES:
        # float32 blocks of 256 rows of D = 128 do not fit one block's
        # shared memory: the kernel refuses them, and runs 128-row blocks
        with pytest.raises(KernelShapeError, match="shared memory"):
            fd.decode_attention(q, k, v, lengths, bkv=bkv)
        bkv //= 2
    before = fd.LAUNCHES["flash_decode"]
    got = fd.decode_attention(q, k, v, lengths, bkv=bkv)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode"] == before + 1
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
