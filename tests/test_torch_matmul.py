"""The port's block GeMM (K3, K4) against the JAX package, on the CPU: the
same numpy inputs go through ``repro`` (Pallas ``block_matmul``, interpret
mode; ``ops.matmul``) and through ``repro_torch`` (on CPU tensors the
wrappers run ``block_matmul_plain``, which walks the CUDA kernels'
launches, blocks and steps).

Tolerances.  B is scaled by ``1/sqrt(k)`` so every sum is O(1).  float32:
``rtol = atol = 1e-4`` — both sides sum in f32, in another order inside a
tile.  bfloat16, compared in f32: ``rtol = 1.6e-2, atol = 1e-2`` — the
products and sums are f32 on both sides and each result is rounded to
bfloat16 once, so they differ by at most that rounding, one unit in the
last place (2**-7 relative).  Not the 2.0 of ``tests/test_kernels.py:77``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro.kernels import block_matmul as jbm
from repro.kernels import ops as jops
from repro_torch.core import planner
from repro_torch.core.cost_model import H100_SXM
from repro_torch.kernels import KernelShapeError, ops, ref
from repro_torch.kernels import block_matmul as bm

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=1.6e-2, atol=1e-2)}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ORDERS = ("mnk", "nmk", "mkn", "nkm", "kmn", "knm")

# tests/test_kernels.py:57-62
CASES = [
    (64, 64, 64, 32, 32, 32),
    (200, 150, 300, 64, 64, 64),
    (128, 128, 128, 128, 128, 128),
    (96, 257, 130, 32, 64, 64),
]


def _arrays(seed, m, n, k):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return a, b


def _pad(x, rows, cols):
    return np.pad(x, ((0, (-x.shape[0]) % rows), (0, (-x.shape[1]) % cols)))


def _torch(x, dtype):
    return torch.from_numpy(x).to(TORCH_DTYPE[dtype])


def _jax(x, dtype):
    return jnp.asarray(x, JAX_DTYPE[dtype])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, dtype):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("m,n,k,bm_,bn_,bk_", CASES)
def test_block_matmul_matches_the_jax_kernel(m, n, k, bm_, bn_, bk_, order,
                                             dtype):
    """The kernel-level function on inputs padded to the tiles, all six
    orders: K3 for k innermost, K4 otherwise."""
    a, b = _arrays(50, m, n, k)
    a, b = _pad(a, bm_, bk_), _pad(b, bk_, bn_)
    out = bm.block_matmul(_torch(a, dtype), _torch(b, dtype), bm=bm_,
                          bn=bn_, bk=bk_, order=order)
    assert out.dtype == TORCH_DTYPE[dtype]
    want = jbm.block_matmul(_jax(a, dtype), _jax(b, dtype), bm=bm_, bn=bn_,
                            bk=bk_, order=order, interpret=True)
    _close(out, want, dtype)
    _close(out, ref.matmul(_torch(a, dtype), _torch(b, dtype)), dtype)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("m,n,k,bm_,bn_,bk_", CASES)
def test_ops_matmul_pads_like_the_jax_entry_point(m, n, k, bm_, bn_, bk_,
                                                  order):
    a, b = _arrays(51, m, n, k)
    out = ops.matmul(_torch(a, "float32"), _torch(b, "float32"), bm=bm_,
                     bn=bn_, bk=bk_, order=order)
    assert tuple(out.shape) == (m, n)
    _close(out, jops.matmul(a, b, bm=bm_, bn=bn_, bk=bk_, order=order),
           "float32")
    _close(out, a @ b, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_order_gives_the_same_bfloat16_result(dtype):
    """Both bodies sum each C value's k tiles in order in f32 and round
    once, so the six orders agree bit for bit — in the JAX kernel and in
    the port."""
    a, b = _arrays(52, 64, 64, 96)
    port = [bm.block_matmul(_torch(a, dtype), _torch(b, dtype), bm=32,
                            bn=32, bk=32, order=o) for o in ORDERS]
    jax_ = [np.asarray(jbm.block_matmul(_jax(a, dtype), _jax(b, dtype),
                                        bm=32, bn=32, bk=32, order=o,
                                        interpret=True), np.float32)
            for o in ORDERS]
    for o, p, j in zip(ORDERS, port, jax_):
        assert torch.equal(p, port[0]), o
        np.testing.assert_array_equal(j, jax_[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_matmul_with_the_planners_tiles(dtype):
    """``order=None``: each package asks its own planner (H100 vs TPU
    budgets), so the tiles differ; the result may not."""
    a, b = _arrays(53, 40, 72, 56)
    out = ops.matmul(_torch(a, dtype), _torch(b, dtype))
    assert tuple(out.shape) == (40, 72)
    _close(out, jops.matmul(_jax(a, dtype), _jax(b, dtype)), dtype)
    _close(out, ref.matmul(_torch(a, dtype), _torch(b, dtype)), dtype)


@pytest.mark.parametrize("order", ORDERS)
def test_the_kernels_traffic_is_what_the_planner_prices(order):
    """The plain version counts the tile fetches and C partials the CUDA
    kernel makes (a block fetches a tile only when its index changes):
    their bytes are ``_gemm_bytes``'s, with f32 partials."""
    m, n, k, t = 64, 96, 128, 32
    a, b = _arrays(54, m, n, k)
    _, loads = bm.block_matmul_plain(_torch(a, "bfloat16"),
                                     _torch(b, "bfloat16"), bm=t, bn=t,
                                     bk=t, order=order, return_loads=True)
    moved = ((loads["a"] + loads["b"] + loads["c_writes"]) * t * t * 2
             + (loads["c_partial_reads"] + loads["c_partial_writes"])
             * t * t * 4)
    assert moved == planner._gemm_bytes(m // t, n // t, k // t, t, t, t,
                                        m, n, k, order, 2, 4)
    assert loads["c_writes"] == (m // t) * (n // t)


def test_launch_plan_keeps_partial_sums_of_a_tile_in_one_block():
    trips = {"m": 3, "n": 4, "k": 5}
    assert bm.launch_plan("mnk", trips) == [(("m", "n"), 0, 5)]
    assert bm.launch_plan("nkm", trips) == [(("n",), 0, 5)]
    assert bm.launch_plan("kmn", trips) == [(("m",), kk, 1)
                                            for kk in range(5)]
    steps = list(bm.block_steps("mkn", {"m": 2, "n": 0, "k": 0},
                                {"m": 1, "n": 4, "k": 5}))
    assert steps[:5] == [(2, 0, 0), (2, 1, 0), (2, 2, 0), (2, 3, 0),
                         (2, 0, 1)]
    assert len(steps) == 20
    for order in ORDERS:       # the planner counts the blocks of a launch
        grid_dims, _, _ = bm.launch_plan(order, trips)[0]
        assert planner.gemm_grid_blocks(order, trips) == \
            np.prod([trips[d] for d in grid_dims]) \
            * planner.gemm_cluster_size(order, trips)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("trips", [{"m": 3, "n": 4, "k": 5},
                                   {"m": 10, "n": 11, "k": 2},
                                   {"m": 1, "n": 1, "k": 3}])
def test_the_grid_holds_the_clusters_the_planner_counts(order, trips):
    """Every launch's CUDA grid is ``gemm_grid_blocks`` blocks, its x
    extent a multiple of the cluster; its blocks' steps visit every
    (m, n) tile of the launch's k tiles once, each C tile in one block."""
    cs = planner.gemm_cluster_size(order, trips)
    assert cs == (1 if order[2] == "k" else min(8, trips[order[2]]))
    seen = []
    for grid_dims, k_lo, k_cnt in bm.launch_plan(order, trips):
        grid_x, grid_y, axes = bm.launch_grid(grid_dims, trips, cs)
        assert grid_x * grid_y == planner.gemm_grid_blocks(order, trips)
        assert grid_x % cs == 0 and set(axes) == set(grid_dims)
        blocks = list(bm.cluster_blocks(order, trips, grid_dims, cs))
        assert len(blocks) == grid_x * grid_y
        for _, lo, cnt, step in blocks:
            lo["k"], cnt["k"] = k_lo, k_cnt
            steps = list(bm.block_steps(order, lo, cnt, step))
            seen += steps
            tiles = {(mm, nn) for mm, nn, _ in steps}
            ks = [kk for mm, nn, kk in steps if (mm, nn) == min(tiles)]
            assert ks == sorted(ks)          # each C tile's k tiles in order
    assert sorted(seen) == sorted(
        (mm, nn, kk) for mm in range(trips["m"]) for nn in range(trips["n"])
        for kk in range(trips["k"]))


def test_the_planner_keeps_the_grid_wide():
    """A grid of fewer blocks than the card's SMs gets that share of the
    card, K4's blocks counted with its cluster: at TinyLlama's prefill
    projections the pick fills at least 90 % of the SMs, its duration is
    priced with that share, and no tile and order the kernel takes is
    priced lower."""
    for k, n in [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]:
        for dtype_bytes in (2, 4):
            p = planner.plan_matmul(1920, n, k, dtype_bytes=dtype_bytes)
            t = p.tiles
            trips = {"m": 1920 // t["bm"], "n": n // t["bn"],
                     "k": k // t["bk"]}
            blocks = planner.gemm_grid_blocks(p.order, trips)
            assert blocks >= 0.9 * H100_SXM.n_sms
            share = min(1.0, blocks / H100_SXM.n_sms)
            want = max(p.hbm_bytes / H100_SXM.hbm_bw,
                       p.flops / H100_SXM.peak_flops) / share
            assert p.duration_overlapped == pytest.approx(want, rel=1e-12)
            for bm_, bn_, bk_ in itertools.product(
                    (16, 32, 64, 128), (16, 32, 64, 128),
                    (16, 32, 64, 128, 256, 512, 1024)):
                if planner.matmul_smem_bytes(bm_, bn_, bk_, dtype_bytes) \
                        > H100_SXM.smem_bytes_per_block:
                    continue
                tr = {"m": -(-1920 // bm_), "n": -(-n // bn_),
                      "k": -(-k // bk_)}
                for order in ORDERS:
                    hbm = planner._gemm_bytes(tr["m"], tr["n"], tr["k"], bm_,
                                              bn_, bk_, 1920, n, k, order,
                                              dtype_bytes, 4)
                    sh = min(1.0, planner.gemm_grid_blocks(order, tr)
                             / H100_SXM.n_sms)
                    cand = max(hbm / H100_SXM.hbm_bw,
                               p.flops / H100_SXM.peak_flops) / sh
                    assert cand >= p.duration_overlapped * (1 - 1e-12)


# (m, n, k, tile) by K4's cluster size min(8, inner trips): inner trips of
# 1, 2 and 3, and trips (m 10, n 11, k 3), which split every K4 inner loop
# raggedly over 8 blocks
CLUSTER_SHAPES = {1: (16, 16, 48, 16), 2: (32, 32, 48, 16),
                  3: (48, 48, 48, 16), 8: (160, 176, 48, 16)}


@pytest.mark.parametrize("cs", sorted(CLUSTER_SHAPES))
@pytest.mark.parametrize("order", ORDERS)
def test_the_clusters_traffic_is_what_the_planner_prices(order, cs):
    """In a K4 cluster rank 0 alone fetches the resident tile and each
    rank its own streamed tiles, so the device-memory traffic is the
    sequential sweep's, ``_gemm_bytes``, at every cluster size; the result
    is the same, bit for bit.  K3 takes no cluster."""
    m, n, k, t = CLUSTER_SHAPES[cs]
    trips = {"m": m // t, "n": n // t, "k": k // t}
    assert planner.gemm_cluster_size(order, trips) == \
        (1 if order[2] == "k" else cs)
    a, b = _arrays(55, m, n, k)
    a, b = _torch(a, "bfloat16"), _torch(b, "bfloat16")
    out, loads = bm.block_matmul_plain(a, b, bm=t, bn=t, bk=t, order=order,
                                       return_loads=True)
    moved = ((loads["a"] + loads["b"] + loads["c_writes"]) * t * t * 2
             + (loads["c_partial_reads"] + loads["c_partial_writes"])
             * t * t * 4)
    assert moved == planner._gemm_bytes(m // t, n // t, k // t, t, t, t,
                                        m, n, k, order, 2, 4)
    assert torch.equal(out, bm.block_matmul_plain(a, b, bm=t, bn=t, bk=t,
                                                  order="mnk"))


@pytest.mark.parametrize("m,n,k", [(4, 72, 56), (3, 5, 7), (40, 72, 56),
                                   (40, 8192, 64)])
def test_ops_matmul_picks_tiles_the_kernel_takes(monkeypatch, m, n, k):
    """Planned tiles are clamped to the next power of two of a small dim
    and to no less than 16, so a product with a dim of 8 or less gets
    tiles the CUDA kernel takes (multiples of 16) and is padded to them."""
    seen = []
    launch = bm.block_matmul

    def spy(a, b, **tiles):
        seen.append(tiles)
        return launch(a, b, **tiles)

    monkeypatch.setattr(bm, "block_matmul", spy)
    a, b = _arrays(56, m, n, k)
    out = ops.matmul(_torch(a, "bfloat16"), _torch(b, "bfloat16"))
    (tiles,) = seen
    bm.kernel_limits(tiles["bm"], tiles["bn"], tiles["bk"], 2)
    _close(out, ref.matmul(_torch(a, "bfloat16"), _torch(b, "bfloat16")),
           "bfloat16")


# the wgmma core's fixed bytes: 1024 of alignment slack, 256 of mbarriers
_WG = 1024 + 256


@pytest.mark.parametrize("bm_,bn_,bk_,dtype_bytes,rmw,want", [
    # wgmma: the rings' slots of unpadded A and B tiles (as many as fit,
    # 2-4), K4's f32 partial C stage, the fixed bytes
    (128, 128, 128, 2, False, _WG + 3 * (128 * 128 + 128 * 128) * 2),
    (128, 128, 128, 2, True, _WG + 2 * (128 * 128 + 128 * 128) * 2
     + 128 * 128 * 4),
    (64, 32, 512, 2, True, _WG + 2 * (64 * 512 + 512 * 32) * 2
     + 64 * 32 * 4),
    (64, 32, 512, 2, False, _WG + 2 * (64 * 512 + 512 * 32) * 2),
    (64, 16, 16, 2, False, _WG + 4 * (64 * 16 + 16 * 16) * 2),
    # mma.sync and fma, either kernel: two stages, each row padded by 16
    # bytes
    (128, 128, 64, 4, False, 2 * (128 * 68 + 64 * 132) * 4),
    (16, 16, 16, 2, False, 2 * (16 * 24 + 16 * 24) * 2),
    (48, 32, 32, 2, True, 2 * (48 * 40 + 32 * 40) * 2),
    (32, 64, 48, 4, True, 2 * (32 * 52 + 48 * 68) * 4),
])
def test_matmul_smem_bytes_is_two_padded_stages(bm_, bn_, bk_, dtype_bytes,
                                                rmw, want):
    """The kernel's allocation (``block_matmul_smem_bytes``), by core:
    two stages of A (bm, bk) and B (bk, bn) tiles, each row padded by 16
    bytes, on the mma.sync and fma cores; on the wgmma core the rings'
    slots of swizzled, unpadded tiles (one more would not fit, or there
    are 4), K4's partial C stage and the fixed bytes."""
    assert planner.matmul_smem_bytes(bm_, bn_, bk_, dtype_bytes,
                                     rmw=rmw) == want
    if planner.matmul_core(bm_, bn_, bk_, dtype_bytes) != "wgmma":
        assert planner.matmul_smem_bytes(bm_, bn_, bk_, dtype_bytes,
                                         rmw=not rmw) == want
        return
    stages = planner.matmul_wg_stages(bm_, bn_, bk_, rmw)
    stage = 2 * (bm_ * bk_ + bk_ * bn_)
    assert want == _WG + stages * stage + (4 * bm_ * bn_ if rmw else 0)
    assert want <= H100_SXM.smem_bytes_per_block
    assert stages == 4 or want + stage > H100_SXM.smem_bytes_per_block


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_core_of_takes_wgmma_exactly_for_bfloat16_warpgroup_tiles(dtype):
    """wgmma for bfloat16 tiles with bm % 64 == 0, mma.sync for the other
    bfloat16 tiles (16-80 rows), fma for float32, whatever bn and bk."""
    for bm_, bn_, bk_ in itertools.product(range(16, 129, 16),
                                           range(16, 129, 16),
                                           (16, 48, 128, 512)):
        core = bm.core_of(bm_, bn_, bk_, dtype)
        if dtype == torch.float32:
            assert core == "fma"
        else:
            assert core == ("wgmma" if bm_ % 64 == 0 else "mma.sync")
        assert core == planner.matmul_core(bm_, bn_, bk_,
                                           2 if dtype == torch.bfloat16
                                           else 4)


# plan_matmul's choices at TinyLlama's prefill projections and at the
# small-m products chip_smoke.py drives, as the planner made them before
# the wgmma core's shared-memory formula: (m, n, k) -> bf16 and f32
# (bm, bn, bk, order)
PLANNED = {
    (1920, 2048, 2048): ((128, 128, 128, "mnk"), (128, 128, 64, "mnk")),
    (1920, 256, 2048): ((64, 32, 512, "mkn"), (64, 32, 256, "mkn")),
    (1920, 5632, 2048): ((128, 128, 128, "mnk"), (128, 128, 64, "mnk")),
    (1920, 2048, 5632): ((128, 128, 128, "mnk"), (128, 128, 64, "mnk")),
    (40, 8192, 2048): ((48, 64, 256, "mnk"), (48, 64, 128, "mnk")),
    (80, 8192, 2048): ((80, 64, 256, "mnk"), (80, 64, 128, "mnk")),
    (4, 2048, 2048): ((16, 16, 1024, "mnk"), (16, 16, 512, "mnk")),
}


@pytest.mark.parametrize("m,n,k", sorted(PLANNED))
def test_plan_matmul_keeps_its_tiles_and_order(m, n, k):
    """The per-core shared-memory formula leaves every tile the planner
    chose feasible and makes none feasible that was not: the choices
    stay, and the bfloat16 prefill tiles run on the wgmma core."""
    for dtype_bytes, want in zip((2, 4), PLANNED[(m, n, k)]):
        p = planner.plan_matmul(m, n, k, dtype_bytes=dtype_bytes)
        t = p.tiles
        assert (t["bm"], t["bn"], t["bk"], p.order) == want
        if m == 1920 and dtype_bytes == 2:
            assert planner.matmul_core(t["bm"], t["bn"], t["bk"], 2) \
                == "wgmma"


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("m,n,k", [(1920, 2048, 2048), (1920, 256, 2048),
                                   (1920, 5632, 2048), (1920, 2048, 5632),
                                   (8192, 8192, 8192), (40, 72, 56)])
def test_plan_matmul_fits_one_blocks_shared_memory(m, n, k, dtype_bytes):
    p = planner.plan_matmul(m, n, k, dtype_bytes=dtype_bytes)
    t = p.tiles
    assert p.smem_bytes == planner.matmul_smem_bytes(
        t["bm"], t["bn"], t["bk"], dtype_bytes, rmw=p.order[2] != "k")
    assert p.smem_bytes <= H100_SXM.smem_bytes_per_block
    assert t["bm"] <= planner.MATMUL_MAX_TILE >= t["bn"]
    assert all(v % 16 == 0 for v in t.values())
    bm.kernel_limits(t["bm"], t["bn"], t["bk"], dtype_bytes)
    assert p.hbm_bytes >= (m * k + k * n + m * n) * dtype_bytes
    assert p.duration_overlapped <= p.duration_additive


def test_shape_errors_are_typed():
    """As ``tests/test_kernels.py:187-193`` for the reference."""
    a = torch.zeros((64, 64))
    with pytest.raises(KernelShapeError):      # tiles must divide dims
        bm.block_matmul(a, a, bm=48, bn=32, bk=32, order="mnk")
    with pytest.raises(KernelShapeError):      # bad order permutation
        bm.block_matmul(a, a, bm=32, bn=32, bk=32, order="mmk")
    with pytest.raises(KernelShapeError):      # inner dims differ
        bm.block_matmul(a, torch.zeros((32, 64)), bm=32, bn=32, bk=32)
    with pytest.raises(KernelShapeError):      # mixed dtypes
        bm.block_matmul(a, a.to(torch.bfloat16), bm=32, bn=32, bk=32)
    with pytest.raises(KernelShapeError, match="bm, bn <= 128"):
        bm.kernel_limits(256, 64, 32, 2)
    with pytest.raises(KernelShapeError, match="shared memory"):
        bm.kernel_limits(128, 128, 512, 4)


def test_the_kernel_refuses_tiles_off_16_and_misaligned_views():
    """Tensor-core fragments and 16-byte copies: every tile a multiple of
    16, each tensor starting on 16 bytes (raised, never copied)."""
    for tiles in [(48, 24, 32), (40, 32, 32), (32, 32, 8)]:
        with pytest.raises(KernelShapeError, match="multiples of 16"):
            bm.kernel_limits(*tiles, 2)
    whole = torch.zeros(64 * 64 + 4)
    view = whole[1:1 + 64 * 64].view(64, 64)       # 4 bytes past the start
    assert view.is_contiguous()
    with pytest.raises(KernelShapeError, match="16 bytes"):
        bm.kernel_limits(32, 32, 32, 4, whole[:4096].view(64, 64), view)
    bm.kernel_limits(32, 32, 32, 4, whole[4:4 + 4096].view(64, 64))
