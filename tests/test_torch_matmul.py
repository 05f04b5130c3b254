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


_TERMS = ("operations", "l2", "dram", "push")


def test_the_planner_keeps_the_grid_wide():
    """A grid runs in waves of the blocks its clusters fit at once and gets
    its blocks over its waves' SMs of the card, K4's blocks counted with
    its cluster: at TinyLlama's prefill
    projections the pick fills at least 90 % of the SMs, its duration is
    the largest of its terms (operations, L2, device memory, K4's pushes;
    ``planner.gemm_terms``), each priced with that share, and no tile,
    order and K3 cluster the kernel takes is priced lower."""
    for k, n in [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]:
        for dtype_bytes in (2, 4):
            p = planner.plan_matmul(1920, n, k, dtype_bytes=dtype_bytes)
            t = p.tiles
            trips = {"m": 1920 // t["bm"], "n": n // t["bn"],
                     "k": k // t["bk"]}
            blocks = planner.gemm_grid_blocks(p.order, trips)
            assert blocks >= 0.9 * H100_SXM.n_sms
            terms = planner.gemm_terms(trips, t["bm"], t["bn"], t["bk"],
                                       p.order, p.cluster, dtype_bytes)
            fill = H100_SXM.sms_in_clusters_of_4 if p.cluster == (2, 2) \
                else H100_SXM.n_sms          # SMs its clusters fill
            waves = -(-blocks // fill)
            assert terms["share"] == blocks / (waves * H100_SXM.n_sms)
            want = max(terms[x] for x in _TERMS)
            assert p.duration_overlapped == pytest.approx(want, rel=1e-12)
            for bm_, bn_, bk_ in itertools.product(
                    (16, 32, 64, 128), (16, 32, 64, 128, 256),
                    (16, 32, 64, 128, 256, 512, 1024)):
                if bn_ > planner.matmul_max_bn(bm_, dtype_bytes):
                    continue
                tr = {"m": -(-1920 // bm_), "n": -(-n // bn_),
                      "k": -(-k // bk_)}
                for order in ORDERS:
                    if planner.matmul_smem_bytes(
                            bm_, bn_, bk_, dtype_bytes, rmw=order[2] != "k") \
                            > H100_SXM.smem_bytes_per_block:
                        continue
                    clusters = planner.k3_clusters(
                        bm_, bn_, bk_, tr["m"], tr["n"], dtype_bytes) \
                        if order[2] == "k" else [(1, 1)]
                    for cl in clusters:
                        c = planner.gemm_terms(tr, bm_, bn_, bk_, order, cl,
                                               dtype_bytes)
                        cand = max(c[x] for x in _TERMS)
                        assert cand >= p.duration_overlapped * (1 - 1e-12)


def test_plan_matmul_prices_its_terms_as_computed_by_hand():
    """512^3 bf16 at 128 x 256 x 128, ``mnk``, a 2 x 1 cluster: 4 x 2 x 4
    trips, 8 blocks (one wave, so device memory sees A, B and C once), A
    trips served by L2 as they land, B trips (shared by the 2 ranks of a
    tile column) served once for two; every term for 8 of 132 SMs, the
    operations the product at the tensor cores' rate measured under load
    (726.4 TFLOP/s, ``tools/l2_probe.py --rates`` case (c)) and each
    block's 4 steps at 3423 SM cycles of fixed work (1.778 GHz,
    ``tools/k34_phase_probe.py``) one after another."""
    trips = {"m": 4, "n": 2, "k": 4}
    t = planner.gemm_terms(trips, 128, 256, 128, "mnk", (2, 1), 2)
    a_trips = 4 * 2 * 4 * (128 * 128 * 2)      # every block reads its A row
    b_trips = 4 * 2 * 4 * (128 * 256 * 2)
    c = 512 * 512 * 2
    assert t["hbm_bytes"] == a_trips + b_trips + c
    assert t["l2_bytes"] == a_trips + b_trips // 2 + c
    assert t["dram_bytes"] == 3 * 512 * 512 * 2
    assert t["push_bytes"] == 0
    share = 8 / 132
    assert t["share"] == share
    assert t["tensor"] == pytest.approx(2 * 512 ** 3 / 726.4e12 / share)
    assert t["step"] == pytest.approx(4 * 3423 / 1.778e9)
    assert t["operations"] == t["tensor"] + t["step"]
    assert t["l2"] == pytest.approx(max(t["l2_bytes"] / H100_SXM.l2_bw,
                                        t["hbm_bytes"]
                                        / H100_SXM.smem_fill_bw) / share)
    assert t["dram"] == pytest.approx(3 * 512 * 512 * 2 / 3.35e12 / share)
    # K4 at TinyLlama's 2048 -> 256 on 64 x 32 x 512 "mkn": a cluster of 8,
    # rank 0 pushing each of its 4 A tiles (64 KB) to 7 peers; 30
    # clusters, 16 side by side
    k4 = planner.gemm_terms({"m": 30, "n": 8, "k": 4}, 64, 32, 512, "mkn",
                            (1, 1), 2)
    assert k4["push_bytes"] == 7 * 30 * 4 * 64 * 512 * 2
    assert k4["push"] == pytest.approx(
        k4["push_bytes"] / (H100_SXM.push_bw * 16))
    assert k4["l2_bytes"] == k4["dram_bytes"] == k4["hbm_bytes"]
    p = planner.plan_matmul(512, 512, 512)
    terms = planner.gemm_terms(
        {d: 512 // p.tiles["b" + d] for d in "mnk"}, p.tiles["bm"],
        p.tiles["bn"], p.tiles["bk"], p.order, p.cluster, 2)
    assert p.duration_overlapped == max(terms[x] for x in _TERMS)
    assert p.duration_additive == pytest.approx(
        sum(terms[x] for x in _TERMS))
    assert (p.l2_bytes, p.dram_bytes, p.hbm_bytes) == (
        terms["l2_bytes"], terms["dram_bytes"], terms["hbm_bytes"])


@pytest.mark.parametrize("bm,bn,order", [(128, 64, "nmk"), (64, 128, "mnk"),
                                         (128, 128, "mnk")])
def test_the_fma_core_is_priced_for_its_whole_thread_grid(bm, bn, order):
    """float32's 16 x 16 threads multiply 8 x 8 pieces whatever the tile,
    zeros past it, so a tile costs the product of a 128 x 128 one: 8192^3
    on 128 x 64 x 128 computes twice its FLOPs and ran 1.86x slower than
    on 128 x 128 x 64 (``tools/k34_phase_probe.py --picks``, an H100 80GB
    HBM3 at 700 W), which the planner keeps."""
    trips = {"m": 8192 // bm, "n": 8192 // bn, "k": 64}
    t = planner.gemm_terms(trips, bm, bn, 128, order, (1, 1), 4)
    computed = 2 * trips["m"] * trips["n"] * 128 * 128 * 8192
    assert t["tensor"] == computed / H100_SXM.tensor_flops / t["share"]
    p = planner.plan_matmul(8192, 8192, 8192, dtype_bytes=4)
    assert (p.tiles, p.order) == ({"bm": 128, "bn": 128, "bk": 64}, "mnk")


@pytest.mark.parametrize("m,n,k,tiles,cluster", [
    (8192, 8192, 8192, (128, 256, 128), (2, 1)),
    (8192, 8192, 8192, (128, 128, 64), (2, 2)),
    (1920, 5632, 2048, (128, 256, 128), (1, 2)),
    (4096, 1024, 512, (64, 64, 64), (1, 1)),
    (1920, 256, 2048, (64, 64, 256), (2, 2)),
])
@pytest.mark.parametrize("order", ["mnk", "nmk"])
def test_device_memory_lies_between_the_compulsory_bytes_and_the_trips(
        m, n, k, tiles, cluster, order):
    """K3's device-memory term counts each wave's distinct panels once:
    never below A, B and C once, never above the trips, and equal to a
    count of every wave's blocks by brute force."""
    bm_, bn_, bk_ = tiles
    trips = {"m": m // bm_, "n": n // bn_, "k": k // bk_}
    t = planner.gemm_terms(trips, bm_, bn_, bk_, order, cluster, 2)
    compulsory = (m * k + k * n + m * n) * 2
    assert compulsory <= t["dram_bytes"] <= t["hbm_bytes"]
    blocks = [(lo["m"], lo["n"]) for _, lo, _, _ in bm.cluster_blocks(
        order, trips, (order[0], order[1]), 1, cluster)]
    size = cluster[0] * cluster[1]
    wave = min(len(blocks), 120 if size == 4 else 132)
    brute = 0
    for lo in range(0, len(blocks), wave):
        part = blocks[lo:lo + wave]
        brute += len({mm for mm, _ in part}) * bm_ * k * 2 \
            + len({nn for _, nn in part}) * bn_ * k * 2
    brute = max(m * k * 2 + k * n * 2, min(brute, trips["m"] * trips["n"]
                                           * (bm_ + bn_) * k * 2))
    assert t["dram_bytes"] == brute + m * n * 2


def test_k3_clusters_are_offered_only_where_they_divide_the_grid():
    """1 or 2 ranks a side, each dividing its trips (15 tile rows at m =
    1920, bm 128, take no 2 along m), on the wgmma core only, and each
    sharer's part of a box on 1024 bytes of its slot."""
    assert planner.k3_clusters(128, 256, 128, 15, 8, 2) == [(1, 1), (1, 2)]
    assert planner.k3_clusters(128, 256, 128, 64, 32, 2) == [
        (1, 1), (1, 2), (2, 1), (2, 2)]
    assert planner.k3_clusters(128, 128, 64, 3, 5, 2) == [(1, 1)]
    assert planner.k3_clusters(48, 128, 64, 4, 4, 2) == [(1, 1)]  # mma.sync
    assert planner.k3_clusters(128, 128, 64, 4, 4, 4) == [(1, 1)]  # fma
    # bk 16 over a 32-wide B: 8-row halves of 64 bytes a row, 512 bytes
    assert planner.k3_clusters(64, 32, 16, 4, 4, 2) == [(1, 1), (1, 2)]
    for m, n, k in [(1920, 2048, 2048), (1920, 256, 2048), (8192, 8192, 8192),
                    (640, 576, 128)]:
        p = planner.plan_matmul(m, n, k, 2)
        t = p.tiles
        assert p.cluster in planner.k3_clusters(
            t["bm"], t["bn"], t["bk"], -(-m // t["bm"]), -(-n // t["bn"]), 2)
        assert p.cluster == (1, 1) or p.order[2] == "k"


def test_the_raster_takes_every_cluster_once():
    """``k3_raster`` is a bijection of launch order onto the cluster
    grid, a group of cluster rows at a time, each column by column."""
    for ncx, ncy, gy in [(4, 15, 16), (16, 32, 8), (3, 5, 2), (1, 7, 16)]:
        seen = [planner.k3_raster(lin, ncx, ncy, gy)
                for lin in range(ncx * ncy)]
        assert sorted(seen) == [(x, y) for x in range(ncx)
                                for y in range(ncy)]
        assert seen[:min(gy, ncy)] == [(0, y) for y in range(min(gy, ncy))]


@pytest.mark.parametrize("cluster", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("order", ["mnk", "nmk"])
def test_the_plain_version_split_by_2d_clusters_equals_the_unsplit_one(
        order, cluster):
    """K3 over a cm x cn cluster walks the same tiles, each in one block,
    so the result is the unclustered one bit for bit; the tiles that land
    are the trips, and those L2 serves (a multicast tile once) are the
    planner's ``l2_bytes``."""
    m, n, k, bm_, bn_, bk_ = 256, 512, 192, 64, 128, 64
    a, b = _arrays(57, m, n, k)
    a, b = _torch(a, "bfloat16"), _torch(b, "bfloat16")
    out, loads = bm.block_matmul_plain(a, b, bm=bm_, bn=bn_, bk=bk_,
                                       order=order, cluster=cluster,
                                       return_loads=True)
    assert torch.equal(out, bm.block_matmul_plain(a, b, bm=bm_, bn=bn_,
                                                  bk=bk_, order=order))
    trips = {"m": m // bm_, "n": n // bn_, "k": k // bk_}
    t = planner.gemm_terms(trips, bm_, bn_, bk_, order, cluster, 2)
    tile_a, tile_b, tile_c = bm_ * bk_ * 2, bk_ * bn_ * 2, bm_ * bn_ * 2
    assert (loads["a"] * tile_a + loads["b"] * tile_b
            + loads["c_writes"] * tile_c) == t["hbm_bytes"]
    assert (loads["l2_a"] * tile_a + loads["l2_b"] * tile_b
            + loads["c_writes"] * tile_c) == t["l2_bytes"]
    assert loads["l2_a"] * cluster[1] == loads["a"]
    assert loads["l2_b"] * cluster[0] == loads["b"]


@pytest.mark.parametrize("cluster", [(1, 1), (1, 2), (2, 2)])
def test_k3_at_bn_256_matches_the_jax_kernel(cluster):
    """K3 on 128 x 256 tiles (the wgmma core's widest; the plain version
    walks its blocks and clusters) against the JAX package's
    ``block_matmul`` in interpret mode on the same seeded arrays, in
    bfloat16 (tolerance as the module's: one final rounding apart)."""
    m, n, k = 256, 512, 192
    a, b = _arrays(58, m, n, k)
    out = bm.block_matmul(_torch(a, "bfloat16"), _torch(b, "bfloat16"),
                          bm=128, bn=256, bk=64, order="mnk",
                          cluster=cluster)
    want = jbm.block_matmul(_jax(a, "bfloat16"), _jax(b, "bfloat16"),
                            bm=128, bn=256, bk=64, order="mnk",
                            interpret=True)
    _close(out, want, "bfloat16")


def test_matmul_smem_formula_and_limits_are_the_sources_own():
    """The planner's constants are ``csrc/block_matmul.cu``'s: the wgmma
    core's fixed bytes and ring depth, the tile limits, K3's cluster side
    and raster rows, one block's shared memory; and the formula at bn 256
    (K3 rings of 2 slots at bk 128, K4 a partial stage of 128 KB)."""
    import pathlib
    import re
    csrc = pathlib.Path(bm.__file__).parent / "csrc"
    text = (csrc / "block_matmul.cu").read_text() \
        + (csrc / "repro_common.cuh").read_text()

    def define(name):
        return eval(re.search(rf"#define {name} (.+?)(\s+//|\n)",
                              text).group(1))
    assert define("MM_WG_FIXED_BYTES") == planner.MATMUL_WG_FIXED_BYTES
    assert define("MM_WG_MAX_STAGES") == planner.MATMUL_WG_MAX_STAGES
    assert define("MM_WG_MAX_BN") == planner.MATMUL_MAX_TILE
    assert define("MM_MAX_TILE") == planner.MATMUL_MAX_BM \
        == planner.MATMUL_MAX_BN_SYNC
    assert define("MM_K3_MAX_CLUSTER_SIDE") == planner.K3_MAX_CLUSTER_SIDE
    assert define("MM_K3_RASTER_ROWS") == planner.K3_RASTER_ROWS
    assert define("REPRO_SMEM_LIMIT_BYTES") == \
        H100_SXM.smem_bytes_per_block
    assert planner.matmul_wg_stages(128, 256, 128, False) == 2
    assert planner.matmul_smem_bytes(128, 256, 128, 2) == \
        _WG + 2 * (128 * 128 + 128 * 256) * 2
    assert planner.matmul_smem_bytes(128, 256, 64, 2, rmw=True) == \
        _WG + 2 * (128 * 64 + 64 * 256) * 2 + 128 * 256 * 4


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
# small-m products chip_smoke.py drives, priced by L2 and device memory
# apart: (m, n, k) -> bf16 and f32 (bm, bn, bk, order); K3's cluster in
# PLANNED_CLUSTERS
PLANNED = {
    (1920, 2048, 2048): ((128, 256, 128, "mnk"), (128, 128, 64, "mnk")),
    (1920, 256, 2048): ((64, 64, 256, "mnk"), (64, 64, 128, "mnk")),
    (1920, 5632, 2048): ((128, 256, 128, "mnk"), (128, 128, 64, "mnk")),
    (1920, 2048, 5632): ((128, 256, 128, "mnk"), (128, 128, 64, "mnk")),
    (40, 8192, 2048): ((48, 64, 256, "mnk"), (48, 64, 128, "mnk")),
    (80, 8192, 2048): ((80, 64, 256, "mnk"), (80, 64, 128, "mnk")),
    (4, 2048, 2048): ((16, 16, 1024, "mnk"), (16, 16, 512, "mnk")),
}


PLANNED_CLUSTERS = {(1920, 2048, 2048): (1, 2), (1920, 256, 2048): (2, 2),
                    (1920, 5632, 2048): (1, 2), (1920, 2048, 5632): (1, 2)}


@pytest.mark.parametrize("m,n,k", sorted(PLANNED))
def test_plan_matmul_keeps_its_tiles_and_order(m, n, k):
    """The planner's choices at these shapes stay as pinned, and the
    bfloat16 prefill tiles run on the wgmma core, on the pinned K3
    cluster (float32 on one block a cluster)."""
    for dtype_bytes, want in zip((2, 4), PLANNED[(m, n, k)]):
        p = planner.plan_matmul(m, n, k, dtype_bytes=dtype_bytes)
        t = p.tiles
        assert (t["bm"], t["bn"], t["bk"], p.order) == want
        assert p.cluster == (PLANNED_CLUSTERS.get((m, n, k), (1, 1))
                             if dtype_bytes == 2 else (1, 1))
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
    assert t["bn"] <= planner.matmul_max_bn(t["bm"], dtype_bytes)
    assert all(v % 16 == 0 for v in t.values())
    bm.kernel_limits(t["bm"], t["bn"], t["bk"], dtype_bytes)
    assert p.hbm_bytes >= (m * k + k * n + m * n) * dtype_bytes
    assert p.hbm_bytes >= p.l2_bytes and p.hbm_bytes >= p.dram_bytes
    assert p.dram_bytes >= (m * k + k * n + m * n) * dtype_bytes
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
    with pytest.raises(KernelShapeError, match="bm, bn <= 128"):
        bm.kernel_limits(48, 256, 32, 2)       # bn 256 on wgmma only
    bm.kernel_limits(128, 256, 64, 2)
    with pytest.raises(KernelShapeError, match="cluster"):   # 3 tile rows
        bm.block_matmul(torch.zeros((96, 64)), torch.zeros((64, 64)),
                        bm=32, bn=32, bk=32, cluster=(2, 1))
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
