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
            np.prod([trips[d] for d in grid_dims])


def test_the_planner_keeps_the_grid_wide():
    """A grid of fewer blocks than the card's SMs gets that share of the
    card: at TinyLlama's prefill projections the planner keeps k
    innermost (K3), whose grid is m x n tiles."""
    for k, n in [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]:
        for dtype_bytes in (2, 4):
            p = planner.plan_matmul(1920, n, k, dtype_bytes=dtype_bytes)
            assert p.order[2] == "k"


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("m,n,k", [(1920, 2048, 2048), (1920, 256, 2048),
                                   (1920, 5632, 2048), (1920, 2048, 5632),
                                   (8192, 8192, 8192), (40, 72, 56)])
def test_plan_matmul_fits_one_blocks_shared_memory(m, n, k, dtype_bytes):
    p = planner.plan_matmul(m, n, k, dtype_bytes=dtype_bytes)
    t = p.tiles
    assert p.smem_bytes == planner.matmul_smem_bytes(t["bm"], t["bn"],
                                                     t["bk"], dtype_bytes)
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
