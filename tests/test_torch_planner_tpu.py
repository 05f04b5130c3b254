"""The port's planners on the reference's chip: given ``TPU_V5E`` the
port's ``plan_matmul``, ``plan_decode_attention`` and ``plan_conv``
price the TPU's Pallas kernels as ``repro.core.planner`` does, field for
field, on the same inputs (drawn with numpy from a seed, in the ranges of
``tests/test_planner.py``); then the reference's four planner cases of
``tests/test_kernels.py`` read on the port.  The footprint the reference
calls ``vmem_bytes`` is the port's ``smem_bytes``.
"""
import numpy as np
import pytest

from repro.core import planner as ref_planner
from repro.core.conv_spec import ConvSpec as RefConvSpec
from repro_torch.core import planner
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import TPU_V5E

RNG = np.random.default_rng(20260311)
MATMUL_CASES = [(int(m), int(n), int(k), int(db)) for m, n, k, db in zip(
    RNG.integers(128, 8193, 20), RNG.integers(128, 8193, 20),
    RNG.integers(128, 8193, 20), RNG.choice([2, 4], 20))] \
    + [(8192, 8192, 8192, 2), (128, 128, 128, 2)]
DECODE_CASES = [(1 << int(s), int(d), int(g)) for s, d, g in zip(
    RNG.integers(9, 20, 12), RNG.choice([64, 128, 256], 12),
    RNG.integers(1, 17, 12))]
CONV_CASES = []
while len(CONV_CASES) < 12:
    hw, c_in, n, kk = (int(RNG.integers(8, 41)), int(RNG.integers(1, 9)),
                       int(RNG.integers(1, 17)), int(RNG.choice([1, 3, 5])))
    if hw > kk:
        CONV_CASES.append((c_in, hw, n, kk))


def assert_same_plan(got, want):
    assert (got.kind, got.tiles, got.order, got.steps) == \
        (want.kind, want.tiles, want.order, want.steps)
    assert (got.hbm_bytes, got.flops) == (want.hbm_bytes, want.flops)
    assert got.smem_bytes == want.vmem_bytes
    assert got.duration_additive == want.duration_additive
    assert got.duration_overlapped == want.duration_overlapped


@pytest.mark.parametrize("m,n,k,dtype_bytes", MATMUL_CASES)
def test_plan_matmul_on_the_tpu_equals_the_reference(m, n, k, dtype_bytes):
    assert_same_plan(
        planner.plan_matmul(m, n, k, dtype_bytes, chip=TPU_V5E),
        ref_planner.plan_matmul(m, n, k, dtype_bytes))


@pytest.mark.parametrize("s,d,g", DECODE_CASES)
def test_plan_decode_attention_on_the_tpu_equals_the_reference(s, d, g):
    assert_same_plan(
        planner.plan_decode_attention(s, d, g, 2, chip=TPU_V5E),
        ref_planner.plan_decode_attention(s, d, g, 2))


@pytest.mark.parametrize("c_in,hw,n,kk", CONV_CASES)
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_plan_conv_on_the_tpu_equals_the_reference(c_in, hw, n, kk,
                                                   dtype_bytes):
    assert_same_plan(
        planner.plan_conv(ConvSpec(c_in, hw, hw, n, kk, kk), dtype_bytes,
                          chip=TPU_V5E),
        ref_planner.plan_conv(RefConvSpec(c_in, hw, hw, n, kk, kk),
                              dtype_bytes))


def test_the_h100_path_is_not_the_tpu_path():
    """The default chip stays the card: no TPU tile (128 and up) where
    the H100's shared memory allows none."""
    p = planner.plan_matmul(8192, 8192, 8192)
    assert p.tiles["bm"] <= planner.MATMUL_MAX_BM
    assert p.smem_bytes <= planner.H100_SXM.smem_bytes_per_block
    assert planner.plan_matmul(8192, 8192, 8192, chip=TPU_V5E).tiles[
        "bm"] > planner.MATMUL_MAX_BM


# ---- the reference's planner cases (tests/test_kernels.py), on TPU_V5E

def test_planner_matmul_fits_vmem_and_prefers_reuse():
    p = planner.plan_matmul(8192, 8192, 8192, dtype_bytes=2, chip=TPU_V5E)
    assert p.smem_bytes <= planner.TPU_V5E.vmem_bytes
    # compute-bound at this size: overlapped duration == flops/peak
    assert abs(p.duration_overlapped - p.flops / planner.TPU_V5E.peak_flops) \
        / p.duration_overlapped < 1e-6
    # bytes moved must be >= the compulsory traffic (A+B+C once)
    compulsory = 2 * (8192 * 8192 * 3)
    assert p.hbm_bytes >= compulsory


def test_planner_decode_attention_is_memory_bound():
    p = planner.plan_decode_attention(32768, 128, 8, dtype_bytes=2,
                                      chip=TPU_V5E)
    t_mem = p.hbm_bytes / planner.TPU_V5E.hbm_bw
    assert p.duration_overlapped == t_mem      # decode: always memory-bound
    assert 32768 % p.tiles["bkv"] == 0


def test_planner_conv_prefers_wider_runs():
    spec = ConvSpec(3, 64, 64, 8, 3, 3)
    p = planner.plan_conv(spec, dtype_bytes=4, chip=TPU_V5E)
    assert p.tiles["t"] > 1                    # grouping beats S1-baseline
    assert p.smem_bytes <= planner.TPU_V5E.vmem_bytes


def test_planner_duration_models_ordering():
    p = planner.plan_matmul(1024, 1024, 1024, dtype_bytes=2, chip=TPU_V5E)
    assert p.duration_overlapped <= p.duration_additive
