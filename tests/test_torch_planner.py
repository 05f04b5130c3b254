"""The cases of ``tests/test_planner.py``, read on ``repro_torch`` with the
same inputs and settings. The port's planner plans against the card it
runs on, so each bound is the H100's (``H100_SXM``, one block's shared
memory in place of VMEM). The reference's docstring follows.

Planner property tests (hypothesis): the offloading-schedule chooser
must always respect VMEM, cover the problem, and price durations
consistently with the paper's model.  Deterministic planner tests live in
test_planner_basic.py; this module skips cleanly without hypothesis.
"""
import pytest

pytest.importorskip("hypothesis")

import hypothesis
from hypothesis import given, settings, strategies as st

from repro_torch.core import planner
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import H100_SXM
from _torch_port import fast_polish_port  # noqa: F401


@settings(max_examples=25, deadline=None)
@given(m=st.integers(128, 8192), n=st.integers(128, 8192),
       k=st.integers(128, 8192), dtype_bytes=st.sampled_from([2, 4]))
def test_property_matmul_plan_invariants(m, n, k, dtype_bytes):
    p = planner.plan_matmul(m, n, k, dtype_bytes=dtype_bytes)
    assert p.smem_bytes <= H100_SXM.smem_bytes_per_block
    assert p.flops == 2 * m * n * k
    # compulsory traffic lower bound: A+B read once, C written once
    assert p.hbm_bytes >= dtype_bytes * (m * k + k * n + m * n)
    assert p.duration_overlapped <= p.duration_additive
    assert p.duration_overlapped >= p.flops / H100_SXM.peak_flops - 1e-12
    assert p.steps >= 1


@settings(max_examples=25, deadline=None)
@given(s_log=st.integers(9, 19), d=st.sampled_from([64, 128, 256]),
       g=st.integers(1, 16))
def test_property_decode_plan_invariants(s_log, d, g):
    s = 1 << s_log
    p = planner.plan_decode_attention(s, d, g, dtype_bytes=2)
    assert s % p.tiles["bkv"] == 0
    assert p.smem_bytes <= H100_SXM.smem_bytes_per_block
    # decode is memory-bound: duration == KV bytes / bw
    assert abs(p.duration_overlapped - p.hbm_bytes / H100_SXM.hbm_bw) < 1e-12


@settings(max_examples=20, deadline=None)
@given(hw_in=st.integers(8, 40), c_in=st.integers(1, 8),
       n=st.integers(1, 16), kk=st.sampled_from([1, 3, 5]))
def test_property_conv_plan_invariants(hw_in, c_in, n, kk):
    hypothesis.assume(hw_in > kk)
    spec = ConvSpec(c_in, hw_in, hw_in, n, kk, kk)
    p = planner.plan_conv(spec, dtype_bytes=2)
    assert 1 <= p.tiles["t"] <= spec.w_out
    assert p.smem_bytes <= H100_SXM.smem_bytes_per_block
    # bytes at least: unique input pixels + kernels + output, once each
    lb = 2 * (spec.all_pixels_mask.bit_count() * c_in
              + spec.kernel_elements + spec.num_patches * n)
    assert p.hbm_bytes >= lb
