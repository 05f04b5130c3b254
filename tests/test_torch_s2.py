"""The cases of ``tests/test_s2.py``, read on ``repro_torch`` with the same
inputs and settings. The reference's docstring follows.

S2 functional property test (hypothesis): kernel subsets swapping
through on-chip memory compute the exact convolution for any shape.
Deterministic S2 tests live in test_s2_basic.py; this module skips cleanly
without hypothesis.
"""
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st

from repro_torch.core import strategies_s2 as s2
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.sim import ConvLayer
from repro_torch.sim.s2 import run_s2
from _torch_port import fast_polish_port  # noqa: F401

BIG = HardwareModel(nbop_pe=10 ** 9, size_mem=None)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(4, 7), nk=st.sampled_from([2, 4, 6]),
       p=st.integers(1, 4), kg=st.sampled_from([1, 2]),
       seed=st.integers(0, 3),
       builder=st.sampled_from([s2.kernel_major, s2.patch_major]))
def test_property_s2_functional_correct(n, nk, p, kg, seed, builder):
    spec = ConvSpec(1, n, n, nk, 3, 3)
    strat = builder(spec, p, kg)
    layer = ConvLayer.random(spec, seed=seed)
    rep = run_s2(layer, BIG, strat)
    assert rep.correct, rep.max_abs_err
