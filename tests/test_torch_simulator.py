"""The cases of ``tests/test_simulator.py``, read on ``repro_torch`` with
the same inputs and settings. The reference's docstring follows.

Simulator property test (hypothesis): every strategy/shape computes the
exact convolution.  Deterministic simulator tests live in
test_simulator_basic.py; this module skips cleanly without hypothesis.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.strategies import hilbert, row_by_row, tiled, zigzag
from repro_torch.sim import ConvLayer, System
from repro_torch.sim.functional import reference_conv
from _torch_port import fast_polish_port  # noqa: F401

HW = HardwareModel(nbop_pe=10**9, size_mem=10**9)


@settings(max_examples=15, deadline=None)
@given(
    c_in=st.integers(1, 3), hw_in=st.integers(4, 8),
    n=st.integers(1, 3), k=st.integers(2, 3),
    stride=st.integers(1, 2), p=st.integers(1, 5),
    builder=st.sampled_from([row_by_row, zigzag, tiled, hilbert]),
    seed=st.integers(0, 5))
def test_property_functional_correct_any_strategy(c_in, hw_in, n, k, stride,
                                                  p, builder, seed):
    """The decomposed execution computes the exact convolution for every
    strategy/shape — the paper's 'functional simulation' check."""
    spec = ConvSpec(c_in, hw_in, hw_in, n, k, k, stride, stride)
    layer = ConvLayer.random(spec, seed=seed)
    rep = System(layer, HW).run(builder(spec, p))
    assert rep.correct, rep.summary()
    np.testing.assert_allclose(rep.output, reference_conv(layer),
                               rtol=1e-4, atol=1e-4)
