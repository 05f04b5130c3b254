"""The port's simulator, property test (hypothesis), as
``tests/test_simulator.py`` is for the JAX package's: every strategy and
shape computes the exact convolution, and the port's report equals the
reference's on the same seeded layer.  Skips cleanly without
hypothesis."""
import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

from _torch_port import fast_polish_port  # noqa: E402,F401
from repro.core import strategies as j_strategies  # noqa: E402
from repro.core.conv_spec import ConvSpec as JConvSpec  # noqa: E402
from repro.core.cost_model import HardwareModel as JHardwareModel  # noqa: E402
from repro.sim import ConvLayer as JConvLayer  # noqa: E402
from repro.sim import System as JSystem  # noqa: E402
from repro_torch.core import strategies  # noqa: E402
from repro_torch.core.conv_spec import ConvSpec  # noqa: E402
from repro_torch.core.cost_model import HardwareModel  # noqa: E402
from repro_torch.sim import ConvLayer, System  # noqa: E402
from repro_torch.sim.functional import (reference_conv,  # noqa: E402
                                        reference_conv_torch)

HW = HardwareModel(nbop_pe=10**9, size_mem=10**9)
JHW = JHardwareModel(nbop_pe=10**9, size_mem=10**9)
BUILDERS = ["row_by_row", "zigzag", "tiled", "hilbert"]


@settings(max_examples=15, deadline=None)
@given(
    c_in=st.integers(1, 3), hw_in=st.integers(4, 8),
    n=st.integers(1, 3), k=st.integers(2, 3),
    stride=st.integers(1, 2), p=st.integers(1, 5),
    builder=st.sampled_from(BUILDERS), seed=st.integers(0, 5))
def test_property_functional_correct_any_strategy(c_in, hw_in, n, k, stride,
                                                  p, builder, seed):
    """The decomposed execution computes the exact convolution for every
    strategy/shape, and reports what the reference's simulator reports."""
    spec = ConvSpec(c_in, hw_in, hw_in, n, k, k, stride, stride)
    layer = ConvLayer.random(spec, seed=seed)
    rep = System(layer, HW).run(getattr(strategies, builder)(spec, p))
    assert rep.correct, rep.summary()
    np.testing.assert_allclose(rep.output, reference_conv(layer),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rep.output, reference_conv_torch(layer),
                               rtol=1e-4, atol=1e-4)
    jspec = JConvSpec(c_in, hw_in, hw_in, n, k, k, stride, stride)
    jrep = JSystem(JConvLayer.random(jspec, seed=seed), JHW).run(
        getattr(j_strategies, builder)(jspec, p))
    np.testing.assert_array_equal(rep.output, jrep.output)
    assert (rep.total_duration, rep.peak_footprint, rep.elements_read,
            rep.elements_written) == (jrep.total_duration,
                                      jrep.peak_footprint, jrep.elements_read,
                                      jrep.elements_written)
