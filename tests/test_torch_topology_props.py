"""Hypothesis properties of the port's topology pricing and
``ici_schedule``: the cases of ``tests/test_topology_props.py``, read on
``repro_torch`` with the same inputs and settings. The reference's
docstring follows.

Hypothesis property tests of the topology collective pricing and the
mode-sequence re-pricer (``ici_schedule``).  Deterministic twins live in
test_topology.py so the invariants stay covered without the hypothesis
extra; this module skips cleanly when it is missing.

Pure pricing only — no solver calls — so the search budgets are cheap.
"""
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import Topology
from repro_torch.core.multichip import MODES, ici_schedule
from repro_torch.configs.clusters import make_cluster
from _torch_port import fast_polish_port  # noqa: F401

COLLECTIVES = ("gather", "scatter", "allgather", "reduce_scatter",
               "all_to_all", "bcast")


def tori():
    return st.builds(
        Topology,
        kind=st.just("torus"),
        dims=st.tuples(st.integers(1, 6), st.integers(1, 6)),
        bidirectional=st.booleans())


@given(n=st.integers(1, 32), a=st.integers(1, 10 ** 6),
       bidir=st.booleans())
def test_bidirectional_ring_never_prices_higher(n, a, bidir):
    """Bidirectional links can only help: every collective's bottleneck
    load is <= the unidirectional ring's (and non-negative)."""
    uni = Topology("ring")
    bi = Topology("ring", bidirectional=True)
    for name in COLLECTIVES:
        u, b = getattr(uni, name)(n, a), getattr(bi, name)(n, a)
        assert 0 <= b <= u


@given(topo=tori(), a=st.integers(1, 10 ** 6))
def test_torus_bidirectional_never_prices_higher(topo, a):
    n = topo.dims[0] * topo.dims[1]
    uni = Topology("torus", topo.dims)
    bi = Topology("torus", topo.dims, bidirectional=True)
    for name in COLLECTIVES:
        assert 0 <= getattr(bi, name)(n, a) <= getattr(uni, name)(n, a)


@given(k=st.integers(1, 32), a=st.integers(1, 10 ** 6),
       bidir=st.booleans(), transpose=st.booleans())
def test_degenerate_torus_equals_ring(k, a, bidir, transpose):
    """A 1xN (or Nx1) torus degenerates to the N-ring exactly, for every
    collective and any tensor size."""
    dims = (k, 1) if transpose else (1, k)
    torus = Topology("torus", dims, bidirectional=bidir)
    ring = Topology("ring", bidirectional=bidir)
    for name in COLLECTIVES:
        assert getattr(torus, name)(k, a) == getattr(ring, name)(k, a)


@given(topo=tori(), a=st.integers(1, 10 ** 6))
def test_collectives_monotone_in_tensor_size(topo, a):
    n = topo.dims[0] * topo.dims[1]
    for name in COLLECTIVES:
        f = getattr(topo, name)
        assert f(n, a) <= f(n, a + 1) <= f(n, 2 * a + 2)


def specs():
    return st.builds(
        ConvSpec,
        c_in=st.integers(1, 4),
        h_in=st.integers(5, 12),
        w_in=st.integers(5, 12),
        n_kernels=st.integers(1, 8),
        h_k=st.integers(1, 3),
        w_k=st.integers(1, 3),
        s_h=st.integers(1, 2),
        s_w=st.integers(1, 2))


@settings(max_examples=60, deadline=None)
@given(chain=st.lists(st.tuples(specs(), st.sampled_from(MODES)),
                      min_size=1, max_size=5),
       n_chips=st.sampled_from([2, 4, 8]))
def test_biring_repricing_never_exceeds_ring(chain, n_chips):
    """For ANY mode sequence over any layer chain, the bidirectional
    ring's ICI charges are layerwise <= the unidirectional ring's."""
    layer_specs = [s for s, _ in chain]
    modes = [m for _, m in chain]
    active = [1 if m == "replicate"
              else min(n_chips, s.h_out if m == "row" else s.n_kernels)
              for s, m in chain]
    uni, uni_final = ici_schedule(
        layer_specs, modes, active, make_cluster(n_chips))
    bid, bid_final = ici_schedule(
        layer_specs, modes, active,
        make_cluster(n_chips, topology="biring"))
    assert all(b <= u for b, u in zip(bid, uni))
    assert bid_final <= uni_final
    assert all(b >= 0 for b in bid) and bid_final >= 0


@settings(max_examples=40, deadline=None)
@given(chain=st.lists(st.tuples(specs(), st.sampled_from(MODES)),
                      min_size=1, max_size=4),
       k=st.sampled_from([2, 4, 8]), bidir=st.booleans())
def test_degenerate_torus_schedule_equals_ring_schedule(chain, k, bidir):
    """ici_schedule on a 1xN torus reproduces the N-ring charges exactly
    for any pure-mode sequence."""
    layer_specs = [s for s, _ in chain]
    modes = [m for _, m in chain]
    active = [1 if m == "replicate"
              else min(k, s.h_out if m == "row" else s.n_kernels)
              for s, m in chain]
    ring_topo = Topology("ring", bidirectional=bidir)
    torus_topo = Topology("torus", (1, k), bidirectional=bidir)
    ring = ici_schedule(layer_specs, modes, active,
                        make_cluster(k, topology=ring_topo))
    torus = ici_schedule(layer_specs, modes, active,
                         make_cluster(k, topology=torus_topo))
    assert ring == torus
