"""The port's topology-general multi-chip planning: the cases of
``tests/test_topology.py``, read on ``repro_torch`` with the same inputs
and settings. The reference's docstring follows.

Topology-general multi-chip planning: Topology
parsing/validation and collective pricing, the unidirectional-ring
bit-exact regression, biring/torus dominance, the 1xN-torus and
hybrid rx1 / 1xc degeneracies, and per-topology mutation tests of the
2-D shard stitcher.  Hypothesis twins live in test_topology_props.py.
"""
import dataclasses

import pytest

from repro_torch.configs import tight
from repro_torch.configs.clusters import make_cluster, torus_dims
from repro_torch.core import solver
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import ClusterModel, HardwareModel, Topology
from repro_torch.core.multichip import (HYBRID_MODES, MODES, hybrid_shard_specs,
                                  ici_schedule, kernel_shard_specs,
                                  mode_alphabet, plan_multichip_network,
                                  row_shard_specs)
from repro_torch.core.network_planner import InfeasibleNetworkError, plan_network
from repro_torch.sim import simulate_multichip
from _torch_port import fast_polish_port  # noqa: F401

FAST = dict(polish_iters=600, polish_restarts=1)

TIGHT_BUDGET = max(s.kernel_elements for s in tight.LAYERS) // 2

# The unidirectional-ring totals for tight.LAYERS at TIGHT_BUDGET
# (rng_seed=0, FAST budgets, conftest polish caps): the bit-exact
# regression gate for the topology generalisation.
PR4_RING = {
    # (n_chips, overlap): (total, modes, final_gather, per-layer ici)
    (2, False): (20669.0, "WWKK", 512, [0, 160, 512, 576]),
    (2, True): (15677.0, "WWKK", 512, [0, 160, 512, 576]),
    (4, False): (17529.0, "WWKK", 768, [0, 160, 768, 864]),
    # overlap totals assume WAR-sound halo pricing: a row->row exchange
    # whose receiving bands read the halo before it can arrive is
    # serialised (4 and 8 chips: the L1 bands are too short to hide it)
    (4, True): (12818.0, "WWKK", 768, [0, 160, 768, 864]),
    (8, False): (16209.0, "WWKK", 896, [0, 160, 896, 1008]),
    (8, True): (13173.0, "WWKK", 896, [0, 160, 896, 1008]),
}


def _plan(topology, n_chips=4, overlap=False, specs=tight.LAYERS,
          **kw):
    cluster = make_cluster(n_chips, size_mem=TIGHT_BUDGET,
                           topology=topology)
    return plan_multichip_network(
        specs, cluster, include_single_chip_baseline=False,
        overlap=overlap, balance_rows=overlap, **FAST, **kw)


# --------------------------------------------------------------------- #
# Topology construction and validation
# --------------------------------------------------------------------- #

def test_topology_parse_strings():
    assert Topology.parse("ring") == Topology("ring")
    assert Topology.parse("biring") == Topology("ring", bidirectional=True)
    assert Topology.parse("torus2x4") == Topology(
        "torus", (2, 4), bidirectional=True)
    t = Topology("torus", (4, 2))
    assert Topology.parse(t) is t
    for bad in ("torus2d", "mesh", "torus2x", "ring2"):
        with pytest.raises(ValueError):
            Topology.parse(bad)


def test_topology_validation():
    with pytest.raises(ValueError):
        Topology("torus")                  # needs dims
    with pytest.raises(ValueError):
        Topology("torus", (0, 4))
    with pytest.raises(ValueError):
        Topology("ring", (2, 2))           # ring takes no dims
    with pytest.raises(ValueError):
        Topology("mesh")


def test_cluster_model_topology_validation():
    chip = HardwareModel(nbop_pe=10 ** 9)
    with pytest.raises(ValueError):        # the 1-D topologies' rule, kept
        ClusterModel(chip=chip, n_chips=2, topology="torus2d")
    with pytest.raises(ValueError):        # dims must tile n_chips
        ClusterModel(chip=chip, n_chips=6, topology="torus2x2")
    c = ClusterModel(chip=chip, n_chips=4, t_ici=1.0, topology="torus2x2")
    assert c.topo.grid(4) == (2, 2)
    assert "torus" in c.topo.describe()


def test_torus_dims_squarest():
    assert torus_dims(4) == (2, 2)
    assert torus_dims(8) == (2, 4)
    assert torus_dims(16) == (4, 4)
    assert torus_dims(12) == (3, 4)
    assert torus_dims(2) is None           # only the degenerate 1xN
    assert torus_dims(7) is None           # prime


def test_mode_alphabet_per_topology():
    assert mode_alphabet(make_cluster(4)) == MODES
    assert mode_alphabet(make_cluster(4, topology="biring")) == MODES
    assert mode_alphabet(
        make_cluster(4, topology="torus2x2")) == HYBRID_MODES


# --------------------------------------------------------------------- #
# Collective pricing: hand-computed bottleneck-link counts
# --------------------------------------------------------------------- #

def test_ring_collectives_match_pr3_formulas():
    ring = Topology("ring")
    assert ring.gather(4, 1000) == 750          # ceil(A*(n-1)/n)
    assert ring.scatter(4, 1000) == 750
    assert ring.allgather(4, 1000) == 750
    assert ring.reduce_scatter(4, 1000) == 750
    assert ring.all_to_all(4, 1000) == 750
    assert ring.bcast(4, 1000) == 1000          # pipelined broadcast
    assert ring.gather(1, 1000) == 0
    assert ring.bcast(1, 1000) == 0


def test_reduce_scatter_experimental_pricing_pinned():
    """``Topology.reduce_scatter`` is explicitly experimental — no planner
    mode emits it yet (input-channel sharding is ROADMAP work) — but its
    pricing is pinned here so the formula cannot drift before it is wired
    in: the standard ring algorithm's bottleneck equals the gather's on
    every topology shape."""
    for topo in (Topology("ring"), Topology("ring", bidirectional=True),
                 Topology("torus", (2, 2)), Topology("torus", (2, 4))):
        for n in (2, 4, 8):
            for a in (1, 37, 1000):
                assert topo.reduce_scatter(n, a) == topo.gather(n, a)


def test_biring_halves_collectives():
    bi = Topology("ring", bidirectional=True)
    assert bi.gather(4, 1000) == 375            # ceil(750 / 2)
    assert bi.allgather(4, 1000) == 375
    assert bi.bcast(4, 1000) == 500
    assert bi.gather(4, 999) == 375             # ceil(ceil(999*3/4)/2)


def test_torus_collectives_decompose_per_axis():
    t = Topology("torus", (2, 2))               # unidirectional links
    # gather: axis-1 rings funnel each 500-element band row, then the
    # axis-0 ring funnels the full tensor.
    assert t.gather(4, 1000) == 250 + 500
    assert t.bcast(4, 1000) == 2000             # one broadcast per axis
    assert t.allgather_axis1(4, 1000) == 250
    assert t.scatter_axis0(4, 1000) == 500
    assert t.bcast_axis1(4, 1000) == 500
    tb = Topology("torus", (2, 2), bidirectional=True)
    assert tb.gather(4, 1000) == 125 + 250
    assert tb.bcast(4, 1000) == 1000


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("dims", [(1, 4), (4, 1), (1, 8), (8, 1)])
def test_degenerate_torus_prices_like_ring(dims, bidir):
    """A 1xN (or Nx1) torus IS the N-ring: every collective must price
    identically for any tensor size."""
    n = dims[0] * dims[1]
    torus = Topology("torus", dims, bidirectional=bidir)
    ring = Topology("ring", bidirectional=bidir)
    for a in (1, 7, 64, 999, 12345):
        assert torus.gather(n, a) == ring.gather(n, a)
        assert torus.scatter(n, a) == ring.scatter(n, a)
        assert torus.allgather(n, a) == ring.allgather(n, a)
        assert torus.reduce_scatter(n, a) == ring.reduce_scatter(n, a)
        assert torus.bcast(n, a) == ring.bcast(n, a)


# --------------------------------------------------------------------- #
# The bit-exact unidirectional-ring regression
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("n_chips,overlap", sorted(PR4_RING))
def test_ring_reproduces_pr4_bit_exactly(n_chips, overlap):
    total, modes, final, ici = PR4_RING[(n_chips, overlap)]
    plan = _plan("ring", n_chips=n_chips, overlap=overlap)
    assert plan.total_duration == total
    assert plan.mode_string == modes
    assert plan.final_gather_elements == final
    assert [lp.ici_elements for lp in plan.layers] == ici


def test_one_chip_delegation_any_topology():
    """n_chips=1 reproduces plan_network exactly whatever the wiring."""
    specs = tight.LAYERS_SMALL
    net = plan_network(list(specs), make_cluster(1).chip, rng_seed=3,
                       **FAST)
    for topology in ("ring", "biring", Topology("torus", (1, 1))):
        mc = plan_multichip_network(
            list(specs), make_cluster(1, topology=topology), rng_seed=3,
            **FAST)
        assert mc.total_duration == net.total_duration


# --------------------------------------------------------------------- #
# Dominance: bidirectional never slower, torus beats the ring
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("overlap", [False, True])
def test_biring_never_slower_than_ring(overlap):
    ring = _plan("ring", overlap=overlap)
    bi = _plan("biring", overlap=overlap)
    assert bi.total_duration <= ring.total_duration
    # fixed mode sequence: the biring re-pricing of the RING's own plan
    # is also never more expensive, layer by layer
    specs = [lp.spec for lp in ring.layers]
    modes = [lp.mode for lp in ring.layers]
    active = [lp.active_chips for lp in ring.layers]
    uni, uni_final = ici_schedule(
        specs, modes, active, make_cluster(4, size_mem=TIGHT_BUDGET))
    bid, bid_final = ici_schedule(
        specs, modes, active,
        make_cluster(4, size_mem=TIGHT_BUDGET, topology="biring"))
    assert all(b <= u for b, u in zip(bid, uni))
    assert bid_final <= uni_final


def test_torus2x2_beats_four_chip_ring_on_tight4():
    """The acceptance point: a 2x2 torus (bidirectional links,
    hybrid sharding available) strictly beats the 4-chip ring on the
    tight4 config, under both accounting disciplines."""
    for overlap in (False, True):
        ring = _plan("ring", overlap=overlap)
        torus = _plan("torus2x2", overlap=overlap)
        assert torus.total_duration < ring.total_duration
        rep = simulate_multichip(torus)
        assert rep.correct and rep.accounting_exact \
            and rep.peak_within_budget


def test_torus_overlap_plan_uses_hybrid_and_reconciles():
    plan = _plan("torus2x2", overlap=True)
    assert "H" in plan.mode_string
    hybrid = [lp for lp in plan.layers if lp.mode == "hybrid"]
    assert hybrid and hybrid[0].grid == (2, 2)
    assert len(hybrid[0].shards) == 4
    rep = simulate_multichip(plan)
    assert rep.correct and rep.accounting_exact and rep.peak_within_budget


# --------------------------------------------------------------------- #
# Hybrid degeneracies: rx1 == pure row, 1xc == pure channel
# --------------------------------------------------------------------- #

def _assert_same_plan(a, b):
    assert a.total_duration == b.total_duration
    assert a.final_gather_elements == b.final_gather_elements
    for la, lb in zip(a.layers, b.layers):
        assert la.compute_duration == lb.compute_duration
        assert la.ici_elements == lb.ici_elements
        assert len(la.shards) == len(lb.shards)
        for sa, sb in zip(la.shards, lb.shards):
            assert sa.spec == sb.spec and sa.chip == sb.chip


@pytest.mark.parametrize("dims,pure", [((4, 1), "row"),
                                       ((1, 4), "channel")])
def test_hybrid_trivial_axis_reproduces_pure_mode(dims, pure):
    topo = Topology("torus", dims, bidirectional=True)
    hybrid = _plan(topo, modes=("replicate", "hybrid"))
    plain = _plan(topo, modes=("replicate", pure))
    _assert_same_plan(hybrid, plain)
    rep = simulate_multichip(hybrid)
    assert rep.correct and rep.accounting_exact and rep.peak_within_budget


def test_hybrid_shard_specs_grid_geometry():
    spec = ConvSpec(3, 12, 12, 10, 3, 3)       # h_out = 10
    shards = hybrid_shard_specs(spec, 2, 3)
    assert len(shards) == 6
    assert sorted(c for c, _, _, _ in shards) == list(range(6))
    # bands x kernel groups tile the full output
    rows = {band for _, band, _, _ in shards}
    kers = {kr for _, _, kr, _ in shards}
    assert rows == {(0, 5), (5, 10)}
    assert kers == {(0, 4), (4, 7), (7, 10)}
    for _, (r0, r1), (k0, k1), s in shards:
        assert s.h_out == r1 - r0 and s.n_kernels == k1 - k0
        assert s.h_in == (s.h_out - 1) * spec.s_h + spec.h_k
    # the rx1 / 1xc degeneracies reuse the pure-mode geometry
    assert [(b, s.h_out) for _, b, _, s in hybrid_shard_specs(spec, 4, 1)] \
        == [(b, s.h_out) for _, b, s in row_shard_specs(spec, 4)]
    assert [(k, s.n_kernels) for _, _, k, s in
            hybrid_shard_specs(spec, 1, 4)] \
        == [(k, s.n_kernels) for _, k, s in kernel_shard_specs(spec, 4)]
    with pytest.raises(ValueError, match="hybrid grid"):
        hybrid_shard_specs(spec, 11, 2)        # more bands than rows
    with pytest.raises(ValueError, match="hybrid grid"):
        hybrid_shard_specs(spec, 2, 11)        # more groups than kernels


# --------------------------------------------------------------------- #
# Infeasible grids and errors name the layer and the topology
# --------------------------------------------------------------------- #

def test_infeasible_hybrid_grid_error_names_layer_and_topology():
    """A chip grid with more row bands than output rows is infeasible
    for hybrid sharding; when no other mode is allowed the error must
    say which layer broke and on what wiring (as the single-chip
    InfeasibleNetworkError message does)."""
    specs = (ConvSpec(1, 6, 6, 8, 3, 3),)      # h_out = 4 < 8 grid rows
    cluster = make_cluster(8, topology="torus8x1")
    with pytest.raises(InfeasibleNetworkError,
                       match=r"layer 0 .*8 chips .*8x1 torus.*"
                             r"rows<=h_out=4"):
        plan_multichip_network(specs, cluster, modes=("hybrid",), **FAST)


def test_infeasible_budget_error_names_topology():
    cluster = make_cluster(4, size_mem=8, topology="torus2x2")
    with pytest.raises(InfeasibleNetworkError,
                       match=r"layer 0 .*size_mem=8.*4 chips .*"
                             r"2x2 torus, bidirectional"):
        plan_multichip_network(tight.LAYERS_SMALL, cluster, **FAST)


def test_hybrid_requires_a_torus():
    with pytest.raises(InfeasibleNetworkError,
                       match=r"unidirectional ring"):
        plan_multichip_network(tight.LAYERS_SMALL, make_cluster(4),
                               modes=("hybrid",), **FAST)


# --------------------------------------------------------------------- #
# Mutation tests: the 2-D stitcher catches corrupted shards on every
# topology preset (guards the guard, as for the 1-D ring)
# --------------------------------------------------------------------- #

def _mutate(plan, li, **replacements):
    lp = plan.layers[li]
    bad_shard = dataclasses.replace(lp.shards[0], **replacements)
    bad_layer = dataclasses.replace(
        lp, shards=(bad_shard,) + lp.shards[1:])
    return dataclasses.replace(
        plan, layers=plan.layers[:li] + (bad_layer,)
        + plan.layers[li + 1:])


@pytest.mark.parametrize("topology", ["ring", "biring", "torus2x2"])
def test_stitcher_catches_corrupt_shards_per_topology(topology):
    """Shift one shard's halo rows / kernel-channel slice: the
    reference-conv comparison must fail for every topology preset and
    every sharded mode the plan uses."""
    plan = _plan(topology, overlap=(topology == "torus2x2"))
    assert simulate_multichip(plan).correct
    checked = set()
    for li, lp in enumerate(plan.layers):
        if lp.mode in ("row", "hybrid") and "rows" not in checked:
            r0, r1 = lp.shards[0].out_rows
            bad = _mutate(plan, li, out_rows=(r0 + 1, r1 + 1))
            assert not simulate_multichip(bad).correct
            checked.add("rows")
        if lp.mode in ("channel", "hybrid") and "kernels" not in checked:
            k0, k1 = lp.shards[0].kernel_range
            bad = _mutate(plan, li, kernel_range=(k0 + 1, k1 + 1))
            assert not simulate_multichip(bad).correct
            checked.add("kernels")
    assert checked == {"rows", "kernels"}, \
        f"{topology} plan {plan.mode_string} exercised {checked} only"


def test_stitcher_catches_corrupt_hybrid_cell_both_axes():
    """An all-hybrid plan: corrupting either axis of one grid cell must
    break the stitched comparison."""
    plan = _plan("torus2x2", modes=("hybrid",))
    assert plan.mode_string == "HHHH"
    assert simulate_multichip(plan).correct
    r0, r1 = plan.layers[1].shards[0].out_rows
    assert not simulate_multichip(
        _mutate(plan, 1, out_rows=(r0 + 1, r1 + 1))).correct
    k0, k1 = plan.layers[1].shards[0].kernel_range
    assert not simulate_multichip(
        _mutate(plan, 1, kernel_range=(k0 + 1, k1 + 1))).correct


# --------------------------------------------------------------------- #
# Determinism across the topology matrix
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("topology", ["biring", "torus2x2"])
def test_deterministic_under_fixed_seed(topology):
    solver.solve_cached.cache_clear()
    a = _plan(topology, rng_seed=11)
    solver.solve_cached.cache_clear()
    b = _plan(topology, rng_seed=11)
    assert a.total_duration == b.total_duration
    assert a.mode_string == b.mode_string
