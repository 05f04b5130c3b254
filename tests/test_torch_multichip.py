"""The cases of ``tests/test_multichip.py``, read on ``repro_torch`` with
the same inputs and settings. The reference's docstring follows.

Multi-chip sharded planner: shard geometry, ICI pricing,
the 1-chip == plan_network regression, the 4-chip-beats-1-chip tight
config with full simulator reconciliation, and cluster-model validation.
"""
import pytest

from repro_torch.configs import tight
from repro_torch.configs.clusters import make_cluster
from repro_torch.core import solver
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import TPU_V5E, ClusterModel, HardwareModel
from repro_torch.core.multichip import (MODES, halo_elements, ici_schedule,
                                        kernel_shard_specs,
                                        plan_multichip_network,
                                        row_shard_specs)
from repro_torch.core.network_planner import (InfeasibleNetworkError,
                                              plan_network)
from repro_torch.sim import simulate_multichip
from _torch_port import fast_polish_port  # noqa: F401

SMALL_NET = (ConvSpec(1, 10, 10, 2, 3, 3),
             ConvSpec(2, 8, 8, 4, 3, 3),
             ConvSpec(2, 8, 8, 4, 3, 3))

FAST = dict(polish_iters=600, polish_restarts=1)

TIGHT_BUDGET = max(s.kernel_elements for s in tight.LAYERS) // 2


# --------------------------------------------------------------------- #
# ClusterModel
# --------------------------------------------------------------------- #

def test_cluster_model_validation():
    chip = HardwareModel(nbop_pe=10 ** 9)
    with pytest.raises(ValueError):
        ClusterModel(chip=chip, n_chips=0)
    with pytest.raises(ValueError):
        ClusterModel(chip=chip, n_chips=2, t_ici=-1.0)
    with pytest.raises(ValueError):
        ClusterModel(chip=chip, n_chips=2, topology="torus2d")
    assert ClusterModel(chip=chip, n_chips=4, t_ici=2.0).n_chips == 4


def test_tpu_as_cluster_units():
    """t_ici prices one element over one ICI link in the same seconds
    unit as t_l; the ratio is the HBM/ICI bandwidth ratio (~16 on v5e)."""
    cluster = TPU_V5E.as_cluster(4)
    assert cluster.n_chips == 4
    assert cluster.t_ici == pytest.approx(2 / TPU_V5E.ici_bw_per_link)
    assert cluster.t_ici / cluster.chip.t_l == pytest.approx(
        TPU_V5E.hbm_bw / TPU_V5E.ici_bw_per_link)


# --------------------------------------------------------------------- #
# Shard geometry
# --------------------------------------------------------------------- #

def test_row_shard_specs_cover_output_rows():
    spec = ConvSpec(3, 12, 12, 4, 3, 3)          # h_out = 10
    shards = row_shard_specs(spec, 4)
    assert [s.h_out for _, _, s in shards] == [3, 3, 2, 2]
    assert sum(s.h_out for _, _, s in shards) == spec.h_out
    r_prev = 0
    for chip, (r0, r1), sspec in shards:
        assert r0 == r_prev and r1 > r0
        r_prev = r1
        # halo-extended input window of the band
        assert sspec.h_in == (sspec.h_out - 1) * spec.s_h + spec.h_k
        assert sspec.w_in == spec.w_in and sspec.c_in == spec.c_in
        assert sspec.n_kernels == spec.n_kernels
    assert r_prev == spec.h_out


def test_row_shard_specs_strided_and_idle_chips():
    spec = ConvSpec(2, 11, 11, 3, 3, 3, s_h=2, s_w=2)   # h_out = 5
    shards = row_shard_specs(spec, 8)            # more chips than rows
    assert len(shards) == 5                      # 3 chips idle
    assert all(s.h_out == 1 for _, _, s in shards)
    assert all(s.h_in == spec.h_k for _, _, s in shards)


def test_kernel_shard_specs_cover_kernels():
    spec = ConvSpec(3, 8, 8, 10, 3, 3)
    shards = kernel_shard_specs(spec, 4)
    assert [s.n_kernels for _, _, s in shards] == [3, 3, 2, 2]
    k_prev = 0
    for chip, (k0, k1), sspec in shards:
        assert k0 == k_prev and k1 - k0 == sspec.n_kernels
        k_prev = k1
        assert (sspec.h_in, sspec.w_in) == (spec.h_in, spec.w_in)
    assert k_prev == spec.n_kernels
    # more chips than kernels: idle chips
    assert len(kernel_shard_specs(spec, 16)) == 10


def test_halo_elements_stride_cases():
    assert halo_elements(ConvSpec(4, 10, 10, 2, 3, 3)) == 2 * 10 * 4
    assert halo_elements(ConvSpec(4, 11, 11, 2, 3, 3, s_h=2, s_w=2)) \
        == 1 * 11 * 4
    # stride covers the kernel: bands do not overlap, no halo
    assert halo_elements(ConvSpec(4, 12, 12, 2, 3, 3, s_h=3, s_w=3)) == 0


# --------------------------------------------------------------------- #
# 1-chip regression: exact plan_network equality
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("specs,size_mem", [
    (SMALL_NET, None),
    (tight.LAYERS_SMALL, max(s.kernel_elements
                             for s in tight.LAYERS_SMALL) - 1),
])
def test_one_chip_reproduces_plan_network_exactly(specs, size_mem):
    cluster = make_cluster(1, size_mem=size_mem)
    solver.solve_cached.cache_clear()
    solver.best_s2_cached.cache_clear()
    net = plan_network(list(specs), cluster.chip, rng_seed=3, **FAST)
    mc = plan_multichip_network(list(specs), cluster, rng_seed=3, **FAST)
    assert mc.total_duration == net.total_duration
    assert mc.network_plan is not None
    assert mc.mode_string == "R" * len(specs)
    for mlp, lp in zip(mc.layers, net.layers):
        assert len(mlp.shards) == 1
        assert mlp.shards[0].strategy == lp.strategy
        assert mlp.duration == pytest.approx(lp.duration)
    # no ICI anywhere on one chip
    assert mc.ici_duration == 0.0
    # the delegated plan passes the cluster simulator's reconciliation
    rep = simulate_multichip(mc)
    assert rep.correct and rep.accounting_exact and rep.peak_within_budget
    assert rep.modeled_total_duration == net.total_duration


# --------------------------------------------------------------------- #
# The tight-config acceptance: 4 chips beat 1 chip, simulator-confirmed
# --------------------------------------------------------------------- #

def test_four_chip_beats_one_chip_on_tight_config():
    """configs/tight.py LAYERS at half the largest Λ: the single chip is
    forced into S2 kernel swapping on the deep layers; four chips shard
    the kernel set back into S1 territory and win despite ICI."""
    specs = tight.LAYERS
    c1 = make_cluster(1, size_mem=TIGHT_BUDGET)
    c4 = make_cluster(4, size_mem=TIGHT_BUDGET)
    p1 = plan_multichip_network(specs, c1, **FAST)
    p4 = plan_multichip_network(specs, c4, **FAST)
    assert p4.total_duration < p1.total_duration
    assert p4.n_sharded_layers >= 1
    assert p4.single_chip_duration == pytest.approx(p1.total_duration)
    assert p4.speedup_vs_single_chip > 1.0
    # sharding restores S1 feasibility the single chip lost
    one_chip_s2 = sum(1 for lp in p1.layers
                      for s in lp.shards if s.mode == "s2")
    assert one_chip_s2 >= 1
    for lp in p4.layers:
        if lp.mode == "channel":
            assert all(s.mode == "s1" for s in lp.shards)
    # full functional + accounting + per-chip memory reconciliation
    rep = simulate_multichip(p4)
    assert rep.correct
    assert rep.accounting_exact
    assert rep.peak_within_budget


def test_stitched_check_catches_shard_geometry_bugs():
    """The cluster simulator carves every shard out of ONE shared layer
    and stitches the outputs against the full reference — so a wrong
    band offset must flip ``correct`` to False (guards the guard)."""
    import dataclasses

    specs = tight.LAYERS
    c4 = make_cluster(4, size_mem=TIGHT_BUDGET)
    plan = plan_multichip_network(specs, c4, **FAST,
                                  include_single_chip_baseline=False)
    assert simulate_multichip(plan).correct
    for li, lp in enumerate(plan.layers):
        if lp.mode == "row":
            s0 = lp.shards[0]
            bad_shard = dataclasses.replace(
                s0, out_rows=(s0.out_rows[0] + 1, s0.out_rows[1] + 1))
            bad_layer = dataclasses.replace(
                lp, shards=(bad_shard,) + lp.shards[1:])
            bad_plan = dataclasses.replace(
                plan, layers=plan.layers[:li] + (bad_layer,)
                + plan.layers[li + 1:])
            assert not simulate_multichip(bad_plan).correct
            break
    else:
        pytest.fail("expected a row-sharded layer in the tight plan")


def test_sharded_layers_respect_per_chip_budget():
    specs = tight.LAYERS
    c4 = make_cluster(4, size_mem=TIGHT_BUDGET)
    p4 = plan_multichip_network(specs, c4, **FAST,
                                include_single_chip_baseline=False)
    assert p4.peak_footprint <= TIGHT_BUDGET
    for lp in p4.layers:
        for s in lp.shards:
            assert s.strategy.peak_footprint_elements() <= TIGHT_BUDGET


# --------------------------------------------------------------------- #
# ICI pricing
# --------------------------------------------------------------------- #

def test_ici_cost_monotone_and_replicate_collapse():
    """Raising t_ici never helps, and an ICI expensive enough makes the
    DP fall back to the all-replicate chain (whose ICI is zero: the
    activation stays on chip 0 end to end)."""
    specs = tight.LAYERS
    totals = []
    for factor in (0.0, 4.0, 1e6):
        cluster = make_cluster(4, size_mem=TIGHT_BUDGET, ici_factor=factor)
        plan = plan_multichip_network(specs, cluster, **FAST,
                                      include_single_chip_baseline=False)
        totals.append(plan.total_duration)
    assert totals == sorted(totals)
    expensive = make_cluster(4, size_mem=TIGHT_BUDGET, ici_factor=1e6)
    plan = plan_multichip_network(specs, expensive, **FAST,
                                  include_single_chip_baseline=False)
    assert plan.mode_string == "R" * len(specs)
    assert plan.ici_duration == 0.0


def test_ici_schedule_matches_plan_charges():
    """The pure re-pricing function must reproduce exactly the ICI the
    planner charged along the chosen mode sequence."""
    specs = tight.LAYERS
    cluster = make_cluster(4, size_mem=TIGHT_BUDGET)
    plan = plan_multichip_network(specs, cluster, **FAST,
                                  include_single_chip_baseline=False)
    per_layer, final = ici_schedule(
        [lp.spec for lp in plan.layers],
        [lp.mode for lp in plan.layers],
        [lp.active_chips for lp in plan.layers], cluster)
    assert per_layer == [lp.ici_elements for lp in plan.layers]
    assert final == plan.final_gather_elements
    assert plan.total_duration == pytest.approx(
        sum(lp.compute_duration for lp in plan.layers)
        + (sum(per_layer) + final) * cluster.t_ici)


def test_layer_zero_pays_no_ici():
    """The host stages the network input in every chip's DRAM, so the
    first layer is ICI-free in any mode."""
    specs = tight.LAYERS
    cluster = make_cluster(4, size_mem=TIGHT_BUDGET)
    for mode in MODES:
        try:
            plan = plan_multichip_network(
                specs[:1], cluster, modes=(mode,), **FAST,
                include_single_chip_baseline=False)
        except InfeasibleNetworkError:
            continue
        assert plan.layers[0].ici_elements == 0


# --------------------------------------------------------------------- #
# Determinism / errors
# --------------------------------------------------------------------- #

def test_deterministic_under_fixed_seed():
    specs = tight.LAYERS_SMALL
    cluster = make_cluster(2, size_mem=TIGHT_BUDGET)
    solver.solve_cached.cache_clear()
    a = plan_multichip_network(specs, cluster, rng_seed=11, **FAST)
    solver.solve_cached.cache_clear()
    b = plan_multichip_network(specs, cluster, rng_seed=11, **FAST)
    assert a.total_duration == b.total_duration
    assert a.mode_string == b.mode_string


def test_infeasible_cluster_raises_with_context():
    cluster = make_cluster(4, size_mem=8)
    with pytest.raises(InfeasibleNetworkError,
                       match=r"layer 0 .*size_mem=8.*4 chips"):
        plan_multichip_network(SMALL_NET, cluster, **FAST)


def test_empty_network_rejected():
    with pytest.raises(ValueError, match="empty"):
        plan_multichip_network([], make_cluster(2), **FAST)
