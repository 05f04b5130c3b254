"""The cases of ``tests/test_same_pad_bands.py``, read on ``repro_torch``
with the same inputs and settings. The reference's docstring follows.

Position-dependent halo accounting for edge bands under SAME padding:
edge bands skip their padding rows'
first loads, so ``balanced_row_heights`` picks an asymmetric partition —
pinned on a small grid — and the cluster simulator still reconciles the
analytic savings exactly.  ``same_pad=False`` stays bit-exact.
"""
import pytest

from repro_torch.configs.clusters import make_cluster
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.multichip import (balanced_row_heights, band_pad_rows,
                                        band_solve_duration,
                                        plan_multichip_network, same_pad_rows)
from repro_torch.sim import simulate_multichip
from _torch_port import fast_polish_port  # noqa: F401

FAST = dict(polish_iters=600, polish_restarts=1)
KW = dict(nb_data_reload=2, time_limit=5.0, polish_iters=300,
          use_milp=False, rng_seed=0, polish_restarts=1)

# SAME-padded 8x8 input (stride 1, 3x3 kernel): h_in = 10, h_out = 8,
# one zero row at the top and one at the bottom.
SPEC = ConvSpec(2, 10, 10, 2, 3, 3)
NET = (SPEC, ConvSpec(2, 8, 8, 4, 3, 3))


# --------------------------------------------------------------------- #
# Geometry
# --------------------------------------------------------------------- #

def test_same_pad_rows_split():
    assert same_pad_rows(SPEC) == (1, 1)
    assert same_pad_rows(ConvSpec(1, 12, 12, 1, 5, 5)) == (2, 2)
    # stride covers the kernel: nothing overlaps, no padding assumed
    assert same_pad_rows(ConvSpec(1, 12, 12, 1, 3, 3, s_h=3, s_w=3)) \
        == (0, 0)


def test_band_pad_rows_edges_only():
    """Only bands whose halo-extended window reaches into the padding
    see free rows; interior bands pay full freight."""
    assert band_pad_rows(SPEC, 0, 3) == 1      # window [0, 5): top row
    assert band_pad_rows(SPEC, 3, 5) == 0      # window [3, 7): interior
    assert band_pad_rows(SPEC, 5, 8) == 1      # window [5, 10): bottom
    assert band_pad_rows(SPEC, 0, 8) == 2      # whole map: both rows
    # strided: window [2, 5) of an 11-row input with top pad 0
    strided = ConvSpec(2, 11, 11, 2, 3, 3, s_h=2, s_w=2)
    assert same_pad_rows(strided) == (0, 1)
    assert band_pad_rows(strided, 0, 2) == 0
    assert band_pad_rows(strided, 3, 5) == 1   # window [6, 11): bottom


# --------------------------------------------------------------------- #
# The asymmetric balanced optimum, pinned
# --------------------------------------------------------------------- #

def test_balanced_heights_asymmetric_under_same_pad():
    """3 chips x 8 output rows: the plain DP balances row counts
    [3, 3, 2]; with SAME-padding savings the edge bands are cheaper per
    row, so the optimum gives them the extra rows — [3, 2, 3] — and its
    position-priced max strictly beats the plain partition's."""
    hw = make_cluster(1).chip
    plain = balanced_row_heights(SPEC, hw, 3, 16, KW)
    padded = balanced_row_heights(SPEC, hw, 3, 16, KW, same_pad=True)
    assert plain == [3, 3, 2]
    assert padded == [3, 2, 3]

    def pos_dur(heights):
        out, r0 = [], 0
        for r in heights:
            d = band_solve_duration(SPEC, r, hw, 16, KW)
            save = band_pad_rows(SPEC, r0, r0 + r) * SPEC.w_in * hw.t_l
            out.append(d - save)
            r0 += r
        return max(out)

    assert pos_dur(padded) < pos_dur(plain)


def test_same_pad_off_is_bit_exact():
    """The default path must not move: same plan, same totals."""
    cluster = make_cluster(3)
    a = plan_multichip_network(NET, cluster, modes=("row",),
                               include_single_chip_baseline=False,
                               balance_rows=True, **FAST)
    b = plan_multichip_network(NET, cluster, modes=("row",),
                               include_single_chip_baseline=False,
                               balance_rows=True, same_pad=False, **FAST)
    assert a.total_duration == b.total_duration
    assert all(sa.pad_saved == 0.0
               for lp in a.layers for sa in lp.shards)


# --------------------------------------------------------------------- #
# Plan-level accounting and simulator reconciliation
# --------------------------------------------------------------------- #

def test_same_pad_plan_saves_and_reconciles():
    cluster = make_cluster(3)
    plain = plan_multichip_network(NET, cluster, modes=("row",),
                                   include_single_chip_baseline=False,
                                   balance_rows=True, **FAST)
    padded = plan_multichip_network(NET, cluster, modes=("row",),
                                    include_single_chip_baseline=False,
                                    balance_rows=True, same_pad=True,
                                    **FAST)
    assert padded.total_duration < plain.total_duration
    edge_savings = [s.pad_saved for lp in padded.layers
                    for s in lp.shards if s.pad_saved > 0]
    assert edge_savings, "edge bands should record skipped pad loads"
    # savings never exceed a shard's first-load traffic (the clamp)
    for lp in padded.layers:
        for s in lp.shards:
            assert 0.0 <= s.pad_saved <= \
                s.strategy.first_load_duration(cluster.chip)
            assert s.gross_duration >= 0.0
    # measured == gross + pad_saved, per shard — the simulator checks it
    rep = simulate_multichip(padded)
    assert rep.correct and rep.accounting_exact and rep.peak_within_budget


def test_same_pad_credits_every_mode_consistently():
    """Replicate and channel shards hold the full map, padding rows
    included — they must get the whole-map credit so the mode DP is not
    biased toward row/hybrid sharding."""
    cluster = make_cluster(2)
    top, bot = same_pad_rows(SPEC)
    whole_map = (top + bot) * SPEC.w_in * cluster.chip.t_l
    for mode in ("replicate", "channel"):
        plan = plan_multichip_network(
            NET, cluster, modes=(mode,),
            include_single_chip_baseline=False, same_pad=True, **FAST)
        for lp in plan.layers:
            for s in lp.shards:
                assert s.pad_saved == pytest.approx(
                    min(whole_map if lp.spec is SPEC else
                        sum(same_pad_rows(lp.spec)) * lp.spec.w_in,
                        s.strategy.first_load_duration(cluster.chip)))
        rep = simulate_multichip(plan)
        assert rep.correct and rep.accounting_exact


def test_same_pad_rejects_one_chip_delegation():
    """The 1-chip path reproduces plan_network, which does not model
    padding — a silent accounting discontinuity between n=1 and n=2 is
    worse than an error."""
    with pytest.raises(ValueError, match="same_pad"):
        plan_multichip_network(NET, make_cluster(1), same_pad=True,
                               **FAST)


def test_same_pad_credits_single_chip_baseline():
    """speedup_vs_single_chip must compare consistently-padded
    accountings: the baseline gets the same whole-map credit the
    replicate shards get (clamped to first loads reuse didn't save)."""
    cluster = make_cluster(2)
    plain = plan_multichip_network(NET, cluster, modes=("replicate",),
                                   **FAST)
    padded = plan_multichip_network(NET, cluster, modes=("replicate",),
                                    same_pad=True, **FAST)
    assert padded.single_chip_duration < plain.single_chip_duration
    credit = plain.single_chip_duration - padded.single_chip_duration
    shard_credit = sum(s.pad_saved for lp in padded.layers
                       for s in lp.shards)
    assert 0 < credit <= shard_credit + 1e-9


def test_same_pad_accounting_mutation_detected():
    """Guard the guard: inflating one shard's pad_saved must flip
    accounting_exact."""
    import dataclasses

    plan = plan_multichip_network(NET, make_cluster(3), modes=("row",),
                                  include_single_chip_baseline=False,
                                  balance_rows=True, same_pad=True,
                                  **FAST)
    lp = plan.layers[0]
    bad_shard = dataclasses.replace(lp.shards[0],
                                    pad_saved=lp.shards[0].pad_saved + 5.0)
    bad_layer = dataclasses.replace(lp, shards=(bad_shard,)
                                    + lp.shards[1:])
    bad = dataclasses.replace(plan,
                              layers=(bad_layer,) + plan.layers[1:])
    assert not simulate_multichip(bad).accounting_exact
