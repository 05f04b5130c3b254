"""The cases of ``tests/test_multichip_overlap.py``, read on
``repro_torch`` with the same inputs and settings. The reference's
docstring follows.

Multi-chip overlap + duration-balanced bands: the 1-chip
delegation stays exact under the new flags, balanced band heights never
exceed the row-balanced max-over-chips duration, the overlap accounting
reconciles exactly in the cluster simulator, and ``overlap=False``
reproduces the serialised per-layer identity bit-exactly.
"""
import pytest

from repro_torch.configs import tight
from repro_torch.configs.clusters import make_cluster
from repro_torch.core import solver
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.multichip import (balanced_row_heights,
                                        band_solve_duration,
                                        plan_multichip_network,
                                        row_shard_specs)
from repro_torch.core.network_planner import plan_network
from repro_torch.sim import simulate_multichip
from _torch_port import fast_polish_port  # noqa: F401

FAST = dict(polish_iters=600, polish_restarts=1)

TIGHT_BUDGET = max(s.kernel_elements for s in tight.LAYERS) // 2


# --------------------------------------------------------------------- #
# 1-chip delegation under the new flags
# --------------------------------------------------------------------- #

def test_one_chip_with_overlap_flags_reproduces_plan_network():
    specs = tight.LAYERS_SMALL
    cluster = make_cluster(1, size_mem=TIGHT_BUDGET)
    solver.solve_cached.cache_clear()
    solver.best_s2_cached.cache_clear()
    net = plan_network(list(specs), cluster.chip, rng_seed=5, **FAST)
    mc = plan_multichip_network(list(specs), cluster, rng_seed=5,
                                overlap=True, balance_rows=True, **FAST)
    assert mc.total_duration == net.total_duration
    assert mc.overlap and mc.balance_rows
    for mlp, lp in zip(mc.layers, net.layers):
        assert mlp.shards[0].strategy == lp.strategy
        assert mlp.duration == pytest.approx(lp.duration)
    rep = simulate_multichip(mc)
    assert rep.correct and rep.accounting_exact and rep.peak_within_budget


# --------------------------------------------------------------------- #
# Duration-balanced bands
# --------------------------------------------------------------------- #

def test_balanced_heights_tile_rows_and_never_exceed_row_balance():
    """The balanced partition covers every output row with the right
    number of bands, and its max solved band duration is <= the
    near-even (row-balanced) split's."""
    hw = make_cluster(1, size_mem=TIGHT_BUDGET).chip
    kwargs = dict(nb_data_reload=2, time_limit=5.0, polish_iters=300,
                  use_milp=False, rng_seed=0, polish_restarts=1)
    for spec, n_chips in ((tight.TIGHT_L3, 3), (tight.TIGHT_L2, 4),
                          (ConvSpec(3, 12, 12, 4, 3, 3), 4)):
        heights = balanced_row_heights(spec, hw, n_chips, 16, kwargs)
        assert heights is not None
        n = min(n_chips, spec.h_out)
        assert len(heights) == n
        assert sum(heights) == spec.h_out
        assert min(heights) >= 1

        def max_dur(hts):
            return max(band_solve_duration(spec, r, hw, 16, kwargs)
                       for r in hts)
        even = [r1 - r0 for _, (r0, r1), _ in row_shard_specs(spec, n)]
        assert max_dur(heights) <= max_dur(even) + 1e-9
        # the shard geometry accepts the balanced heights
        shards = row_shard_specs(spec, n_chips, heights)
        assert [s.h_out for _, _, s in shards] == heights


def test_row_shard_specs_rejects_bad_heights():
    spec = ConvSpec(3, 12, 12, 4, 3, 3)      # h_out = 10
    with pytest.raises(ValueError):
        row_shard_specs(spec, 4, heights=[5, 5, 5, 5])
    with pytest.raises(ValueError):
        row_shard_specs(spec, 4, heights=[10, 0, 0, 0])
    with pytest.raises(ValueError):
        row_shard_specs(spec, 4, heights=[5, 5])


# --------------------------------------------------------------------- #
# Overlap accounting
# --------------------------------------------------------------------- #

def _plans(overlap, balance):
    cluster = make_cluster(4, size_mem=TIGHT_BUDGET)
    return plan_multichip_network(
        tight.LAYERS, cluster, include_single_chip_baseline=False,
        overlap=overlap, balance_rows=balance, **FAST)


def test_overlap_never_slower_and_strictly_faster_with_ici():
    ser = _plans(False, False)
    ovl = _plans(True, True)
    assert ovl.total_duration <= ser.total_duration
    # the tight config shards, so some stage pays ICI the overlap hides
    assert ser.ici_duration > 0
    assert ovl.total_duration < ser.total_duration


def test_serialized_accounting_identity_unchanged():
    """overlap=False: every layer's duration is exactly compute + ICI
    (the PR-3 serialised model) and the total is their sum plus the
    final gather — the bit-exact reproduction path."""
    ser = _plans(False, False)
    assert not ser.overlap
    total = ser.final_gather_duration
    for lp in ser.layers:
        assert lp.duration == pytest.approx(
            lp.compute_duration + lp.ici_duration)
        total += lp.duration
    assert total == pytest.approx(ser.total_duration)


def test_overlap_accounting_identity_and_sim_reconciliation():
    """overlap=True: a stage the planner proved WAR-free (per-layer
    ``lp.overlap``) prices max(compute, ICI); a halo exchange it could
    not prove safe stays serialised at compute + ICI.  The cluster
    simulator's accounting_exact must recompose the total from measured
    shard durations under each stage's own discipline."""
    ovl = _plans(True, True)
    assert ovl.overlap
    total = ovl.final_gather_duration
    for lp in ovl.layers:
        if lp.overlap:
            assert lp.duration == pytest.approx(
                max(lp.compute_duration, lp.ici_duration))
        else:
            assert lp.duration == pytest.approx(
                lp.compute_duration + lp.ici_duration)
        total += lp.duration
    assert total == pytest.approx(ovl.total_duration)
    rep = simulate_multichip(ovl)
    assert rep.correct
    assert rep.accounting_exact
    assert rep.peak_within_budget


def test_overlap_accounting_detects_wrong_totals():
    """Guard the guard: perturbing the plan total must flip
    accounting_exact under the overlap discipline."""
    import dataclasses

    ovl = _plans(True, False)
    bad = dataclasses.replace(ovl, total_duration=ovl.total_duration + 1.0)
    assert not simulate_multichip(bad).accounting_exact
