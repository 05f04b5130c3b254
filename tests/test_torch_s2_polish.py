"""The cases of ``tests/test_s2_polish.py``, read on ``repro_torch`` with
the same inputs and settings. The reference's docstring follows.

S2 polishing search + joint (p, strategy) budget search:
closed-form seed pricing equivalence, ragged kernel groups, exhaustive
tiny-instance equivalence for the order MILP/polish, polish monotonicity,
and the property that ``solve_cached`` never loses to either of the old
single-endpoint policies (S1-at-max-p, S2-only) at the same budget.
"""
import itertools

import pytest

from repro_torch.core import solver
from repro_torch.core import strategies_s2 as s2
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.sim import ConvLayer
from repro_torch.sim.s2 import run_s2
from _torch_port import fast_polish_port  # noqa: F401

BIG = HardwareModel(nbop_pe=10 ** 9, size_mem=None)


# --------------------------------------------------------------------- #
# Seed enumeration: closed-form pricing
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("spec", [
    ConvSpec(2, 6, 6, 7, 3, 3),
    ConvSpec(1, 8, 8, 5, 3, 3),
    ConvSpec(4, 7, 7, 6, 3, 3, s_h=2, s_w=2),
    ConvSpec(3, 9, 9, 4, 5, 5),
])
def test_closed_form_pricing_matches_built_strategies(spec):
    """The analytic (objective, peak) of every (order, p, kg) candidate
    must equal the materialised strategy's — including ragged final
    kernel groups and strided specs."""
    for kg in range(1, spec.n_kernels + 1):
        ks = s2._kg_lens(spec.n_kernels, kg)
        for p in (1, 2, 3, spec.num_patches):
            prof = s2._zig_profile(spec, p)
            for order, builder in (("kernel_major", s2.kernel_major),
                                   ("patch_major", s2.patch_major)):
                obj, peak = s2._price_candidate(spec, BIG, prof, ks, order)
                built = builder(spec, p, kg)
                assert obj == pytest.approx(built.objective(BIG))
                assert peak == built.peak_memory_elements()


def test_ragged_kernel_groups_enumerated():
    """Regression: 7 kernels used to admit only kg sizes 1 and 7 (the
    divisors); now e.g. 3+3+1 is a candidate and the ragged builder
    produces exactly that chunking."""
    spec = ConvSpec(2, 6, 6, 7, 3, 3)
    strat = s2.kernel_major(spec, 4, 3)
    assert tuple(len(g) for g in strat.kernel_groups) == (3, 3, 1)
    rep = run_s2(ConvLayer.random(spec, seed=0), BIG, strat)
    assert rep.correct
    # the full enumeration can only improve on the divisor-only one
    full = s2.best_s2(spec, BIG, polish_iters=0, use_milp=False)
    divisors = s2.best_s2(spec, BIG, kg_sizes=[1, 7], polish_iters=0,
                          use_milp=False)
    assert full.objective <= divisors.objective


def test_small_pe_skips_oversized_kernel_groups():
    """A PE too small for a (patch x kernel-group) step skips that kg
    size instead of raising (large ragged sizes hit this first)."""
    spec = ConvSpec(2, 6, 6, 8, 3, 3)
    hw = HardwareModel(nbop_pe=spec.nb_op_value * 3, size_mem=None)
    res = s2.best_s2(spec, hw, polish_iters=0, use_milp=False)
    assert max(len(g) for g in res.strategy.kernel_groups) <= 3


# --------------------------------------------------------------------- #
# Polish + order MILP
# --------------------------------------------------------------------- #

def test_polish_never_worse_and_stays_feasible():
    spec = ConvSpec(2, 8, 8, 7, 3, 3)
    budget = spec.kernel_elements - 1          # S2-only regime
    hw = HardwareModel(nbop_pe=10 ** 9, size_mem=budget)
    res = s2.best_s2(spec, hw, polish_iters=800, rng_seed=1)
    assert res.seed_objective is not None
    assert res.objective <= res.seed_objective
    assert res.gain_vs_seed >= 0.0
    assert res.peak_memory <= budget
    rep = run_s2(ConvLayer.random(spec, seed=2), hw, res.strategy)
    assert rep.correct
    assert rep.total_duration == pytest.approx(
        res.strategy.full_duration(hw))
    assert rep.peak_memory <= budget


def test_polish_improves_over_canonical_orders():
    """On a kernel-heavy layer the joint polish must strictly beat the
    best canonical (kernel/patch-major x zigzag) schedule — the S2
    optimality gap this PR closes."""
    spec = ConvSpec(4, 8, 8, 6, 3, 3)
    hw = HardwareModel(nbop_pe=10 ** 9,
                       size_mem=spec.kernel_elements - 1)
    res = s2.best_s2(spec, hw, polish_iters=3000, rng_seed=0)
    assert res.objective < res.seed_objective


def _brute_force_best_order(strategy, hw) -> float:
    """Exact minimum objective over ALL schedule orders of the grid."""
    grid = s2._grid_of(strategy)
    assert grid is not None
    pgroups, cells = grid
    st = s2._S2Grid(strategy.spec, hw, pgroups, strategy.kernel_groups,
                    cells, None)
    best = None
    for perm in itertools.permutations(range(len(st.order))):
        st.order = list(perm)
        c = st.cost()
        if best is None or c < best:
            best = c
    return best


@pytest.mark.parametrize("spec,nbop", [
    (ConvSpec(1, 5, 5, 3, 3, 3), 10 ** 9),           # 9 patches, 3 kernels
    (ConvSpec(1, 4, 4, 4, 3, 3), 10 ** 9),           # 4 patches, 4 kernels
    (ConvSpec(2, 4, 4, 2, 3, 3), None),              # PE-capped grid
])
def test_tiny_instances_reach_exhaustive_order_optimum(spec, nbop):
    """On instances small enough for the order MILP (<= 6 patches per
    group schedule, <= 4 kernels), best_s2 must return the exhaustive
    best order of its grid, with the MILP reporting optimality."""
    nbop = nbop or spec.nb_op_value * spec.n_kernels * 2
    hw = HardwareModel(nbop_pe=nbop, size_mem=None)
    res = s2.best_s2(spec, hw, polish_iters=200, rng_seed=0)
    if res.strategy.n_steps <= s2.S2_MILP_MAX_CELLS:
        assert res.milp_status in ("optimal", "feasible", "timeout",
                                   "skipped_not_grid")
    exhaustive = _brute_force_best_order(res.strategy, hw)
    assert res.objective == pytest.approx(exhaustive)


def test_milp_order_handles_asymmetric_memory_feasibility():
    """An order can be feasible while its reverse overflows (the pending
    write-back of the bigger kernel group): the exact directed model must
    keep the feasible direction instead of reporting infeasible."""
    spec = ConvSpec(1, 5, 5, 3, 3, 3)
    hw = HardwareModel(nbop_pe=10 ** 9,
                       size_mem=spec.kernel_elements + 40)
    res = s2.best_s2(spec, hw, polish_iters=200, rng_seed=0)
    assert res.milp_status == "optimal"
    assert res.peak_memory <= hw.size_mem


def test_polish_preserves_grid_coverage():
    """Any polished schedule still computes every (patch, kernel) cell
    exactly once (S2Strategy.__post_init__ would raise otherwise) and
    executes correctly through the functional simulator."""
    spec = ConvSpec(2, 7, 7, 5, 3, 3)
    hw = HardwareModel(nbop_pe=10 ** 9, size_mem=spec.kernel_elements)
    res = s2.best_s2(spec, hw, polish_iters=1000, rng_seed=3)
    rep = run_s2(ConvLayer.random(spec, seed=4), hw, res.strategy)
    assert rep.correct
    assert rep.total_macs == spec.macs_total


# --------------------------------------------------------------------- #
# Joint (p, strategy) search
# --------------------------------------------------------------------- #

def test_joint_search_never_worse_than_either_endpoint():
    """Property: at every budget, solve_cached's full-Def-3
    duration is <= both old endpoints — the S1 solve at the largest
    feasible group size, and the S2 search alone."""
    spec = ConvSpec(4, 10, 10, 12, 3, 3)
    for frac in (0.4, 0.75, 1.0, 1.5, 3.0):
        size_mem = int(spec.kernel_elements * frac)
        hw = HardwareModel(nbop_pe=10 ** 9, size_mem=size_mem)
        solver.solve_cached.cache_clear()
        solver.best_s2_cached.cache_clear()
        p = 8
        joint = solver.solve_cached(spec, p, hw, polish_iters=400,
                                    use_milp=False, polish_restarts=1)
        joint_full = joint.strategy.full_duration(hw)
        assert joint.strategy.peak_footprint_elements() <= size_mem

        endpoints = []
        p_fit = solver.s1_max_feasible_p(spec, p, hw)
        if p_fit is not None:
            s1 = solver.solve(spec, p_fit, hw, polish_iters=400,
                              use_milp=False, polish_restarts=1)
            if s1.strategy.peak_footprint_elements() <= size_mem:
                endpoints.append(s1.strategy.full_duration(hw))
        try:
            s2_only = s2.best_s2(spec, hw)
            endpoints.append(s2_only.strategy.full_duration(hw))
        except ValueError:
            pass
        assert endpoints, "budget admits no endpoint at all"
        assert joint_full <= min(endpoints) + 1e-9


def test_joint_search_unconstrained_path_unchanged():
    """size_mem=None (the paper's Sec-7.1 setting) takes the historical
    S1 path: no S2 comparison, mode stays s1."""
    spec = ConvSpec(2, 8, 8, 4, 3, 3)
    hw = HardwareModel(nbop_pe=10 ** 9, size_mem=None)
    solver.solve_cached.cache_clear()
    res = solver.solve_cached(spec, 8, hw, polish_iters=300,
                              use_milp=False)
    assert res.mode == "s1"


def test_s2_fallback_result_reports_polish_stage():
    """The S2 fallback SolveResult now carries the seed objective (so
    gain_vs_seed reflects the polish) and the MILP status."""
    spec = ConvSpec(6, 8, 8, 16, 3, 3)
    hw = HardwareModel(nbop_pe=10 ** 9,
                       size_mem=spec.kernel_elements // 2)
    solver.solve_cached.cache_clear()
    solver.best_s2_cached.cache_clear()
    res = solver.solve_cached(spec, 8, hw, polish_iters=400,
                              use_milp=False)
    assert res.mode == "s2"
    assert res.objective <= res.seed_objective
    assert res.gain_vs_seed >= 0.0
