"""The port's ILP formulation (Sec 5) and solver
(``repro_torch.core.ilp``, ``solver``): the cases of
``tests/test_ilp.py``, read on ``repro_torch`` with the same inputs and
settings. The reference's docstring follows.

ILP formulation (Sec 5) + solver tests.
"""
import itertools

import numpy as np
import pytest

from repro_torch.core import ilp, solver
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import run_steps
from repro_torch.core.strategies import GroupedStrategy, k_min, lower_bound
from _torch_port import fast_polish_port  # noqa: F401

HW = HardwareModel(nbop_pe=10**9)


def brute_force_optimal(spec, p, k):
    """Exhaustive search over ordered partitions into exactly k groups of
    size <= p (tiny instances only)."""
    best = None
    ids = list(range(spec.num_patches))

    def rec(remaining, groups):
        nonlocal best
        if len(groups) == k:
            if remaining:
                return
            strat = GroupedStrategy("bf", spec, tuple(groups))
            obj = strat.objective(HW)
            if best is None or obj < best:
                best = obj
            return
        for size in range(1, p + 1):
            for combo in itertools.combinations(remaining, size):
                rec([x for x in remaining if x not in combo],
                    groups + [tuple(combo)])

    rec(ids, [])
    return best


def test_ilp_matches_brute_force_tiny():
    spec = ConvSpec(1, 4, 4, 1, 3, 3)          # 4 patches
    p, k = 2, 2
    model = ilp.build_ilp(spec, p, k=k, nb_data_reload=2)
    strat, status, _ = solver.solve_milp(model, time_limit=30)
    assert status == "optimal"
    assert strat.objective(HW) == brute_force_optimal(spec, p, k)


def test_ilp_solution_satisfies_all_constraints():
    spec = ConvSpec(1, 6, 6, 1, 3, 3)
    p = 4
    model = ilp.build_ilp(spec, p, nb_data_reload=2)
    strat, status, _ = solver.solve_milp(model, time_limit=60)
    assert status in ("optimal", "feasible")
    assert strat.max_group_size() <= p                      # eq. 4
    assert strat.n_steps == k_min(spec, p)                  # Sec 7.1 setup
    assert strat.max_reloads() <= 2                         # eq. 9
    run_steps(strat.to_steps(), spec, HW)                   # executable


def test_ilp_memory_constraint_respected():
    spec = ConvSpec(1, 5, 5, 1, 3, 3)
    p = 3
    cap = spec.kernel_elements + 3 * 9 + p                  # tight-ish
    model = ilp.build_ilp(spec, p, nb_data_reload=3, size_mem=cap)
    strat, status, _ = solver.solve_milp(model, time_limit=60)
    if strat is None:
        pytest.skip(f"infeasible at cap={cap}")
    for g in strat.groups:
        used = (spec.group_mask(g).bit_count() * spec.c_in
                + spec.kernel_elements + len(g) * spec.c_out)
        assert used <= cap


def test_polish_improves_or_equals_seed():
    spec = ConvSpec(1, 8, 8, 1, 3, 3)
    from repro_torch.core.strategies import zigzag
    seed = zigzag(spec, 4)
    polished = solver.polish(seed, 4, HW, iters=4000, rng_seed=1)
    assert polished.objective(HW) <= seed.objective(HW)
    run_steps(polished.to_steps(), spec, HW)


def test_solve_end_to_end_reports():
    spec = ConvSpec(1, 6, 6, 1, 3, 3)
    res = solver.solve(spec, p=4, hw=HW, time_limit=10, polish_iters=3000)
    assert res.objective <= res.seed_objective
    assert res.objective >= res.lower_bound
    assert 0.0 <= res.gap
    run_steps(res.strategy.to_steps(), spec, HW)


def test_variable_count_formula():
    # paper Sec 7.1: N_var = K*(3*(H_in*W_in) + H_out*W_out); our model
    # eliminates pxl_I so we carry K*(2*J + |X|) binaries with J = covered
    # pixels <= H_in*W_in.
    spec = ConvSpec(1, 8, 8, 1, 3, 3)
    k = k_min(spec, 4)
    model = ilp.build_ilp(spec, 4, k=k)
    assert model.num_vars <= ilp.n_var_literal(spec, k)
    assert model.num_vars == k * (2 * len(model.pixels) + spec.num_patches)
