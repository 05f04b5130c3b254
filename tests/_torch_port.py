"""Shared by the ``test_torch_*.py`` files: the port's own polish cap.

``tests/conftest.py`` caps the polish budgets of ``repro.core.solver``;
the port keeps its own copy of the solver, so its tests cap that copy
here, or they would run paper-sized budgets.  A test file takes the
fixture by importing it::

    from _torch_port import fast_polish_port  # noqa: F401
"""
import os

import pytest

from repro_torch.core import solver, strategies_s2

_MAX_ITERS = 1_500
_MAX_RESTARTS = 2
_MAX_S2_ITERS = 400


@pytest.fixture(autouse=True)
def fast_polish_port(monkeypatch):
    """Cap polish iterations/restarts of the port's solver entry points
    (``REPRO_FULL_POLISH=1`` lifts the cap, as for the reference)."""
    if os.environ.get("REPRO_FULL_POLISH"):
        yield
        return

    orig_solve = solver.solve

    def capped_solve(spec, p, hw, nb_data_reload=2, size_mem=None,
                     time_limit=30.0, polish_iters=30_000,
                     milp_var_limit=60_000, use_milp=True, rng_seed=0,
                     polish_restarts=1, polish_workers=None):
        return orig_solve(
            spec, p, hw, nb_data_reload=nb_data_reload, size_mem=size_mem,
            time_limit=time_limit,
            polish_iters=min(polish_iters, _MAX_ITERS),
            milp_var_limit=milp_var_limit, use_milp=use_milp,
            rng_seed=rng_seed,
            polish_restarts=min(polish_restarts, _MAX_RESTARTS),
            polish_workers=polish_workers)

    orig_polish = solver.polish

    def capped_polish(seed, p, hw, nb_data_reload=2, iters=30_000,
                      rng_seed=0):
        return orig_polish(seed, p, hw, nb_data_reload,
                           iters=min(iters, _MAX_ITERS), rng_seed=rng_seed)

    monkeypatch.setattr(solver, "solve", capped_solve)
    monkeypatch.setattr(solver, "polish", capped_polish)
    monkeypatch.setattr(
        strategies_s2, "DEFAULT_POLISH_ITERS",
        min(strategies_s2.DEFAULT_POLISH_ITERS, _MAX_S2_ITERS))
    yield
    solver.shutdown_pools()
