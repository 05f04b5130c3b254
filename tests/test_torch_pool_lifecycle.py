"""The cases of ``tests/test_pool_lifecycle.py``, read on ``repro_torch``
with the same inputs and settings. The reference's docstring follows.

Polish-pool lifecycle: a broken pool is evicted
and rebuilt alone (siblings keep their workers), the atexit shutdown
bars resurrection, and the solve-LRU size is env-configurable.
"""
import os

import pytest

from repro_torch.core import solver
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.strategies import GroupedStrategy
from _torch_port import fast_polish_port  # noqa: F401

SPEC = ConvSpec(3, 6, 6, 2, 3, 3)
HW = HardwareModel(nbop_pe=10 ** 9, size_mem=400)


def _seed() -> GroupedStrategy:
    return GroupedStrategy(
        "seed", SPEC, tuple((i,) for i in range(SPEC.num_patches)))


@pytest.fixture
def fresh_pools():
    """Empty pool registry before and after, never leaking the final
    flag between tests."""
    solver.shutdown_pools()
    prev_final = solver._POOLS_FINAL
    solver._POOLS_FINAL = False
    yield
    solver._POOLS_FINAL = prev_final
    solver.shutdown_pools()


def test_broken_pool_evicted_and_rebuilt_alone(fresh_pools):
    """Killing one pool's workers must not clear the whole registry:
    polish_multi retries on a fresh replacement pool and the sibling
    pool (different size) keeps its object — and its warm workers."""
    ref = solver.polish_multi(_seed(), 2, HW, iters=10, restarts=2,
                              workers=2)
    other = solver.polish_multi(_seed(), 2, HW, iters=10, restarts=2,
                                workers=1)
    key2, key1 = solver._pool_key(2), solver._pool_key(1)
    assert set(solver._POOLS) == {key2, key1}
    broken, sibling = solver._POOLS[key2], solver._POOLS[key1]
    for proc in broken._processes.values():
        proc.kill()
    got = solver.polish_multi(_seed(), 2, HW, iters=10, restarts=2,
                              workers=2)
    assert got == ref                       # deterministic across retry
    assert solver.polish_multi(_seed(), 2, HW, iters=10, restarts=2,
                               workers=1) == other
    assert solver._POOLS[key1] is sibling   # sibling survived untouched
    assert solver._POOLS[key2] is not broken


def test_final_shutdown_bars_resurrection(fresh_pools):
    """After the atexit-style final shutdown, polish_multi still returns
    the identical best-of-restarts result — serially, without building
    a pool mid-teardown."""
    ref = solver.polish_multi(_seed(), 2, HW, iters=10, restarts=2,
                              workers=2)
    solver.shutdown_pools(final=True)
    assert not solver._POOLS
    got = solver.polish_multi(_seed(), 2, HW, iters=10, restarts=2,
                              workers=2)
    assert got == ref
    assert not solver._POOLS                # no resurrection


def test_nonfinal_shutdown_allows_rebuild(fresh_pools):
    """The test-hook shutdown (conftest calls it between sessions) frees
    workers but later calls may build pools again."""
    solver.polish_multi(_seed(), 2, HW, iters=10, restarts=2, workers=2)
    solver.shutdown_pools()
    assert not solver._POOLS
    solver.polish_multi(_seed(), 2, HW, iters=10, restarts=2, workers=2)
    assert solver._POOLS


# ------------------------------------------------------------------ #
# REPRO_SOLVE_CACHE_SIZE
# ------------------------------------------------------------------ #

@pytest.fixture
def cache_size_env():
    prev = os.environ.get("REPRO_SOLVE_CACHE_SIZE")
    yield
    if prev is None:
        os.environ.pop("REPRO_SOLVE_CACHE_SIZE", None)
    else:
        os.environ["REPRO_SOLVE_CACHE_SIZE"] = prev
    solver.reconfigure_caches()


def test_cache_size_env_resizes_and_counts_evictions(cache_size_env):
    os.environ["REPRO_SOLVE_CACHE_SIZE"] = "4"
    solver.reconfigure_caches()
    assert solver.solve_cached.cache_info().maxsize == 4
    for mem in range(300, 360, 10):        # 6 distinct keys into 4 slots
        solver.solve_cached(SPEC, 2,
                            HardwareModel(nbop_pe=10 ** 9, size_mem=mem),
                            polish_iters=20, use_milp=False)
    info = solver.solve_cached.cache_info()
    assert info.currsize == 4
    assert info.misses - info.currsize == 2    # the --profile eviction count


@pytest.mark.parametrize("raw,maxsize", [
    ("0", None),          # <= 0: unbounded
    ("-3", None),
    ("", 256),            # empty/garbage: default
    ("not-a-number", 256),
])
def test_cache_size_env_edge_values(cache_size_env, raw, maxsize):
    os.environ["REPRO_SOLVE_CACHE_SIZE"] = raw
    solver.reconfigure_caches()
    assert solver.solve_cached.cache_info().maxsize == maxsize
    assert solver.best_s2_cached.cache_info().maxsize == maxsize
