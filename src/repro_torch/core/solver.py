"""Strategy optimisation (paper Sec 5 + Sec 7.1 solver setup).

The paper solves the MILP with CPLEX, warm-started from the best of
ZigZag/Row-by-Row ("MIP Start") and switched to "Solution Polishing" after
60 s.  CPLEX is unavailable offline, so we reproduce the *method*:

  1. heuristic seeds: Row-by-Row, ZigZag (paper) + Tiled, Hilbert (ours);
  2. a polishing local search over ordered patch partitions — simulated
     annealing with bitmask-incremental cost evaluation (this plays the role
     of CPLEX's genetic polishing, seeded exactly like their MIP start);
  3. the exact MILP (Sec 5) via HiGHS (`scipy.optimize.milp`) with a time
     limit, when the model is small enough;
  4. the analytic lower bound, so optimality gaps are always reported.

The search space is restricted to K = K_min groups (Sec 7.1).
"""
from __future__ import annotations

import atexit
import concurrent.futures
import dataclasses
import functools
import multiprocessing
import os
import random
import sys
from typing import Sequence

import numpy as np

from repro_torch.core import ilp as ilp_mod
from repro_torch.core import strategies_s2 as s2_mod
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.strategies import (
    GroupedStrategy, best_heuristic, hilbert, k_min, lower_bound,
    row_by_row, tiled, zigzag)


@dataclasses.dataclass
class SolveResult:
    strategy: GroupedStrategy | s2_mod.S2Strategy
    objective: float            # eq. 15 (S1) / full-load objective (S2)
    lower_bound: float
    seed_objective: float       # best heuristic (the MIP start)
    milp_status: str            # "optimal" | "feasible" | "skipped" | "infeasible" | "s2_fallback"
    milp_objective: float | None
    polish_objective: float
    reload_ok: bool             # satisfies nb_data_reload
    mode: str = "s1"            # "s1" | "s2" (kernel-group swapping)

    @property
    def gap(self) -> float:
        if self.lower_bound <= 0:
            return 0.0
        return self.objective / self.lower_bound - 1.0

    @property
    def gain_vs_seed(self) -> float:  # lint: public-api
        """Paper Fig 13 metric: relative gain over best heuristic."""
        if self.seed_objective == 0:
            return 0.0
        return 1.0 - self.objective / self.seed_objective


# --------------------------------------------------------------------- #
# Polishing local search
# --------------------------------------------------------------------- #

_RELOAD_PENALTY = 10_000.0

_EMPTY_IDX = np.empty(0, dtype=np.int64)


def _mask_to_indices(mask: int, num_pixels: int) -> np.ndarray:
    """Vectorised bitmask -> sorted pixel-index array (the polish hot path:
    one unpackbits instead of a Python loop over set bits)."""
    if mask == 0:
        return _EMPTY_IDX
    buf = mask.to_bytes((num_pixels + 7) // 8, "little")
    bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8),
                         bitorder="little")
    return np.flatnonzero(bits[:num_pixels])


class _SearchState:
    """Ordered partition with O(affected-groups) incremental cost."""

    def __init__(self, spec: ConvSpec, groups: Sequence[Sequence[int]],
                 p: int, nb_data_reload: int):
        self.spec = spec
        self.p = p
        self.r = nb_data_reload
        self.groups: list[list[int]] = [list(g) for g in groups]
        self.k = len(self.groups)
        self.gmask = [spec.group_mask(g) for g in self.groups]
        self.loads = np.zeros(spec.num_pixels, dtype=np.int32)
        self.total_load = 0
        for kk in range(self.k):
            isl = self._islice(kk)
            self.total_load += isl.bit_count()
            self.loads[_mask_to_indices(isl, spec.num_pixels)] += 1
        self.violations = int(np.maximum(self.loads - self.r, 0).sum())

    def _islice(self, kk: int) -> int:
        prev = self.gmask[kk - 1] if kk > 0 else 0
        return self.gmask[kk] & ~prev

    def cost(self) -> float:
        return self.total_load + _RELOAD_PENALTY * self.violations

    # -- incremental update of steps' I_slices after group masks change --
    def _refresh_islices(self, ks: Sequence[int], old_islices: dict[int, int]):
        npix = self.spec.num_pixels
        for kk in ks:
            old = old_islices[kk]
            new = self._islice(kk)
            if old == new:
                continue
            gone, came = old & ~new, new & ~old
            self.total_load += came.bit_count() - gone.bit_count()
            gi = _mask_to_indices(gone, npix)
            if gi.size:
                self.violations -= int((self.loads[gi] > self.r).sum())
                self.loads[gi] -= 1
            ci = _mask_to_indices(came, npix)
            if ci.size:
                self.loads[ci] += 1
                self.violations += int((self.loads[ci] > self.r).sum())

    def _affected(self, ks: Sequence[int]) -> list[int]:
        out = set()
        for kk in ks:
            out.add(kk)
            if kk + 1 < self.k:
                out.add(kk + 1)
        return sorted(out)

    def _snapshot(self, ks: Sequence[int]) -> dict[int, int]:
        return {kk: self._islice(kk) for kk in ks}

    # -- moves: each returns an undo closure ------------------------------
    def move_swap_patches(self, a: int, ia: int, b: int, ib: int):
        ks = self._affected([a, b])
        snap = self._snapshot(ks)
        ga, gb = self.groups[a], self.groups[b]
        ga[ia], gb[ib] = gb[ib], ga[ia]
        self.gmask[a] = self.spec.group_mask(ga)
        self.gmask[b] = self.spec.group_mask(gb)
        self._refresh_islices(ks, snap)

        def undo():
            snap2 = self._snapshot(ks)
            ga[ia], gb[ib] = gb[ib], ga[ia]
            self.gmask[a] = self.spec.group_mask(ga)
            self.gmask[b] = self.spec.group_mask(gb)
            self._refresh_islices(ks, snap2)
        return undo

    def move_relocate(self, a: int, ia: int, b: int):
        """Move one patch from group a (|a|>1) to group b (|b|<p)."""
        ks = self._affected([a, b])
        snap = self._snapshot(ks)
        pid = self.groups[a].pop(ia)
        self.groups[b].append(pid)
        self.gmask[a] = self.spec.group_mask(self.groups[a])
        self.gmask[b] = self.spec.group_mask(self.groups[b])
        self._refresh_islices(ks, snap)

        def undo():
            snap2 = self._snapshot(ks)
            self.groups[b].pop()
            self.groups[a].insert(ia, pid)
            self.gmask[a] = self.spec.group_mask(self.groups[a])
            self.gmask[b] = self.spec.group_mask(self.groups[b])
            self._refresh_islices(ks, snap2)
        return undo

    def move_reverse(self, a: int, b: int):
        """2-opt on the group order: reverse segment [a, b]."""
        ks = self._affected(range(a, b + 1))
        snap = self._snapshot(ks)
        self.groups[a:b + 1] = self.groups[a:b + 1][::-1]
        self.gmask[a:b + 1] = self.gmask[a:b + 1][::-1]
        self._refresh_islices(ks, snap)

        def undo():
            snap2 = self._snapshot(ks)
            self.groups[a:b + 1] = self.groups[a:b + 1][::-1]
            self.gmask[a:b + 1] = self.gmask[a:b + 1][::-1]
            self._refresh_islices(ks, snap2)
        return undo

    def strategy(self, name: str = "polished") -> GroupedStrategy:
        return GroupedStrategy(
            name, self.spec, tuple(tuple(g) for g in self.groups if g))


def polish(seed: GroupedStrategy, p: int, hw: HardwareModel,
           nb_data_reload: int = 2, iters: int = 30_000,
           rng_seed: int = 0) -> GroupedStrategy:
    """Simulated-annealing polish of a seed strategy (our stand-in for
    CPLEX solution polishing).  Keeps K fixed (= len(seed.groups))."""
    spec = seed.spec
    st = _SearchState(spec, seed.groups, p, nb_data_reload)
    rng = random.Random(rng_seed)
    best_cost = st.cost()
    best = st.strategy()
    cur = best_cost
    t0, t1 = max(2.0, best_cost * 0.02), 0.05
    for it in range(iters):
        temp = t0 * (t1 / t0) ** (it / max(1, iters - 1))
        kind = rng.random()
        if st.k < 2:
            break
        if kind < 0.45:
            a, b = rng.sample(range(st.k), 2)
            if not st.groups[a] or not st.groups[b]:
                continue
            undo = st.move_swap_patches(
                a, rng.randrange(len(st.groups[a])),
                b, rng.randrange(len(st.groups[b])))
        elif kind < 0.70:
            a, b = rng.sample(range(st.k), 2)
            if len(st.groups[a]) <= 1 or len(st.groups[b]) >= p:
                continue
            undo = st.move_relocate(a, rng.randrange(len(st.groups[a])), b)
        else:
            a = rng.randrange(st.k)
            b = min(st.k - 1, a + rng.randint(1, 6))
            if a >= b:
                continue
            undo = st.move_reverse(a, b)
        new_cost = st.cost()
        if new_cost <= cur or rng.random() < np.exp(-(new_cost - cur) / temp):
            cur = new_cost
            if cur < best_cost:
                best_cost = cur
                best = st.strategy()
        else:
            undo()
    return best


def _polish_task(args) -> GroupedStrategy:
    seed, p, hw, nb_data_reload, iters, rng_seed = args
    return polish(seed, p, hw, nb_data_reload, iters=iters,
                  rng_seed=rng_seed)


_POOLS: dict[tuple[str, int], concurrent.futures.ProcessPoolExecutor] = {}
_POOLS_FINAL = False    # set by the atexit shutdown — bars resurrection


def shutdown_pools(final: bool = False) -> None:
    """Shut down the long-lived polish pools.  Registered with ``atexit``
    (so pytest / benchmark runs exit promptly instead of joining idle
    workers) and exposed as a test hook.  ``final=True`` (the atexit
    path) additionally bars later ``polish_multi`` calls from
    resurrecting a pool mid-interpreter-teardown — they run serially."""
    global _POOLS_FINAL
    if final:
        _POOLS_FINAL = True
    for pool in _POOLS.values():
        pool.shutdown(wait=False, cancel_futures=True)
    _POOLS.clear()


atexit.register(shutdown_pools, final=True)


def _pool_key(max_workers: int) -> tuple[str, int]:
    """Pool registry key: (start method, size).  Forking a process that
    already initialised jax's thread pools can deadlock, so spawn is used
    once jax is loaded — its higher startup cost is exactly what pool
    reuse amortises.  Computed once per ``polish_multi`` call so a retry
    after eviction rebuilds the same pool it evicted."""
    return ("spawn" if "jax" in sys.modules else "fork", max_workers)


def _polish_pool(key: tuple[str, int],
                 ) -> concurrent.futures.ProcessPoolExecutor:
    """Long-lived process pool for ``key`` — re-used across solve calls so
    a network plan pays worker startup once, not once per layer
    (concurrent.futures joins the workers at exit)."""
    pool = _POOLS.get(key)
    if pool is None:
        pool = concurrent.futures.ProcessPoolExecutor(
            key[1], mp_context=multiprocessing.get_context(key[0]))
        _POOLS[key] = pool
    return pool


def _evict_pool(key: tuple[str, int]) -> None:
    """Retire ONE broken pool: shut it down and drop it from the registry
    so the next request builds a fresh replacement.  Sibling pools (other
    sizes / start methods) keep their healthy workers."""
    pool = _POOLS.pop(key, None)
    if pool is not None:
        pool.shutdown(wait=False, cancel_futures=True)


def polish_multi(seed: GroupedStrategy, p: int, hw: HardwareModel,
                 nb_data_reload: int = 2, iters: int = 30_000,
                 restarts: int = 4, rng_seed: int = 0,
                 workers: int | None = None) -> GroupedStrategy:
    """Best of ``restarts`` independent polish runs from distinct rng
    streams, fanned out over a process pool (the multi-restart analogue of
    CPLEX running its polishing heuristics in parallel).  Deterministic for
    a fixed ``rng_seed``: the restart seeds are derived from it and the
    argmin over their results does not depend on scheduling order.

    A pool that dies mid-run (``BrokenProcessPool``) is evicted and
    rebuilt once; a second failure falls back to running the same tasks
    serially, so the returned strategy is identical either way."""
    if restarts <= 1:
        return polish(seed, p, hw, nb_data_reload, iters=iters,
                      rng_seed=rng_seed)
    tasks = [(seed, p, hw, nb_data_reload, iters, rng_seed + 1_000_003 * i)
             for i in range(restarts)]
    results = None
    if not _POOLS_FINAL:
        key = _pool_key(workers or min(restarts, os.cpu_count() or 1))
        for _attempt in range(2):
            try:
                results = list(_polish_pool(key).map(_polish_task, tasks))
                break
            except (OSError, concurrent.futures.process.BrokenProcessPool,
                    RuntimeError):
                _evict_pool(key)
    if results is None:
        # fork-restricted environments, a twice-broken pool,
        # or post-atexit: same seeds, serially
        results = [_polish_task(t) for t in tasks]
    return min(results, key=lambda s: (s.objective(hw), s.max_reloads()))


# --------------------------------------------------------------------- #
# HiGHS backend
# --------------------------------------------------------------------- #

def solve_milp(model: ilp_mod.IlpModel, time_limit: float = 60.0):
    """Solve the Sec-5 MILP with HiGHS.  Returns (strategy|None, status,
    objective|None)."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    res = milp(
        c=model.c,
        constraints=LinearConstraint(model.a, model.lb, model.ub),
        integrality=np.ones(model.num_vars),
        bounds=Bounds(0, 1),
        options={"time_limit": time_limit, "presolve": True})
    if res.x is None:
        status = "infeasible" if res.status == 2 else "timeout"
        return None, status, None
    strat = model.extract_groups(np.round(res.x))
    status = "optimal" if res.status == 0 else "feasible"
    return strat, status, float(res.fun)


# --------------------------------------------------------------------- #
# Front door
# --------------------------------------------------------------------- #

def solve(spec: ConvSpec, p: int, hw: HardwareModel,
          nb_data_reload: int = 2,
          size_mem: int | None = None,
          time_limit: float = 30.0,
          polish_iters: int = 30_000,
          milp_var_limit: int = 60_000,
          use_milp: bool = True,
          rng_seed: int = 0,
          polish_restarts: int = 1,
          polish_workers: int | None = None) -> SolveResult:
    """Find the best S1 strategy for ``spec`` on ``hw`` with group size p.

    ``size_mem`` defaults to ``hw.size_mem`` (historically it was only
    forwarded to the MILP when passed explicitly, so heuristic/polished
    incumbents could silently exceed the budget): candidates whose peak
    footprint exceeds the budget are rejected, and ValueError is raised
    when no seed fits at all — shrink ``p`` (``s1_max_feasible_p``) or
    fall back to S2 (``solve_cached`` does both automatically).
    """
    if size_mem is None:
        size_mem = hw.size_mem

    def fits(s: GroupedStrategy) -> bool:
        return size_mem is None or s.peak_footprint_elements() <= size_mem

    k = k_min(spec, p)
    seeds = [row_by_row(spec, p), zigzag(spec, p),
             tiled(spec, p), hilbert(spec, p)]
    mip_start = min(seeds[:2], key=lambda s: s.objective(hw))  # paper's seed
    feasible_seeds = [s for s in seeds if fits(s)]
    if not feasible_seeds:
        raise ValueError(
            f"no S1 strategy with group size {p} fits size_mem={size_mem}")
    incumbent = min(feasible_seeds, key=lambda s: s.objective(hw))

    polished = polish_multi(incumbent, p, hw, nb_data_reload,
                            iters=polish_iters, restarts=polish_restarts,
                            rng_seed=rng_seed, workers=polish_workers)
    if polished.objective(hw) < incumbent.objective(hw) and \
            polished.max_reloads() <= max(nb_data_reload,
                                          incumbent.max_reloads()) and \
            fits(polished):
        incumbent = polished

    milp_status, milp_obj = "skipped", None
    if use_milp:
        model = ilp_mod.build_ilp(spec, p, k=k,
                                  nb_data_reload=nb_data_reload,
                                  size_mem=size_mem)
        if model.num_vars <= milp_var_limit:
            strat, milp_status, raw = solve_milp(model, time_limit)
            if strat is not None:
                milp_obj = strat.objective(hw)
                if milp_obj < incumbent.objective(hw) and fits(strat):
                    incumbent = strat
        else:
            milp_status = "skipped_too_large"

    return SolveResult(
        strategy=incumbent,
        objective=incumbent.objective(hw),
        lower_bound=lower_bound(spec, p, hw),
        seed_objective=mip_start.objective(hw),
        milp_status=milp_status,
        milp_objective=milp_obj,
        polish_objective=polished.objective(hw),
        reload_ok=incumbent.max_reloads() <= nb_data_reload)


# --------------------------------------------------------------------- #
# Memory-feasible solving: S1 with group shrinking, S2 kernel-group
# swapping as the fallback when no S1 group size fits the budget.
# --------------------------------------------------------------------- #

def s1_max_feasible_p(spec: ConvSpec, p: int, hw: HardwareModel) -> int | None:
    """Largest group size ``p' <= p`` whose contiguous (zigzag) S1 strategy
    fits ``hw.size_mem``, or None when S1 is infeasible outright — the
    kernel set Λ plus one patch exceeds the budget, or the PE cannot take
    one full patch row (S1 computes all C_out channels per step)."""
    try:
        hw.nb_patches_max_s1(spec.nb_op_value, spec.c_out)
    except ValueError:
        return None
    if hw.size_mem is None:
        return p
    for cand in range(p, 0, -1):
        if zigzag(spec, cand).peak_footprint_elements() <= hw.size_mem:
            return cand
    return None


def _plan_store():
    """(store, codec) when the persistent plan cache is configured via
    ``REPRO_PLAN_CACHE``, else (None, None).  Lazy on both the env check
    and the import: ``repro_torch.core`` never pulls
    ``repro_torch.plancache`` (or, transitively, ``repro_torch.obs``)
    unless the layer is actually on."""
    if not os.environ.get("REPRO_PLAN_CACHE"):
        return None, None
    from repro_torch.plancache import codec
    from repro_torch.plancache import store as store_mod
    store = store_mod.active_store()
    if store is None:
        return None, None
    return store, codec


def _neighbor_rank(key: dict, p: int, hw: HardwareModel) -> tuple:
    """Scenario distance of a same-family cached key: budget gap first
    (the axis sweeps vary fastest), then group-size gap."""
    mem = key["hw"]["size_mem"]
    d_mem = abs(mem - hw.size_mem) if (
        mem is not None and hw.size_mem is not None) else float("inf")
    return (d_mem, abs(key.get("p", p) - p))


def _warm_s2(res: s2_mod.S2Result, spec: ConvSpec, hw: HardwareModel,
             store, codec, key: dict, fam: str) -> s2_mod.S2Result:
    """Reprice the nearest same-family cached S2 scenarios (same spec,
    neighbouring budget) as warm seeds for the annealing polish; adopt
    only a candidate that is feasible AND strictly cheaper, so the warm
    start can never make a solve worse."""
    if hw.size_mem is None:
        return res
    from repro_torch.plancache.store import CacheCorruptionError
    ranked = sorted(store.neighbors("s2", fam, exclude_key=key),
                    key=lambda kr: _neighbor_rank(kr[0], 0, hw))
    best = res
    for _nkey, raw in ranked[:2]:
        try:
            seed = codec.s2_result_from_json(raw).strategy
        except CacheCorruptionError:
            continue
        if seed.spec != spec:
            continue
        store.warm_considered += 1
        cand = s2_mod.polish_s2(seed, hw, size_mem=hw.size_mem)
        peak = cand.peak_memory_elements()
        if peak > hw.size_mem:
            continue
        obj = cand.objective(hw)
        if obj < best.objective - 1e-9:
            best = dataclasses.replace(
                best, strategy=cand, objective=obj, peak_memory=peak,
                milp_status="warm_start")
            store.warm_adopted += 1
    return best


def _best_s2_impl(spec: ConvSpec, hw: HardwareModel) -> s2_mod.S2Result:
    """``best_s2`` behind the two cache layers (the in-memory LRU is the
    ``best_s2_cached`` binding at the bottom of this module) — the
    planner and the greedy baseline share one S2 search (seed enumeration
    + joint polish + tiny-grid order MILP) per (spec, hw).  On an LRU
    miss the persistent store is consulted; on a store miss the nearest
    cached scenario warm-starts the polish.  Raises ValueError when even
    S2 cannot fit ``hw.size_mem`` (not cached, matching lru_cache)."""
    store, codec = _plan_store()
    if store is None:
        return s2_mod.best_s2(spec, hw)
    key, fam = codec.s2_key(spec, hw)
    hit = store.get("s2", key, fam, codec.s2_result_from_json)
    if hit is not None:
        return hit
    res = _warm_s2(s2_mod.best_s2(spec, hw), spec, hw, store, codec,
                   key, fam)
    store.put("s2", key, fam, codec.s2_result_to_json(res))
    return res


def _s2_fallback_result(spec: ConvSpec, hw: HardwareModel) -> SolveResult:
    res = best_s2_cached(spec, hw)
    return SolveResult(
        strategy=res.strategy,
        objective=res.objective,
        lower_bound=s2_mod.s2_lower_bound(spec, hw),
        seed_objective=(res.seed_objective if res.seed_objective is not None
                        else res.objective),
        milp_status="s2_fallback",
        milp_objective=res.milp_objective,
        polish_objective=res.objective,
        reload_ok=True,
        mode="s2")


# --------------------------------------------------------------------- #
# Solve cache — repeated layers (ResNet stages) are solved once.
# All key components are frozen dataclasses, hence hashable.
# --------------------------------------------------------------------- #

def _s1_seed_full_duration(spec: ConvSpec, q: int, hw: HardwareModel,
                           ) -> float:
    """Cheapest budget-feasible heuristic seed at group size ``q`` under
    full Def-3 accounting (inf when none fits) — the O(num_patches)
    probe the joint (p, strategy) search scans before paying a solve."""
    best = float("inf")
    for make_strategy in (zigzag, row_by_row):
        cand = make_strategy(spec, q)
        if hw.size_mem is not None and \
                cand.peak_footprint_elements() > hw.size_mem:
            continue
        best = min(best, cand.full_duration(hw))
    return best


def _s2_can_beat(spec: ConvSpec, hw: HardwareModel, target: float) -> bool:
    """Analytic precheck: can ANY S2 strategy undercut ``target`` under
    full Def-3 accounting?  S2 writes back (patch, kernel) cells, so its
    duration is bounded below by ``s2_lower_bound`` plus the cell-granular
    write-back — skipping the search when the bound already loses keeps
    the joint search free on layers where S1 dominates."""
    wb = spec.num_patches * spec.c_out * hw.t_w
    return s2_mod.s2_lower_bound(spec, hw) + wb < target


def _solve_fresh(spec: ConvSpec, p: int, hw: HardwareModel,
                 nb_data_reload: int = 2,
                 time_limit: float = 30.0,
                 polish_iters: int = 30_000,
                 use_milp: bool = True,
                 rng_seed: int = 0,
                 polish_restarts: int = 1) -> SolveResult:
    """The cold joint (p, strategy) search — ``solve_cached`` with every
    cache layer peeled off (see ``_solve_cached_impl`` for layering)."""
    p_fit = s1_max_feasible_p(spec, p, hw)
    if p_fit is None:
        return _s2_fallback_result(spec, hw)
    res = solve(spec, p_fit, hw, nb_data_reload=nb_data_reload,
                time_limit=time_limit, polish_iters=polish_iters,
                use_milp=use_milp, rng_seed=rng_seed,
                polish_restarts=polish_restarts)
    if hw.size_mem is None:
        return res
    if res.strategy.peak_footprint_elements() > hw.size_mem:
        return _s2_fallback_result(spec, hw)

    best = res
    best_full = res.strategy.full_duration(hw)

    # (p) dimension: probe smaller group sizes with heuristic seeds; only
    # a probe that already beats the solved incumbent earns a full solve.
    probes = sorted({q for q in (p_fit // 2, p_fit // 4, 1)
                     if 1 <= q < p_fit})
    for q in probes:
        if _s1_seed_full_duration(spec, q, hw) >= best_full:
            continue
        cand = solve(spec, q, hw, nb_data_reload=nb_data_reload,
                     time_limit=time_limit, polish_iters=polish_iters,
                     use_milp=use_milp, rng_seed=rng_seed,
                     polish_restarts=polish_restarts)
        cand_full = cand.strategy.full_duration(hw)
        if cand.strategy.peak_footprint_elements() <= hw.size_mem and \
                cand_full < best_full:
            best, best_full = cand, cand_full

    # (strategy) dimension: the S2 alternative, searched whenever its
    # analytic bound could undercut the incumbent (always when the budget
    # shrank the S1 group — the historical comparison point).
    if p_fit < p or _s2_can_beat(spec, hw, best_full):
        try:
            s2_res = _s2_fallback_result(spec, hw)
        except ValueError:
            return best
        if s2_res.strategy.full_duration(hw) < best_full:
            best = s2_res
    return best


def _warm_solve_result(strat, spec: ConvSpec, hw: HardwareModel,
                       seed_objective: float) -> SolveResult:
    """Wrap an adopted warm-start strategy as a ``SolveResult`` (the
    bound/objective fields re-derived for the *current* scenario)."""
    if isinstance(strat, GroupedStrategy):
        return SolveResult(
            strategy=strat,
            objective=strat.objective(hw),
            lower_bound=lower_bound(spec, strat.max_group_size(), hw),
            seed_objective=seed_objective,
            milp_status="warm_start",
            milp_objective=None,
            polish_objective=strat.objective(hw),
            reload_ok=True,
            mode="s1")
    return SolveResult(
        strategy=strat,
        objective=strat.objective(hw),
        lower_bound=s2_mod.s2_lower_bound(spec, hw),
        seed_objective=seed_objective,
        milp_status="warm_start",
        milp_objective=None,
        polish_objective=strat.objective(hw),
        reload_ok=True,
        mode="s2")


def _adopt_warm_neighbors(best: SolveResult, spec: ConvSpec, p: int,
                          hw: HardwareModel, nb_data_reload: int,
                          polish_iters: int, rng_seed: int,
                          store, codec, key: dict, fam: str) -> SolveResult:
    """Delta re-planning: reprice the nearest same-family cached
    scenarios (same spec + knobs, neighbouring budget / group size) as
    warm seeds — a short polish from the cached strategy instead of a
    full search.  A candidate is adopted only when it is budget- and
    reload-feasible AND strictly cheaper under full Def-3 accounting, so
    warm starts preserve the never-worse property of the cold search."""
    if hw.size_mem is None:
        return best
    from repro_torch.plancache.store import CacheCorruptionError
    ranked = sorted(store.neighbors("solve", fam, exclude_key=key),
                    key=lambda kr: _neighbor_rank(kr[0], p, hw))
    best_full = best.strategy.full_duration(hw)
    for _nkey, raw in ranked[:4]:
        try:
            seed = codec.solve_result_from_json(raw).strategy
        except CacheCorruptionError:
            continue
        if seed.spec != spec:
            continue
        store.warm_considered += 1
        if isinstance(seed, GroupedStrategy):
            if seed.max_group_size() > p:
                continue
            cand = polish(seed, seed.max_group_size(), hw, nb_data_reload,
                          iters=min(polish_iters, 2_000), rng_seed=rng_seed)
            if cand.peak_footprint_elements() > hw.size_mem or \
                    cand.max_reloads() > nb_data_reload:
                continue
        else:
            cand = s2_mod.polish_s2(seed, hw, size_mem=hw.size_mem,
                                    rng_seed=rng_seed)
            if cand.peak_memory_elements() > hw.size_mem:
                continue
        cand_full = cand.full_duration(hw)
        if cand_full < best_full - 1e-9:
            best = _warm_solve_result(cand, spec, hw, best.seed_objective)
            best_full = cand_full
            store.warm_adopted += 1
    return best


def _solve_cached_impl(spec: ConvSpec, p: int, hw: HardwareModel,
                       nb_data_reload: int = 2,
                       time_limit: float = 30.0,
                       polish_iters: int = 30_000,
                       use_milp: bool = True,
                       rng_seed: int = 0,
                       polish_restarts: int = 1) -> SolveResult:
    """Cached memory-feasible solve keyed on (spec, p, hw, ...) — the
    S1/S2 choice is part of the cached entry, so repeated layers resolve
    their fallback once.  ``hw.size_mem`` participates in the key via the
    frozen ``HardwareModel``.

    Two cache layers.  The in-memory LRU (the ``solve_cached`` binding at
    the bottom of this module; maxsize from ``REPRO_SOLVE_CACHE_SIZE``,
    default 256) preserves the historical ``cache_info()`` /
    ``cache_clear()`` semantics.  On an LRU miss, the persistent
    content-hashed store (``repro_torch.plancache``, enabled by
    ``REPRO_PLAN_CACHE``) is consulted: an exact-key hit is returned
    bit-identically; a miss runs the cold search below, then tries the
    nearest same-family cached scenario as a warm seed
    (``_adopt_warm_neighbors``) and persists the winner.

    Selection rule — the joint (p, strategy) search under eq. 12: the
    largest S1 group size that fits the budget is solved; smaller group
    sizes are probed with cheap heuristic seeds and re-solved only when a
    probe undercuts the incumbent; and the S2 kernel-group-swapping
    alternative (seed + polish + tiny-grid MILP) is priced with the same
    full Def-3 accounting whenever its analytic lower bound could win.
    The cheapest feasible candidate is returned, so the result never
    loses to either single-endpoint policy (S1-at-max-p or S2-only) —
    see tests/test_s2_polish.py.  With ``size_mem=None`` (the paper's
    Sec-7.1 setting) the behaviour is unchanged: S1 at the requested
    group size.  ``solve_cached.cache_info()`` exposes the hit counters
    the network planner reports; ``cache_stats()`` snapshots every layer
    at once for per-stage delta attribution."""
    store, codec = _plan_store()
    if store is None:
        return _solve_fresh(spec, p, hw, nb_data_reload=nb_data_reload,
                            time_limit=time_limit,
                            polish_iters=polish_iters, use_milp=use_milp,
                            rng_seed=rng_seed,
                            polish_restarts=polish_restarts)
    key, fam = codec.solve_key(
        spec, p, hw, nb_data_reload=nb_data_reload, time_limit=time_limit,
        polish_iters=polish_iters, use_milp=use_milp, rng_seed=rng_seed,
        polish_restarts=polish_restarts)
    hit = store.get("solve", key, fam, codec.solve_result_from_json)
    if hit is not None:
        return hit
    best = _solve_fresh(spec, p, hw, nb_data_reload=nb_data_reload,
                        time_limit=time_limit, polish_iters=polish_iters,
                        use_milp=use_milp, rng_seed=rng_seed,
                        polish_restarts=polish_restarts)
    best = _adopt_warm_neighbors(best, spec, p, hw, nb_data_reload,
                                 polish_iters, rng_seed, store, codec,
                                 key, fam)
    store.put("solve", key, fam, codec.solve_result_to_json(best))
    return best


# --------------------------------------------------------------------- #
# Cache bindings and observability
# --------------------------------------------------------------------- #

def _resolve_cache_size() -> int | None:
    """LRU maxsize from ``REPRO_SOLVE_CACHE_SIZE`` (default 256; a value
    <= 0 means unbounded).  Sweeps that visit more than maxsize distinct
    (spec, p, hw) keys silently thrash the LRU — the eviction counts in
    the benchmark's ``--profile`` output make that visible, and this knob
    is the fix."""
    raw = os.environ.get("REPRO_SOLVE_CACHE_SIZE", "").strip()
    if not raw:
        return 256
    try:
        size = int(raw)
    except ValueError:
        return 256
    return None if size <= 0 else size


def reconfigure_caches() -> None:    # lint: public-api
    """Rebind ``solve_cached`` / ``best_s2_cached`` with the LRU size
    currently in ``REPRO_SOLVE_CACHE_SIZE``.  Both in-memory caches are
    dropped; the persistent store is untouched.  Callers that captured
    the old binding keep a working (stale-sized) cache — everything that
    resolves ``solver.solve_cached`` as an attribute sees the new one."""
    global solve_cached, best_s2_cached
    size = _resolve_cache_size()
    solve_cached = functools.lru_cache(maxsize=size)(_solve_cached_impl)
    best_s2_cached = functools.lru_cache(maxsize=size)(_best_s2_impl)


solve_cached = functools.lru_cache(maxsize=_resolve_cache_size())(
    _solve_cached_impl)
best_s2_cached = functools.lru_cache(maxsize=_resolve_cache_size())(
    _best_s2_impl)


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Point-in-time snapshot of every planner cache counter, closed
    under subtraction: ``after - before`` is the per-stage delta, which
    is how interleaved stages (solve loop, refine pass, multichip DP,
    resil re-plan) attribute hits without claiming each other's."""
    solve_hits: int = 0
    solve_misses: int = 0
    s2_hits: int = 0
    s2_misses: int = 0
    store_hits: int = 0
    store_misses: int = 0

    def __sub__(self, other: "CacheStats") -> "CacheStats":
        return CacheStats(*(a - b for a, b in
                            zip(dataclasses.astuple(self),
                                dataclasses.astuple(other))))

    @property
    def solve_calls(self) -> int:
        return self.solve_hits + self.solve_misses

    @property
    def s2_calls(self) -> int:
        return self.s2_hits + self.s2_misses


def cache_stats() -> CacheStats:
    """Current counters across both LRUs and the persistent store (zeros
    when the store is disabled).  Snapshot before a stage, subtract
    after."""
    si = solve_cached.cache_info()
    s2i = best_s2_cached.cache_info()
    store, _codec = _plan_store()
    return CacheStats(
        solve_hits=si.hits, solve_misses=si.misses,
        s2_hits=s2i.hits, s2_misses=s2i.misses,
        store_hits=store.hits if store is not None else 0,
        store_misses=store.misses if store is not None else 0)
