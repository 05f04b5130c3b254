"""Planner-as-a-service: sweep-query plan serving over the persistent cache.

``python -m repro_torch.launch.plan_server`` answers full
budget x topology x chip-count sweep queries for the registered networks.
Every per-layer solve goes through ``solver.solve_cached``'s two cache
layers — the in-memory LRU and, when a cache directory is given (the
``--cache-dir`` flag or the ``REPRO_PLAN_CACHE`` env var), the
content-hashed on-disk store from ``repro_torch.plancache`` — so a warm server
answers a full sweep in seconds where a cold planner takes minutes, and
bit-identically: an exact-key store hit replays the recorded strategy,
and near-miss scenarios (same layers, neighbouring budget) warm-start
the polish instead of searching from scratch.

Every served plan is re-checked against the ``repro_torch.analysis`` verifier
postconditions (``verify=False`` only skips the planner's *internal*
check; the service always runs its own unless constructed with
``verify=False``), and every row carries its cache attribution
(solver calls / LRU hits / store hits) plus a ``plan_fingerprint`` so
callers can prove warm answers identical to cold ones.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.plan_server \
        --network tight4 --budgets auto --topologies ring torus2x2 \
        --chips 1 4 --cache-dir /tmp/plancache --out sweep.json

Exit code 0 iff at least one scenario is feasible and every feasible
plan passed the verifier.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Sequence

from repro_torch.configs.clusters import make_cluster, torus_dims
from repro_torch.configs.networks import NETWORKS
from repro_torch.configs.tight import budget_points
from repro_torch.core import solver as solver_mod
from repro_torch.core.cost_model import Topology
from repro_torch.core.multichip import plan_multichip_network
from repro_torch.core.network_planner import InfeasibleNetworkError
from repro_torch.obs.metrics import REGISTRY
from repro_torch.plancache import codec as codec_mod
from repro_torch.plancache import store as store_mod


@dataclasses.dataclass(frozen=True)
class PlanQuery:
    """One scenario: a network on a concrete cluster under a budget."""

    network: str
    size_mem: int | None = None
    topology: str = "ring"
    n_chips: int = 1
    nbop_pe: int = 10 ** 9
    polish_iters: int = 600
    polish_restarts: int = 1
    rng_seed: int = 0


def resolve_topology(topology: str, n_chips: int) -> str | None:
    """Concrete topology label for a sweep point, or None when the
    combination does not exist (a torus needs a 2-D grid of exactly
    ``n_chips``; ``torus`` auto-picks the squarest).  One chip has no
    links, so every wiring resolves to the same ``ring`` point there
    (deduped by :meth:`PlanService.sweep`)."""
    if n_chips == 1:
        return "ring"
    if topology in ("ring", "biring"):
        return topology
    if topology == "torus":
        dims = torus_dims(n_chips)
        return None if dims is None else f"torus{dims[0]}x{dims[1]}"
    ny, nx = Topology.parse(topology).dims
    return topology if ny * nx == n_chips else None


class PlanService:
    """The query API behind the CLI — importable for in-process use
    (tests, the benchmark's cold/warm canary)."""

    def __init__(self, cache_dir: "str | None" = None, *,
                 verify: bool = True) -> None:
        if cache_dir is not None:
            store_mod.configure(cache_dir)
        self.verify = verify

    def query(self, q: PlanQuery) -> dict[str, Any]:
        """Plan one scenario and return a serializable row: the plan's
        headline numbers, a content fingerprint of its decisions, and
        this query's own cache-attribution window."""
        if q.network not in NETWORKS:
            raise KeyError(f"unknown network {q.network!r}; "
                           f"registered: {sorted(NETWORKS)}")
        REGISTRY.incr("plan_server/queries")
        stats0 = solver_mod.cache_stats()
        t0 = time.perf_counter()
        cluster = make_cluster(q.n_chips, nbop_pe=q.nbop_pe,
                               size_mem=q.size_mem, topology=q.topology)
        base: dict[str, Any] = {
            "network": q.network, "size_mem": q.size_mem,
            "topology": q.topology, "n_chips": q.n_chips,
        }
        try:
            plan = plan_multichip_network(
                NETWORKS[q.network], cluster, name=q.network,
                polish_iters=q.polish_iters,
                polish_restarts=q.polish_restarts, rng_seed=q.rng_seed,
                include_single_chip_baseline=False, verify=False)
        except InfeasibleNetworkError as e:
            delta = solver_mod.cache_stats() - stats0
            return {**base, "feasible": False, "error": str(e),
                    "verified": False,
                    "planning_seconds": round(time.perf_counter() - t0, 4),
                    "solver_calls": delta.solve_calls,
                    "cache_hits": delta.solve_hits,
                    "store_hits": delta.store_hits,
                    "store_misses": delta.store_misses}
        verified = False
        if self.verify:
            from repro_torch.analysis.verifier import assert_verified
            assert_verified(plan)
            verified = True
        delta = solver_mod.cache_stats() - stats0
        return {
            **base,
            "feasible": True,
            "verified": verified,
            "total_duration": plan.total_duration,
            "layer_modes": [lp.mode for lp in plan.layers],
            "mode_string": plan.mode_string,
            "fingerprint": codec_mod.plan_fingerprint(plan),
            "planning_seconds": round(time.perf_counter() - t0, 4),
            "solver_calls": delta.solve_calls,
            "cache_hits": delta.solve_hits,
            "store_hits": delta.store_hits,
            "store_misses": delta.store_misses,
        }

    def sweep(self, network: str, *,
              budgets: Sequence[int],
              topologies: Sequence[str] = ("ring",),
              chip_counts: Sequence[int] = (1,),
              nbop_pe: int = 10 ** 9,
              polish_iters: int = 600,
              polish_restarts: int = 1,
              rng_seed: int = 0) -> list[dict[str, Any]]:
        """The full budget x topology x chips grid for ``network``.
        Non-existent (topology, n_chips) combinations are skipped and
        duplicate resolutions (every wiring at 1 chip is ``ring``) are
        answered once."""
        rows: list[dict[str, Any]] = []
        for n_chips in chip_counts:
            seen: set[str] = set()
            for topo in topologies:
                label = resolve_topology(topo, n_chips)
                if label is None or label in seen:
                    continue
                seen.add(label)
                for size_mem in budgets:
                    rows.append(self.query(PlanQuery(
                        network=network, size_mem=size_mem,
                        topology=label, n_chips=n_chips,
                        nbop_pe=nbop_pe, polish_iters=polish_iters,
                        polish_restarts=polish_restarts,
                        rng_seed=rng_seed)))
                    REGISTRY.incr("plan_server/scenarios")
        return rows

    def cache_stats(self) -> dict[str, Any]:
        """Both layers' counters: the LRUs plus the persistent store
        (``store: None`` when no cache directory is configured)."""
        info = solver_mod.solve_cached.cache_info()
        s2 = solver_mod.best_s2_cached.cache_info()
        store = store_mod.active_store()
        return {
            "lru": {
                "solve_cached": {"hits": info.hits, "misses": info.misses,
                                 "currsize": info.currsize},
                "best_s2_cached": {"hits": s2.hits, "misses": s2.misses,
                                   "currsize": s2.currsize},
            },
            "store": store.stats() if store is not None else None,
        }


def _parse_budgets(raw: "list[str]", network: str) -> list[int]:
    if raw == ["auto"]:
        return budget_points(NETWORKS[network])
    return [int(v) for v in raw]


def main(argv: "Sequence[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.plan_server",
        description="Answer plan sweep queries from the persistent "
                    "plan cache (repro_torch.plancache).")
    ap.add_argument("--network", nargs="*", default=sorted(NETWORKS),
                    help="networks to sweep (default: all registered)")
    ap.add_argument("--budgets", nargs="+", default=["auto"],
                    help="'auto' (the tight budget_points grid) or "
                         "explicit size_mem values")
    ap.add_argument("--topologies", nargs="+", default=["ring"],
                    help="ring | biring | torusRxC | torus (auto-dims)")
    ap.add_argument("--chips", nargs="+", type=int, default=[1],
                    help="chip counts for the sweep grid")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent plan-cache directory (defaults to "
                         "the REPRO_PLAN_CACHE env var; omit both for "
                         "in-memory caching only)")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--restarts", type=int, default=1)
    ap.add_argument("--rng-seed", type=int, default=0)
    ap.add_argument("--nbop-pe", type=int, default=10 ** 9)
    ap.add_argument("--out", default=None, help="write the sweep JSON here")
    args = ap.parse_args(argv)

    service = PlanService(args.cache_dir)
    t0 = time.perf_counter()
    sweeps: list[dict[str, Any]] = []
    for network in args.network:
        rows = service.sweep(
            network, budgets=_parse_budgets(args.budgets, network),
            topologies=args.topologies, chip_counts=args.chips,
            nbop_pe=args.nbop_pe, polish_iters=args.iters,
            polish_restarts=args.restarts, rng_seed=args.rng_seed)
        sweeps.append({"network": network, "rows": rows})
        feas = [r for r in rows if r["feasible"]]
        hits = sum(r["cache_hits"] + r["store_hits"] for r in rows)
        calls = sum(r["solver_calls"] for r in rows)
        print(f"[plan_server] {network}: {len(feas)}/{len(rows)} "
              f"scenarios feasible, {calls} solver calls, "
              f"{hits} cache hits (LRU + store)")

    result: dict[str, Any] = {
        "sweeps": sweeps,
        "wall_seconds": round(time.perf_counter() - t0, 4),
        "cache": service.cache_stats(),
    }
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=2, sort_keys=True)
        print(f"[plan_server] wrote {args.out}")

    all_rows = [r for s in sweeps for r in s["rows"]]
    feasible = [r for r in all_rows if r["feasible"]]
    ok = bool(feasible) and all(r["verified"] for r in feasible)
    print(f"[plan_server] {len(feasible)}/{len(all_rows)} feasible, "
          f"all verified: {ok}, wall {result['wall_seconds']}s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
