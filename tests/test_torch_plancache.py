"""The port's persistent plan cache (``repro_torch.plancache``) and plan
server (``repro_torch.launch.plan_server``) against the JAX package's.

The key format is the reference's byte for byte: the same solves write
entry files with the same names and the same bytes, in two temporary
directories.  Corruption and schema recovery leave both stores with the
same counters.  The plan server's sweep JSON equals the reference's
apart from wall-clock fields, and a warm pass after a restart is served
from the store with the same plan fingerprints.

Both packages read the one ``REPRO_PLAN_CACHE`` variable, so each test
points it at one package's directory at a time.
"""
import dataclasses
import json
import os
import threading

import pytest

from _torch_port import fast_polish_port  # noqa: F401
from repro.core import solver as jsolver
from repro.core.conv_spec import ConvSpec as JConvSpec
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.core.network_planner import plan_network as j_plan_network
from repro.configs.networks import NETWORKS as J_NETWORKS
from repro.launch import plan_server as j_plan_server
from repro.plancache import codec as jcodec
from repro.plancache import store as jstore_mod
from repro_torch.configs.clusters import make_cluster
from repro_torch.configs.networks import NETWORKS
from repro_torch.configs.tight import budget_points
from repro_torch.core import solver
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import H100_SXM, TPU_V5E, HardwareModel
from repro_torch.core.multichip import plan_multichip_network
from repro_torch.core.network_planner import plan_network
from repro_torch.launch import plan_server
from repro_torch.launch.plan_server import (PlanQuery, PlanService,
                                            resolve_topology)
from repro_torch.obs.metrics import REGISTRY
from repro_torch.plancache import (CacheCorruptionError, CacheSchemaError,
                                   PlanStore)
from repro_torch.plancache import codec
from repro_torch.plancache import store as store_mod
from repro_torch.resil.engine import RecoveryAction, run_faulted
from repro_torch.resil.faults import ChipDeath, FaultSchedule

SPEC = ConvSpec(3, 10, 10, 4, 3, 3)
HW = HardwareModel(nbop_pe=10 ** 9, size_mem=600)
TIGHT = HardwareModel(nbop_pe=10 ** 9, size_mem=60)
KNOBS = dict(polish_iters=200, use_milp=False)
_WALL = ("planning_seconds", "wall_seconds", "root")

PORT = (solver, store_mod, ConvSpec, HardwareModel, plan_network, NETWORKS)
REF = (jsolver, jstore_mod, JConvSpec, JHardwareModel, j_plan_network,
       J_NETWORKS)


def _clear(*solvers):
    for s in solvers:
        s.solve_cached.cache_clear()
        s.best_s2_cached.cache_clear()


@pytest.fixture
def env_restored():
    """Restore ``REPRO_PLAN_CACHE`` and empty every cache layer of both
    packages afterwards."""
    prev = os.environ.get(store_mod.ENV_VAR)
    _clear(solver, jsolver)
    yield
    if prev is None:
        os.environ.pop(store_mod.ENV_VAR, None)
    else:
        os.environ[store_mod.ENV_VAR] = prev
    store_mod.reset()
    jstore_mod.reset()
    _clear(solver, jsolver)


@pytest.fixture
def plan_cache(tmp_path, env_restored):
    """A throwaway store of the port."""
    yield store_mod.configure(tmp_path / "cache")


def _restart(pkg=PORT):
    """In-process stand-in for a process restart: both LRUs emptied and
    the store object (with its counters) rebuilt from the env."""
    _clear(pkg[0])
    pkg[1].reset()
    return pkg[1].active_store()


def _entry_files(store):
    return sorted(store.root.glob("*.json"))


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(root.glob("*.json"))}


def _strip_wall(obj):
    if isinstance(obj, dict):
        return {k: _strip_wall(v) for k, v in obj.items() if k not in _WALL}
    if isinstance(obj, list):
        return [_strip_wall(v) for v in obj]
    return obj


# ------------------------------------------------------------------ #
# Entry files: byte-identical to the reference's
# ------------------------------------------------------------------ #

def _solve_s1(pkg):
    s, _, spec_t, hw_t, _, _ = pkg
    s.solve_cached(spec_t(3, 10, 10, 4, 3, 3), 4,
                   hw_t(nbop_pe=10 ** 9, size_mem=600), **KNOBS)


def _solve_s2(pkg):
    s, _, spec_t, hw_t, _, _ = pkg
    s.best_s2_cached(spec_t(3, 10, 10, 4, 3, 3),
                     hw_t(nbop_pe=10 ** 9, size_mem=60))


def _plan_tight2(pkg):
    _, _, _, hw_t, plan, nets = pkg
    specs = nets["tight2"]
    plan(specs, hw_t(nbop_pe=10 ** 9,
                     size_mem=max(s.kernel_elements for s in specs)),
         name="tight2", polish_iters=60, polish_restarts=1)


@pytest.mark.parametrize("solve", [_solve_s1, _solve_s2, _plan_tight2],
                         ids=["s1-solve", "s2-solve", "tight2-plan"])
def test_entry_files_are_byte_identical_to_the_reference(tmp_path,
                                                         env_restored,
                                                         solve):
    for pkg, sub in ((REF, "ref"), (PORT, "port")):
        pkg[1].configure(tmp_path / sub)
        _clear(pkg[0])
        solve(pkg)
    mine, theirs = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert mine and list(mine) == list(theirs)
    assert mine == theirs


# ------------------------------------------------------------------ #
# Keys
# ------------------------------------------------------------------ #

def test_default_equivalent_keys_collide():
    bare_key, bare_fam = codec.solve_key(SPEC, 4, HW)
    full_key, full_fam = codec.solve_key(
        SPEC, 4, HW, nb_data_reload=2, time_limit=30.0,
        polish_iters=30_000, use_milp=True, rng_seed=0, polish_restarts=1)
    assert bare_key == full_key and bare_fam == full_fam
    assert store_mod.canonical_digest(bare_key) == \
        store_mod.canonical_digest(full_key)


@pytest.mark.parametrize("kind", ["solve", "s2"])
def test_keys_and_digests_equal_the_reference(kind):
    jspec, jhw = JConvSpec(3, 10, 10, 4, 3, 3), \
        JHardwareModel(nbop_pe=10 ** 9, size_mem=600)
    if kind == "solve":
        mine, theirs = codec.solve_key(SPEC, 4, HW, **KNOBS), \
            jcodec.solve_key(jspec, 4, jhw, **KNOBS)
    else:
        mine, theirs = codec.s2_key(SPEC, HW), jcodec.s2_key(jspec, jhw)
    assert mine == theirs
    assert store_mod.canonical_digest(mine[0]) == \
        jstore_mod.canonical_digest(theirs[0])


def test_family_digest_groups_budget_and_p_neighbors():
    _, fam = codec.solve_key(SPEC, 4, HW, **KNOBS)
    _, fam_mem = codec.solve_key(
        SPEC, 4, dataclasses.replace(HW, size_mem=900), **KNOBS)
    _, fam_p = codec.solve_key(SPEC, 2, HW, **KNOBS)
    assert fam == fam_mem == fam_p
    _, fam_knob = codec.solve_key(SPEC, 4, HW, polish_iters=100,
                                  use_milp=False)
    _, fam_spec = codec.solve_key(ConvSpec(3, 12, 12, 4, 3, 3), 4, HW,
                                  **KNOBS)
    assert fam_knob != fam and fam_spec != fam


def test_unknown_knob_rejected():
    with pytest.raises(TypeError):
        codec.solve_key(SPEC, 4, HW, not_a_knob=1)


def test_h100_and_tpu_v5e_never_share_a_key(tmp_path):
    """``hw_key`` holds the cost model's own constants, so a plan priced
    for the H100 and one priced for the TPU v5e land in different
    entries, and neither is served for the other."""
    h100, v5e = H100_SXM.as_hardware_model(), TPU_V5E.as_hardware_model()
    assert codec.hw_key(h100) != codec.hw_key(v5e)
    k_h, fam_h = codec.solve_key(SPEC, 4, h100, **KNOBS)
    k_v, fam_v = codec.solve_key(SPEC, 4, v5e, **KNOBS)
    assert store_mod.canonical_digest(k_h) != \
        store_mod.canonical_digest(k_v)
    assert fam_h != fam_v
    store = PlanStore(tmp_path / "hw")
    store.put("solve", k_h, fam_h, {"mark": "h100"})
    assert store.get("solve", k_v, fam_v, decode=lambda d: d) is None
    assert store.get("solve", k_h, fam_h, decode=lambda d: d) == \
        {"mark": "h100"}
    assert store.neighbors("solve", fam_v) == []


def test_neighbor_ranking_prefers_closest_budget():
    key_near = {"spec": codec.spec_key(SPEC), "p": 4,
                "hw": {**codec.hw_key(HW), "size_mem": 590}, "knobs": {}}
    key_far = {"spec": codec.spec_key(SPEC), "p": 4,
               "hw": {**codec.hw_key(HW), "size_mem": 60}, "knobs": {}}
    ranked = sorted([key_far, key_near],
                    key=lambda k: solver._neighbor_rank(k, 4, HW))
    assert ranked[0] is key_near


# ------------------------------------------------------------------ #
# Cold/warm round-trip
# ------------------------------------------------------------------ #

def test_cold_warm_restart_round_trip_bit_identical(plan_cache):
    cold = solver.solve_cached(SPEC, 4, HW, **KNOBS)
    assert plan_cache.misses == 1 and plan_cache.writes == 1
    store = _restart()
    warm = solver.solve_cached(SPEC, 4, HW, **KNOBS)
    assert store.hits == 1 and store.misses == 0
    assert warm == cold
    assert warm.strategy == cold.strategy


def test_s2_round_trip_under_sub_kernel_budget(plan_cache):
    assert TIGHT.size_mem < SPEC.kernel_elements
    cold = solver.best_s2_cached(SPEC, TIGHT)
    _restart()
    warm = solver.best_s2_cached(SPEC, TIGHT)
    assert warm == cold
    assert warm.strategy.kernel_groups == cold.strategy.kernel_groups
    assert warm.strategy.schedule == cold.strategy.schedule


def test_lru_hit_never_touches_store(plan_cache):
    solver.solve_cached(SPEC, 4, HW, **KNOBS)
    before = plan_cache.stats()
    solver.solve_cached(SPEC, 4, HW, **KNOBS)
    assert plan_cache.stats() == before


def test_disabled_without_env(tmp_path, env_restored):
    store_mod.configure(None)
    assert store_mod.active_store() is None
    assert solver._plan_store() == (None, None)
    solver.solve_cached(SPEC, 4, HW, **KNOBS)
    assert not list(tmp_path.rglob("*.json"))


# ------------------------------------------------------------------ #
# Corruption recovery, held against the reference's counters
# ------------------------------------------------------------------ #

def _truncate(path):
    path.write_text(path.read_text()[: 40])


def _garbage(path):
    payload = json.loads(path.read_text())
    payload["result"]["strategy"]["groups"] = [[999999]]
    path.write_text(json.dumps(payload))


def _schema_bump(path):
    payload = json.loads(path.read_text())
    payload["schema"] = store_mod.SCHEMA_VERSION + 1
    path.write_text(json.dumps(payload))


def _damage_and_resolve(pkg, root, damage):
    """Solve, damage the one entry, restart and solve again: the
    recovered result, the store's counters and the typed error the
    damaged file raised."""
    s, smod, spec_t, hw_t, _, _ = pkg
    store = smod.configure(root)
    _clear(s)
    spec, hw = spec_t(3, 10, 10, 4, 3, 3), hw_t(nbop_pe=10 ** 9,
                                               size_mem=600)
    cold = s.solve_cached(spec, 4, hw, **KNOBS)
    (path,) = sorted(store.root.glob("*.json"))
    damage(path)
    try:
        store.load_entry(path)
        error = None
    except smod.CacheCorruptionError as e:
        error = (type(e).__name__, e.path == str(path))
    store = _restart(pkg)
    again = s.solve_cached(spec, 4, hw, **KNOBS)
    (fresh,) = sorted(store.root.glob("*.json"))
    return (cold.objective, again.objective, error,
            {k: v for k, v in store.stats().items() if k != "root"},
            json.loads(fresh.read_text())["schema"])


@pytest.mark.parametrize("damage", [_truncate, _garbage, _schema_bump],
                         ids=["truncated", "garbage", "schema-mismatch"])
def test_recovery_from_a_damaged_entry_matches_the_reference(
        tmp_path, env_restored, damage):
    mine = _damage_and_resolve(PORT, tmp_path / "port", damage)
    theirs = _damage_and_resolve(REF, tmp_path / "ref", damage)
    assert mine == theirs
    cold, again, error, stats, schema = mine
    assert again == cold                       # re-solved, not crashed
    assert stats["hits"] == 0 and schema == store_mod.SCHEMA_VERSION
    if damage is _truncate:
        assert error == ("CacheCorruptionError", True)
        assert stats["corruptions"] == 1 and stats["evictions"] == 1
    elif damage is _schema_bump:
        assert error == ("CacheSchemaError", True)
        assert stats["stale"] == 1


def test_truncated_entry_raises_the_typed_error(plan_cache):
    solver.solve_cached(SPEC, 4, HW, **KNOBS)
    (path,) = _entry_files(plan_cache)
    _truncate(path)
    with pytest.raises(CacheCorruptionError) as ei:
        plan_cache.load_entry(path)
    assert not isinstance(ei.value, CacheSchemaError)


def test_concurrent_writers_atomic(tmp_path):
    store = PlanStore(tmp_path / "race")
    key, fam = codec.s2_key(SPEC, HW)
    results = [{"v": i, "blob": "x" * 5000} for i in range(8)]
    threads = [threading.Thread(
        target=store.put, args=("s2", key, fam, {"result": r}))
        for r in results]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert store.writes == 8
    (path,) = _entry_files(store)
    payload = store.load_entry(path)
    assert payload["key"] == key
    assert payload["result"] in [{"result": r} for r in results]
    assert not list(store.root.glob("*.tmp"))


def test_neighbor_warm_start_considered_and_never_worse(plan_cache):
    solver.solve_cached(SPEC, 4, HW, **KNOBS)
    neighbor = HardwareModel(nbop_pe=10 ** 9, size_mem=560)
    store = _restart()
    res = solver.solve_cached(SPEC, 4, neighbor, **KNOBS)
    assert store.warm_considered >= 1
    fresh = solver._solve_fresh(SPEC, 4, neighbor, **KNOBS)
    assert res.strategy.full_duration(neighbor) <= \
        fresh.strategy.full_duration(neighbor) + 1e-9
    assert res.strategy.peak_footprint_elements() <= 560


# ------------------------------------------------------------------ #
# The plan server
# ------------------------------------------------------------------ #

def test_resolve_topology_grid():
    assert resolve_topology("ring", 1) == "ring"
    assert resolve_topology("torus2x2", 1) == "ring"
    assert resolve_topology("torus2x2", 4) == "torus2x2"
    assert resolve_topology("torus2x2", 3) is None
    assert resolve_topology("torus", 4) == "torus2x2"
    assert resolve_topology("biring", 4) == "biring"


def test_sweep_dedups_single_chip_wirings(plan_cache):
    budgets = budget_points(NETWORKS["tight2"])[-1:]
    rows = PlanService().sweep("tight2", budgets=budgets,
                               topologies=("ring", "torus2x2", "biring"),
                               chip_counts=(1,), polish_iters=50)
    assert len(rows) == len(budgets)
    assert all(r["topology"] == "ring" and r["n_chips"] == 1 for r in rows)


def test_unknown_network_rejected():
    with pytest.raises(KeyError):
        PlanService().query(PlanQuery(network="nope"))


def test_query_verified_row_with_attribution(plan_cache):
    svc = PlanService()
    q = PlanQuery(network="tight2",
                  size_mem=budget_points(NETWORKS["tight2"])[-1],
                  polish_iters=50)
    row = svc.query(q)
    assert row["feasible"] and row["verified"] and row["solver_calls"] >= 1
    row2 = svc.query(q)
    assert row2["fingerprint"] == row["fingerprint"]
    assert row2["cache_hits"] >= 1


def _cli_sweep(module, pkg, root, out):
    pkg[1].reset()
    _clear(pkg[0])
    budgets = [str(b) for b in budget_points(NETWORKS["tight2"])[-2:]]
    rc = module.main(["--network", "tight2", "--budgets", *budgets,
                      "--topologies", "torus2x2", "--chips", "1", "4",
                      "--iters", "50", "--cache-dir", str(root),
                      "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_sweep_json_equals_the_reference_and_warm_pass_hits(
        tmp_path, env_restored, capsys):
    """The CLI's sweep JSON, cold, equals the reference's apart from
    wall-clock fields; the cache directories hold the same bytes; a warm
    pass after a restart is served from the store (no miss, no solver
    search) with the same fingerprints."""
    rc_j, theirs = _cli_sweep(j_plan_server, REF, tmp_path / "ref",
                              tmp_path / "ref.json")
    rc, mine = _cli_sweep(plan_server, PORT, tmp_path / "port",
                          tmp_path / "port.json")
    assert rc == rc_j == 0
    assert _strip_wall(mine) == _strip_wall(theirs)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    rows = mine["sweeps"][0]["rows"]
    assert {(r["topology"], r["n_chips"]) for r in rows} == \
        {("ring", 1), ("torus2x2", 4)}
    rc, warm = _cli_sweep(plan_server, PORT, tmp_path / "port",
                          tmp_path / "warm.json")
    assert rc == 0
    warm_rows = warm["sweeps"][0]["rows"]
    assert [r["fingerprint"] for r in warm_rows if r["feasible"]] == \
        [r["fingerprint"] for r in rows if r["feasible"]]
    assert sum(r["store_hits"] for r in warm_rows) >= 1
    assert all(r["store_misses"] == 0 for r in warm_rows)
    assert warm["cache"]["store"]["writes"] == 0
    assert "plan_server" in capsys.readouterr().out


# ------------------------------------------------------------------ #
# tests/test_cache_attribution.py, on the port
# ------------------------------------------------------------------ #

_STAGES = ("solve", "refine", "baseline", "multichip", "single_baseline",
           "resil_replan")


def _stage_snapshot():
    return {s: (REGISTRY.get(f"planner/stage/{s}/calls"),
                REGISTRY.get(f"planner/stage/{s}/hits")) for s in _STAGES}


def _stage_delta(before):
    after = _stage_snapshot()
    return {s: (after[s][0] - before[s][0], after[s][1] - before[s][1])
            for s in _STAGES}


def _tight2_ring2():
    specs = NETWORKS["tight2"]
    return specs, make_cluster(
        2, size_mem=max(s.kernel_elements for s in specs) // 2)


def test_multichip_attribution_excludes_single_baseline():
    specs, cluster = _tight2_ring2()
    _clear(solver)
    before = _stage_snapshot()
    plan = plan_multichip_network(specs, cluster, name="tight2",
                                  include_single_chip_baseline=True,
                                  verify=False, polish_iters=60,
                                  polish_restarts=1)
    d = _stage_delta(before)
    assert d["multichip"] == (plan.solver_calls, plan.cache_hits)
    assert plan.solver_calls >= 1
    assert d["single_baseline"][0] >= 1
    assert plan.single_chip_duration is not None


def test_network_planner_stage_split_sums_to_plan_totals():
    specs = NETWORKS["tight2"]
    hw = HardwareModel(nbop_pe=10 ** 9,
                       size_mem=max(s.kernel_elements for s in specs) * 2)
    _clear(solver)
    before = _stage_snapshot()
    plan = plan_network(specs, hw, name="tight2", polish_iters=60,
                        polish_restarts=1)
    d = _stage_delta(before)
    assert d["solve"][0] + d["refine"][0] == plan.solver_calls
    assert d["solve"][1] + d["refine"][1] == plan.cache_hits
    assert d["solve"][0] == len(specs)
    assert d["multichip"] == (0, 0) and d["single_baseline"] == (0, 0)


def test_recovery_action_carries_its_own_solver_window():
    fields = {f.name for f in dataclasses.fields(RecoveryAction)}
    assert {"solver_calls", "cache_hits"} <= fields
    specs, cluster = _tight2_ring2()
    before = _stage_snapshot()
    rep = run_faulted(specs, cluster, FaultSchedule(
        seed=0, events=(ChipDeath(layer=1, chip=1),)),
        name="tight2", polish_iters=60, polish_restarts=1)
    d = _stage_delta(before)
    replans = [r for r in rep.recoveries if r.kind == "chip_death"]
    assert replans and all(r.solver_calls >= 1 for r in replans)
    assert sum(r.solver_calls for r in replans) == d["resil_replan"][0]
    assert sum(r.cache_hits for r in replans) == d["resil_replan"][1]
