"""The cases of ``tests/test_cache_attribution.py``, read on
``repro_torch`` with the same inputs and settings. The reference's
docstring follows.

Per-stage cache attribution: interleaved
planning stages must each report their own solve window — the
single-chip baseline no longer claims (or is claimed by) the
multichip DP's hits, and degraded re-plans carry their own counters.
"""
import dataclasses

from repro_torch.configs.clusters import make_cluster
from repro_torch.configs.networks import NETWORKS
from repro_torch.core import solver
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.multichip import plan_multichip_network
from repro_torch.core.network_planner import plan_network
from repro_torch.obs.metrics import REGISTRY
from repro_torch.resil.engine import RecoveryAction, run_faulted
from repro_torch.resil.faults import ChipDeath, FaultSchedule
from _torch_port import fast_polish_port  # noqa: F401

FAST = dict(polish_iters=60, polish_restarts=1)

STAGES = ("solve", "refine", "baseline", "multichip", "single_baseline",
          "resil_replan")


def _stage_snapshot():
    return {s: (REGISTRY.get(f"planner/stage/{s}/calls"),
                REGISTRY.get(f"planner/stage/{s}/hits"))
            for s in STAGES}


def _delta(before, after):
    return {s: (after[s][0] - before[s][0], after[s][1] - before[s][1])
            for s in STAGES}


def test_multichip_attribution_excludes_single_baseline():
    """plan.solver_calls / plan.cache_hits must be the DP's own window;
    the single-chip baseline's solves land in their own stage counter
    instead of inflating (or stealing hits from) the DP's."""
    specs = NETWORKS["tight2"]
    size_mem = max(s.kernel_elements for s in specs) // 2
    cluster = make_cluster(2, size_mem=size_mem)
    solver.solve_cached.cache_clear()
    solver.best_s2_cached.cache_clear()
    before = _stage_snapshot()
    plan = plan_multichip_network(specs, cluster, name="tight2",
                                  include_single_chip_baseline=True,
                                  verify=False, **FAST)
    d = _delta(before, _stage_snapshot())
    assert d["multichip"] == (plan.solver_calls, plan.cache_hits)
    assert plan.solver_calls >= 1
    # the baseline ran, and its window is separate from the DP's
    assert d["single_baseline"][0] >= 1
    assert plan.single_chip_duration is not None


def test_network_planner_stage_split_sums_to_plan_totals():
    """The solve pass and the refinement loop each get a delta window;
    their sum is exactly what the plan reports, and the S2 baseline
    stage is tracked on its own axis."""
    specs = NETWORKS["tight2"]
    hw = HardwareModel(nbop_pe=10 ** 9,
                       size_mem=max(s.kernel_elements for s in specs) * 2)
    solver.solve_cached.cache_clear()
    solver.best_s2_cached.cache_clear()
    before = _stage_snapshot()
    plan = plan_network(specs, hw, name="tight2", **FAST)
    d = _delta(before, _stage_snapshot())
    assert d["solve"][0] + d["refine"][0] == plan.solver_calls
    assert d["solve"][1] + d["refine"][1] == plan.cache_hits
    assert d["solve"][0] == len(specs)
    # the DP/baseline stages of *other* planners stayed silent
    assert d["multichip"] == (0, 0) and d["single_baseline"] == (0, 0)


def test_recovery_action_carries_its_own_solver_window():
    """A chip death forces a degraded re-plan; the RecoveryAction must
    report that re-plan's own solver calls, not the run's cumulative
    planner traffic."""
    fields = {f.name for f in dataclasses.fields(RecoveryAction)}
    assert {"solver_calls", "cache_hits"} <= fields
    specs = NETWORKS["tight2"]
    size_mem = max(s.kernel_elements for s in specs) // 2
    cluster = make_cluster(2, size_mem=size_mem)
    before = _stage_snapshot()
    rep = run_faulted(specs, cluster,
                      FaultSchedule(seed=0, events=(
                          ChipDeath(layer=1, chip=1),)),
                      name="tight2", **FAST)
    d = _delta(before, _stage_snapshot())
    replans = [r for r in rep.recoveries if r.kind == "chip_death"]
    assert replans
    assert sum(r.solver_calls for r in replans) == d["resil_replan"][0]
    assert sum(r.cache_hits for r in replans) == d["resil_replan"][1]
    assert all(r.solver_calls >= 1 for r in replans)
