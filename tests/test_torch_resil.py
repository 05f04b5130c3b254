"""The port's fault injection and recovery (``repro_torch.resil``, with
``runtime.fault_tolerance`` as its control plane) against the JAX
package's.

The engine runs the same numpy simulator as the reference, to the bit,
so a faulted run of the same network, cluster and schedule gives the
same committed bytes and the same ledger: its ``fingerprint`` must equal
the reference's.  Each parity case also checks exactly-once write counts
and the recoveries the case forces.  ``faultsim.main``'s JSON must equal
the reference's; it has no wall-clock field.  The rest mirrors
``tests/test_resil_basic.py`` and ``tests/test_resil.py`` on the port;
``tests/test_fault_tolerance.py`` runs as it is against the port's
``runtime.fault_tolerance``.
"""
import inspect
import json

import numpy as np
import pytest

import test_fault_tolerance
from _torch_port import fast_polish_port  # noqa: F401
from repro.configs.clusters import make_cluster as j_make_cluster
from repro.configs.networks import NETWORKS as J_NETWORKS
from repro.resil import faults as jfaults
from repro.resil import faultsim as j_faultsim
from repro.resil.engine import run_faulted as j_run_faulted
from repro_torch.configs.clusters import make_cluster
from repro_torch.configs.networks import NETWORKS
from repro_torch.core.cost_model import Topology
from repro_torch.core.multichip import plan_multichip_network, replan_suffix
from repro_torch.obs.adapters import (faulted_timeline,
                                      multichip_predicted_timeline)
from repro_torch.obs.chrome import to_chrome_trace, validate_chrome_trace
from repro_torch.obs.report import (fault_attribution_rows,
                                    fault_overhead_by_lane)
from repro_torch.resil import faults, faultsim
from repro_torch.resil.controller import ControlPlaneError, RecoveryController
from repro_torch.resil.degrade import (repriced_cluster, shrunk_cluster,
                                       surviving_cluster, surviving_topology)
from repro_torch.resil.engine import run_faulted
from repro_torch.resil.faults import (ChipDeath, ClusterExhaustedError,
                                      DmaTransient, FaultSchedule,
                                      FaultScheduleError, LinkDegrade,
                                      VmemShrink)
from repro_torch.runtime import fault_tolerance
from repro_torch.sim.layer import ConvLayer
from repro_torch.sim.multichip import (carve_shard, run_shard,
                                       simulate_multichip)

FAST = dict(polish_iters=60, polish_restarts=1)


def _cluster(network="tight2", topology="ring", n=2, mc=make_cluster,
             nets=NETWORKS):
    size_mem = max(s.kernel_elements for s in nets[network]) // 2
    return mc(n, size_mem=size_mem, topology=topology)


def _run(network, topology, n_chips, schedule, **kw):
    return run_faulted(NETWORKS[network],
                       _cluster(network, topology, n_chips), schedule,
                       name=network, **{**FAST, **kw})


# ------------------------------------------------------------------ #
# Parity: the same faulted run, to the bit
# ------------------------------------------------------------------ #

def _events(mod, events):
    return tuple(getattr(mod, kind)(**kw) for kind, kw in events)


CASES = {
    "chip-death-resnet8-ring4": (
        "resnet8", "ring", 4, [("ChipDeath", dict(layer=2, chip=1))]),
    "mixed-lenet5-torus2x2": ("lenet5", "torus2x2", 4, "mixed"),
    "dma-transient-tight4-torus2x2": (
        "tight4", "torus2x2", 4,
        [("DmaTransient", dict(layer=0, chip=1, step=1, retries=2))]),
    "chip-death-tight4-torus2x2": (
        "tight4", "torus2x2", 4, [("ChipDeath", dict(layer=1, chip=2))]),
    "link-degrade-tight4-torus2x2": (
        "tight4", "torus2x2", 4,
        [("LinkDegrade", dict(layer=1, factor=3.0))]),
    "vmem-shrink-tight4-torus2x2": (
        "tight4", "torus2x2", 4,
        [("VmemShrink", dict(layer=1, factor=0.75))]),
    "link-degrade-and-death-tight4-torus2x2": (
        "tight4", "torus2x2", 4,
        [("LinkDegrade", dict(layer=0, factor=2.0)),
         ("ChipDeath", dict(layer=1, chip=1))]),
    "skipped-events-tight2-ring2": (
        "tight2", "ring", 2,
        [("ChipDeath", dict(layer=0, chip=9)),
         ("DmaTransient", dict(layer=1, chip=7, step=0, retries=1)),
         ("LinkDegrade", dict(layer=99, factor=2.0))]),
}


def _schedule(fmod, fsim, network, n_chips, events):
    if events == "mixed":
        return fsim.build_schedule("mixed", 0,
                                   n_layers=len(NETWORKS[network]),
                                   n_chips=n_chips)
    return fmod.FaultSchedule(seed=0, events=_events(fmod, events))


def _both(name, **kw):
    network, topology, n_chips, events = CASES[name]
    mine = run_faulted(
        NETWORKS[network], _cluster(network, topology, n_chips),
        _schedule(faults, faultsim, network, n_chips, events),
        name=network, verify=True, **{**FAST, **kw})
    theirs = j_run_faulted(
        J_NETWORKS[network],
        _cluster(network, topology, n_chips, j_make_cluster, J_NETWORKS),
        _schedule(jfaults, j_faultsim, network, n_chips, events),
        name=network, verify=True, **{**FAST, **kw})
    return mine, theirs


@pytest.mark.parametrize("name", sorted(CASES))
def test_faulted_run_fingerprint_equals_the_reference(name):
    mine, theirs = _both(name)
    assert mine.fingerprint == theirs.fingerprint
    assert mine.ok and theirs.ok, mine.findings
    assert mine.write_counts_ok and mine.recovery_exact
    assert all(c is not None and not np.any(np.isnan(c))
               for c in mine.committed)
    for a, b in zip(mine.committed, theirs.committed):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert mine.faulted_duration == theirs.faulted_duration
    assert mine.baseline_duration == theirs.baseline_duration
    assert [(r.kind, r.layer, r.n_chips, r.new_topology, r.verified)
            for r in mine.recoveries] == \
        [(r.kind, r.layer, r.n_chips, r.new_topology, r.verified)
         for r in theirs.recoveries]
    assert [(a.layer, a.wasted, a.phys_chips) for a in mine.attempts] == \
        [(a.layer, a.wasted, a.phys_chips) for a in theirs.attempts]
    assert mine.skipped_events == theirs.skipped_events
    assert mine.summary() == theirs.summary()
    kinds = {r.kind for r in mine.recoveries}
    if "chip-death" in name or name.startswith("mixed"):
        assert "chip_death" in kinds
        assert sum(a.wasted for a in mine.attempts) == 1
    if "dma-transient" in name:
        assert not mine.recoveries and mine.retry_cycles > 0
        assert mine.faulted_duration == pytest.approx(
            mine.baseline_duration + mine.retry_cycles)
    if name.startswith("skipped"):
        assert not mine.recoveries and len(mine.skipped_events) == 3


def test_injected_corruption_is_caught_like_the_reference():
    mine, theirs = _both("skipped-events-tight2-ring2",
                         inject_corruption=1)
    assert mine.fingerprint == theirs.fingerprint
    assert mine.findings == theirs.findings
    assert not mine.ok and not mine.recovery_exact
    assert not mine.write_counts_ok
    assert any("exactly-once" in f for f in mine.findings)
    assert any("diverged" in f for f in mine.findings)


@pytest.mark.parametrize("argv", [
    ["--network", "tight2", "--topology", "ring", "--n-chips", "2",
     "--scenario", "dma-transient"],
    ["--network", "lenet5", "--topology", "torus2x2", "--scenario",
     "mixed"],
], ids=["tight2-ring2-dma-transient", "lenet5-torus2x2-mixed"])
def test_faultsim_json_equals_the_reference(tmp_path, capsys, argv):
    argv = argv + ["--seed", "0", "--iters", "60", "--restarts", "1",
                   "--json"]
    assert j_faultsim.main(argv + ["--out", str(tmp_path / "j.json")]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert faultsim.main(argv + ["--out", str(tmp_path / "t.json")]) == 0
    mine = json.loads(capsys.readouterr().out)
    assert mine == theirs
    assert mine["ok"] and mine["exactly_once"] and mine["recovery_exact"]
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def test_faultsim_cli_exit_codes(tmp_path, capsys):
    out = str(tmp_path / "trace.json")
    argv = ["--network", "tight2", "--topology", "ring", "--n-chips",
            "2", "--seed", "0", "--scenario", "dma-transient",
            "--iters", "40", "--restarts", "1", "--out", out]
    assert faultsim.main(argv) == 0
    assert "faultsim: OK" in capsys.readouterr().out
    assert faultsim.main(argv + ["--inject-corruption", "0"]) == 1
    assert "FINDING" in capsys.readouterr().err


def test_faultsim_default_trace_lands_in_chiprun_out(tmp_path,
                                                     monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert faultsim.main(["--network", "tight2", "--topology", "ring",
                          "--n-chips", "2", "--scenario", "dma-transient",
                          "--iters", "40", "--restarts", "1"]) == 0
    assert (tmp_path / "chiprun_out" / "faultsim_tight2_ring.json").exists()
    assert "chiprun_out/" in capsys.readouterr().out


@pytest.mark.parametrize("scenario", faultsim.SCENARIOS)
def test_build_schedule_equals_the_reference(scenario):
    mine = faultsim.build_schedule(scenario, 7, n_layers=4, n_chips=4)
    theirs = j_faultsim.build_schedule(scenario, 7, n_layers=4, n_chips=4)
    assert mine.describe() == theirs.describe()
    assert mine == faultsim.build_schedule(scenario, 7, n_layers=4,
                                           n_chips=4)
    if scenario == "mixed":
        assert {type(e) for e in mine.events} == \
            {ChipDeath, LinkDegrade, DmaTransient}


# ------------------------------------------------------------------ #
# tests/test_resil_basic.py, on the port
# ------------------------------------------------------------------ #

def test_faulted_run_fingerprint_is_reproducible():
    sch = FaultSchedule.random(3, n_layers=2, n_chips=2, n_events=2)
    runs = [run_faulted(NETWORKS["tight2"], _cluster(), sch,
                        name="tight2", **FAST) for _ in range(2)]
    assert runs[0].fingerprint == runs[1].fingerprint
    for a, b in zip(runs[0].committed, runs[1].committed):
        assert np.array_equal(a, b)


def test_different_seed_changes_schedule():
    a = FaultSchedule.random(0, n_layers=4, n_chips=4, n_events=3)
    b = FaultSchedule.random(0, n_layers=4, n_chips=4, n_events=3)
    c = FaultSchedule.random(1, n_layers=4, n_chips=4, n_events=3)
    assert a == b
    assert a.events != c.events
    assert "seed=0" in a.describe()
    assert a.describe() == jfaults.FaultSchedule.random(
        0, n_layers=4, n_chips=4, n_events=3).describe()


def test_fault_free_schedule_reproduces_the_plain_simulation():
    specs = NETWORKS["tight2"]
    cluster = _cluster()
    rep = run_faulted(specs, cluster, FaultSchedule(seed=0, events=()),
                      name="tight2", **FAST)
    assert rep.ok and not rep.recoveries
    assert rep.faulted_duration == pytest.approx(rep.baseline_duration)
    plan = plan_multichip_network(specs, cluster, name="tight2",
                                  include_single_chip_baseline=False,
                                  **FAST)
    sim = simulate_multichip(plan, seed=0)
    assert plan.total_duration == pytest.approx(rep.baseline_duration)
    assert sim.correct and sim.accounting_exact


def test_retry_injection_reconciles_exactly():
    specs = NETWORKS["tight2"]
    cluster = _cluster()
    plan = plan_multichip_network(specs, cluster, name="tight2",
                                  include_single_chip_baseline=False,
                                  **FAST)
    lp = plan.layers[0]
    full = ConvLayer.random(lp.spec, seed=0)
    shard = next(s for s in lp.shards if s.mode == "s1")
    base = run_shard(full, shard, cluster.chip)
    retried = run_shard(full, shard, cluster.chip,
                        retry_at={0: 2}, backoff_base=16.0)
    assert np.array_equal(base.output, retried.output)
    assert retried.retry_duration > 0
    assert retried.total_duration == pytest.approx(
        base.total_duration + retried.retry_duration)
    assert retried.elements_read == \
        base.elements_read + retried.retry_elements
    assert carve_shard(full, shard).spec == shard.spec


def test_degraded_cluster_constructors():
    cluster = _cluster("tight4", "torus2x2", 4)
    surv = surviving_cluster(cluster)
    assert surv.n_chips == 3 and surv.topo.kind == "ring"
    assert repriced_cluster(cluster, 2.0).t_ici == cluster.t_ici * 2.0
    shrunk = shrunk_cluster(cluster, 0.5)
    assert shrunk.chip.size_mem == cluster.chip.size_mem // 2
    one = surviving_cluster(_cluster(), n_dead=1)
    assert one.n_chips == 1
    with pytest.raises(ClusterExhaustedError):
        surviving_cluster(one)


def test_replan_suffix_plans_the_tail_only():
    specs = NETWORKS["tight4"]
    cluster = _cluster("tight4", "torus2x2", 4)
    tail = replan_suffix(specs, cluster, start=2, name="tight4", **FAST)
    assert len(tail.layers) == 2
    assert [lp.spec for lp in tail.layers] == list(specs[2:])
    with pytest.raises(ValueError):
        replan_suffix(specs, cluster, start=4, name="tight4", **FAST)


def test_recovery_ledger_is_deterministic_pricing():
    sch = FaultSchedule(seed=0, events=(ChipDeath(layer=1, chip=0),),
                        detection_cycles=128.0,
                        replan_cycles_per_layer=32.0)
    specs = NETWORKS["tight2"]
    rep = run_faulted(specs, _cluster(), sch, name="tight2", **FAST)
    (rec,) = rep.recoveries
    assert rec.replan_cycles == 32.0 * (len(specs) - 1)
    spec = specs[1]
    assert rec.restage_cycles == pytest.approx(
        spec.num_pixels * spec.c_in * rep.plans[1].cluster.chip.t_l)
    (wasted,) = [a for a in rep.attempts if a.wasted]
    assert wasted.detection == 128.0
    assert rep.faulted_duration == pytest.approx(
        sum(a.total for a in rep.attempts)
        + sum(r.total for r in rep.recoveries)
        + rep.plans[-1].final_gather_duration)


def test_dma_backoff_is_exponential():
    def run(retries):
        sch = FaultSchedule(seed=0, events=(
            DmaTransient(layer=0, chip=0, step=0, retries=retries),),
            backoff_base_cycles=16.0)
        return run_faulted(NETWORKS["tight2"], _cluster(), sch,
                           name="tight2", **FAST)
    b1 = run(1).retry_cycles - 16.0 * 1
    b3 = run(3).retry_cycles - 16.0 * 7
    assert b1 > 0 and b3 == pytest.approx(3 * b1)


# ------------------------------------------------------------------ #
# tests/test_resil.py, on the port
# ------------------------------------------------------------------ #

def test_chip_death_recovers_on_degraded_topology():
    sch = FaultSchedule(seed=0, events=(ChipDeath(layer=1, chip=2),))
    rep = _run("tight4", "torus2x2", 4, sch)
    assert rep.ok and rep.no_free_lunch
    (wasted,) = [a for a in rep.attempts if a.wasted]
    assert wasted.dead_chip == 2
    assert wasted.detection == sch.detection_cycles
    (rec,) = rep.recoveries
    assert rec.kind == "chip_death" and rec.n_chips == 3
    assert "ring" in rec.new_topology
    assert rec.restage_elements > 0 and rec.verified
    assert rec.elastic.hosts == (0, 1, 3)
    assert rep.recomputed_elements == \
        NETWORKS["tight4"][1].num_patches * NETWORKS["tight4"][1].c_out


def test_boundary_faults_replan_without_recompute():
    deg = _run("tight4", "torus2x2", 4, FaultSchedule(
        seed=0, events=(LinkDegrade(layer=1, factor=3.0),)))
    assert deg.ok and not any(a.wasted for a in deg.attempts)
    (rec,) = deg.recoveries
    assert rec.kind == "link_degrade" and rec.restage_cycles > 0
    assert deg.recomputed_elements == 0
    assert deg.plans[1].cluster.t_ici == deg.plans[0].cluster.t_ici * 3.0
    assert deg.faulted_duration >= deg.baseline_duration - 1e-6
    shr = _run("tight4", "torus2x2", 4, FaultSchedule(
        seed=0, events=(VmemShrink(layer=1, factor=0.75),)))
    assert shr.ok and shr.recoveries[0].kind == "vmem_shrink"
    assert shr.plans[1].cluster.chip.size_mem == \
        int(shr.plans[0].cluster.chip.size_mem * 0.75)
    both = _run("tight4", "torus2x2", 4, FaultSchedule(
        seed=0, events=(LinkDegrade(layer=2, factor=2.0),
                        VmemShrink(layer=2, factor=0.9))))
    assert both.ok and len(both.recoveries) == 1
    assert both.recoveries[0].kind == "link_degrade+vmem_shrink"


def test_cluster_exhausted_raises():
    sch = FaultSchedule(seed=0, events=(ChipDeath(layer=0, chip=1),
                                        ChipDeath(layer=1, chip=0)))
    with pytest.raises(ClusterExhaustedError):
        _run("tight2", "ring", 2, sch)


def test_schedule_validation():
    for bad in (LinkDegrade(layer=0, factor=0.5),
                VmemShrink(layer=0, factor=1.5),
                ChipDeath(layer=-1, chip=0),
                DmaTransient(layer=0, chip=0, step=0, retries=0)):
        with pytest.raises(FaultScheduleError):
            FaultSchedule(seed=0, events=(bad,))


def test_random_schedule_keeps_a_survivor():
    for seed in range(6):
        sch = FaultSchedule.random(seed, n_layers=4, n_chips=2,
                                   n_events=5)
        assert sum(isinstance(e, ChipDeath) for e in sch.events) <= 1


def test_surviving_topology_prefers_sub_torus():
    torus = Topology.parse("torus2x4")
    assert surviving_topology(torus, 4).kind == "torus"
    assert surviving_topology(torus, 7).kind == "ring"
    assert surviving_topology(torus, 3).kind == "ring"
    assert surviving_topology(Topology.parse("ring"), 3).kind == "ring"


def test_controller_detects_exactly_the_dead_chip():
    rc = RecoveryController([0, 1, 2, 3], detection_cycles=100.0)
    rc.advance(500.0)
    rc.stage_done([0, 1, 3], stage=0, durations={0: 5.0, 1: 5.0, 3: 9.0})
    rc.advance(100.0)
    rc.expect_death(2)
    assert rc.dead == [2]
    assert rc.detect_dead() == []
    rc.advance(50.0)
    rc.stage_done([0, 1, 3], stage=1, durations={})
    assert rc.detect_dead() == []


def test_controller_cross_check_mismatch_raises():
    rc = RecoveryController([0, 1], detection_cycles=10.0)
    rc.advance(100.0)
    with pytest.raises(ControlPlaneError):
        rc.expect_death(0)
    rc2 = RecoveryController([0, 1], detection_cycles=10.0)
    rc2.stage_done([0, 1], stage=0, durations={})
    with pytest.raises(ControlPlaneError):
        rc2.expect_death(1)
    with pytest.raises(ControlPlaneError):
        rc2.advance(-1.0)


def test_controller_elastic_plan_over_survivors():
    plan = RecoveryController([0, 1, 2, 3]).elastic_plan([3, 0, 1])
    assert plan.hosts == (0, 1, 3)
    assert plan.data_shards == 3 and plan.model_shards == 1
    assert plan.shard_of_host == {0: 0, 1: 1, 3: 2}


def test_faulted_timeline_exports_valid_trace_with_fault_lanes():
    sch = FaultSchedule(seed=0, events=(
        ChipDeath(layer=1, chip=2),
        DmaTransient(layer=2, chip=0, step=0, retries=1)))
    rep = _run("tight4", "torus2x2", 4, sch)
    assert rep.ok
    pred = multichip_predicted_timeline(rep.plans[0])
    tl = faulted_timeline(rep)
    assert any(s.lane == "fault" for s in tl.spans)
    assert any(s.lane == "recovery" for s in tl.spans)
    assert validate_chrome_trace(to_chrome_trace([pred, tl])) == []
    overhead = fault_overhead_by_lane(fault_attribution_rows(pred, tl))
    assert overhead["recovery"] == pytest.approx(rep.recovery_cycles)
    assert overhead["fault"] > 0


# ------------------------------------------------------------------ #
# tests/test_fault_tolerance.py, as it is, on the port's control plane
# ------------------------------------------------------------------ #

_FT_TESTS = sorted(name for name, fn in vars(test_fault_tolerance).items()
                   if name.startswith("test_") and inspect.isfunction(fn))


@pytest.mark.parametrize("name", _FT_TESTS)
def test_fault_tolerance_case_on_the_port(monkeypatch, name):
    """Each case of the reference's control-plane tests, with its ``ft``
    module swapped for the port's."""
    assert test_fault_tolerance.ft is not fault_tolerance
    monkeypatch.setattr(test_fault_tolerance, "ft", fault_tolerance)
    getattr(test_fault_tolerance, name)()
