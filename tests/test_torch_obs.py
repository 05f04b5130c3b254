"""The port's offload timelines, Perfetto export and drift report
(``repro_torch.obs``) against the JAX package's.

Predicted and simulated timelines are host code with the same float
operations in the same order as the reference's, so their Chrome-trace
JSON and their drift rows must be *equal* to the reference's, on one
chip (``lenet5``, ``resnet8``) and on a cluster (``tight4`` on
``torus2x2``).

The kernel timeline is the port's own design: it walks the planned conv
kernel's thread-block cluster (``analysis.kerncheck``), whose ranks share
each step's fetch.  A layer's ``dma_in`` elements must equal kerncheck's
``fetched_elements`` (what K1's blocks add to its fetch counter) and the
plan's charge.  Its spans equal the reference's wherever the two
emitable plans pick the same runs; only the ``vmem_elements`` counter
differs by design: it is one block's shared memory, not a TPU core's
VMEM.  The rest mirrors ``tests/test_obs.py`` on the port.
"""
import dataclasses
import json

import pytest

from _torch_port import fast_polish_port  # noqa: F401
from repro.analysis import kerncheck as jkerncheck
from repro.configs.networks import NETWORKS as J_NETWORKS
from repro.kernels.emit import emit_layer_kernel as j_emit
from repro.kernels.emit import plan_emitable_network as j_plan_emitable
from repro.obs import adapters as jadapters
from repro.obs import chrome as jchrome
from repro.obs import report as jreport
from repro_torch.analysis import kerncheck, verifier
from repro_torch.configs.clusters import make_cluster
from repro_torch.configs.networks import NETWORKS
from repro_torch.core import strategies_s2 as s2
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import H100_SXM, HardwareModel
from repro_torch.core.multichip import ici_schedule, plan_multichip_network
from repro_torch.core.network_planner import plan_network
from repro_torch.core.strategies import row_by_row, zigzag
from repro_torch.kernels.emit import emit_layer_kernel, plan_emitable_network
from repro_torch.obs import LANES, MetricsRegistry, Timeline
from repro_torch.obs import adapters
from repro_torch.obs import report as obs_report
from repro_torch.obs.chrome import (to_chrome_trace, validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.report import build_report, drift_rows
from repro_torch.sim import ConvLayer
from repro_torch.sim.s2 import run_s2
from repro_torch.sim.system import System
from repro_torch.sim.trace import strategy_timeline

BIG = HardwareModel(nbop_pe=10 ** 9, size_mem=None)
SPEC = ConvSpec(c_in=2, h_in=7, w_in=7, n_kernels=6, h_k=3, w_k=3)
CASES = [("lenet5", None), ("resnet8", None), ("tight4", "torus2x2")]


def _rows(rows):
    return [dataclasses.asdict(r) for r in rows]


def _json(trace):
    return json.dumps(trace, sort_keys=True)


# ------------------------------------------------------------------ #
# Parity: predicted and simulated timelines, drift rows
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("network,topology", CASES,
                         ids=[f"{n}-{t or 'one-chip'}" for n, t in CASES])
def test_timelines_and_drift_rows_equal_the_reference(network, topology):
    kw = dict(topology=topology, iters=60, restarts=1)
    mine = build_report(network, **kw)
    theirs = jreport.build_report(network, **kw)
    assert mine.ok and theirs.ok, mine.render()
    assert mine.n_chips == theirs.n_chips
    assert mine.size_mem == theirs.size_mem
    assert _json(to_chrome_trace(mine.timelines[:2])) == \
        _json(jchrome.to_chrome_trace(theirs.timelines[:2]))
    assert _rows(mine.rows) == _rows(theirs.rows)
    assert _rows(mine.rows) == _rows(drift_rows(*mine.timelines[:2]))
    assert mine.max_drift_elements == 0 and mine.max_drift_cycles == 0.0
    assert mine.trace_valid and mine.lanes_ok
    assert mine.sim_correct and mine.accounting_exact
    assert len(mine.kernel_rows) == len(theirs.kernel_rows) > 0


def test_report_cli_writes_its_trace_under_chiprun_out(tmp_path,
                                                       monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert obs_report.main(["--network", "tight2", "--iters", "60",
                            "--restarts", "1"]) == 0
    out = tmp_path / "chiprun_out" / "obs_trace_tight2.json"
    assert validate_chrome_trace(json.loads(out.read_text())) == []
    assert "RECONCILED" in capsys.readouterr().out


# ------------------------------------------------------------------ #
# The kernel timeline, tied to the cluster trace and the plan
# ------------------------------------------------------------------ #

def _emitable(network, hw=None):
    specs = list(NETWORKS[network])
    return plan_emitable_network(specs, hw or kerncheck.network_budget(specs),
                                 name=network)


@pytest.mark.parametrize("network,budget", [
    ("tight2", "kerncheck"), ("lenet5", "kerncheck"),
    ("resnet8", "kerncheck"), ("tight2", "h100"), ("resnet8", "h100")])
def test_kernel_lane_fetches_what_kerncheck_and_the_plan_count(network,
                                                               budget):
    """Per layer, the ``dma_in`` elements of the kernel lane are what the
    cluster fetches (kerncheck's ``fetched_elements``, which K1's blocks
    add to ``fetched_counter``) and the plan's charge; per step, the
    box's elements plus the Λ the ranks fetch."""
    hw = H100_SXM.as_hardware_model(dtype_bytes=4) if budget == "h100" \
        else None
    plan = _emitable(network, hw)
    tl = adapters.kernel_timeline(plan)
    assert tl.overlap_violations() == []
    for lp in plan.layers:
        trace = kerncheck.build_conv_trace(emit_layer_kernel(lp))
        charge = (lp.strategy.pixels_loaded() * lp.spec.c_in
                  + lp.spec.kernel_elements)
        lane = tl.select(layer=lp.index, chip=0, lane="dma_in")
        assert sum(s.elements for s in lane) == trace.fetched_elements \
            == charge
        assert len(lane) == len(trace.steps)
        for s, st in zip(sorted(lane, key=lambda s: s.step), trace.steps):
            assert s.elements == st.x_load.elements + sum(st.lam_elements)
    assert {s.chip for s in tl.spans} == {0}
    vmem = [c.value for c in tl.counters if c.name == "vmem_elements"]
    assert vmem == [emit_layer_kernel(lp).vmem_elements
                    for lp in plan.layers]


@pytest.mark.parametrize("network", ["lenet5", "resnet8", "tight2",
                                     "tight4"])
def test_kernel_drift_rows_equal_the_reference_where_the_runs_agree(
        network):
    """The port's and the reference's emitable plans pick the same run
    and order on every layer of the registered networks; there the
    kernel lanes, and so the kernel drift rows, are equal.  The one
    field that differs by design is the ``vmem_elements`` counter."""
    plan = _emitable(network)
    jspecs = list(J_NETWORKS[network])
    jplan = j_plan_emitable(jspecs, jkerncheck.network_budget(jspecs),
                            name=network)
    runs = [(emit_layer_kernel(lp).t_run, emit_layer_kernel(lp).order)
            for lp in plan.layers]
    jruns = [(j_emit(lp).t_run, j_emit(lp).order) for lp in jplan.layers]
    same = [a == b for a, b in zip(runs, jruns)]
    assert all(same), f"{network}: runs differ at layers " \
        f"{[i for i, s in enumerate(same) if not s]}"
    kern, jkern = adapters.kernel_timeline(plan), \
        jadapters.kernel_timeline(jplan)
    rows = obs_report.kernel_drift_rows(
        adapters.network_predicted_timeline(plan, label="kernel-plan"),
        kern)
    jrows = jreport.kernel_drift_rows(
        jadapters.network_predicted_timeline(jplan, label="kernel-plan"),
        jkern)
    assert _rows(rows) == _rows(jrows)
    assert all(r.clean and r.first_divergent_step is None for r in rows)
    spans = [e for e in to_chrome_trace([kern])["traceEvents"]
             if e["ph"] != "C"]
    jspans = [e for e in jchrome.to_chrome_trace([jkern])["traceEvents"]
              if e["ph"] != "C"]
    assert spans == jspans


# ------------------------------------------------------------------ #
# tests/test_obs.py, on the port
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("builder,p", [(row_by_row, 3), (zigzag, 5)])
def test_s1_span_sum_equals_verifier_ledger(builder, p):
    strat = builder(SPEC, p)
    tl = strategy_timeline(strat, BIG, layer=0)
    walk = verifier.walk_steps(SPEC, BIG, strat.to_steps())
    assert not walk.aborted
    assert tl.span_sum(layer=0) == walk.total_duration
    for idx, dur in enumerate(walk.durations):
        assert sum(s.dur for s in tl.spans if s.step == idx) == dur


@pytest.mark.parametrize("builder,p,kg", [(s2.kernel_major, 3, 2),
                                          (s2.patch_major, 4, 3)])
def test_s2_span_sum_equals_verifier_ledger(builder, p, kg):
    strat = builder(SPEC, p, kg)
    tl = strategy_timeline(strat, BIG, layer=0)
    walk = verifier.walk_steps(SPEC, BIG, strat.to_steps(),
                               kernel_groups=strat.kernel_groups)
    assert not walk.aborted
    assert tl.span_sum(layer=0) == walk.total_duration
    for idx, dur in enumerate(walk.durations):
        assert sum(s.dur for s in tl.spans if s.step == idx) == dur


def test_simulated_spans_match_predicted_spans_exactly():
    layer = ConvLayer.random(SPEC, seed=3)
    for strat in (zigzag(SPEC, 4), s2.kernel_major(SPEC, 3, 2)):
        pred = strategy_timeline(strat, BIG, layer=0)
        if isinstance(strat, s2.S2Strategy):
            traces = run_s2(layer, BIG, strat).traces
        else:
            traces = System(layer, BIG).run(strat).traces
        sim_tl = Timeline("sim")
        adapters.add_sim_layer(sim_tl, traces, BIG, chip=0, layer=0,
                               t0=0.0)
        for lane in ("dma_in", "compute", "write_back"):
            assert pred.span_sum(layer=0, lane=lane) == \
                sim_tl.span_sum(layer=0, lane=lane)
            assert pred.element_sum(layer=0, lane=lane) == \
                sim_tl.element_sum(layer=0, lane=lane)


def _tight2_cluster_plan(n_chips, topology):
    specs = NETWORKS["tight2"]
    size_mem = max(s.kernel_elements for s in specs) // 2
    cluster = make_cluster(n_chips, size_mem=size_mem, topology=topology)
    return plan_multichip_network(specs, cluster, name="tight2",
                                  polish_iters=60, polish_restarts=1,
                                  include_single_chip_baseline=False)


def test_lanes_never_self_overlap():
    plan = plan_network(NETWORKS["tight2"], BIG, name="tight2",
                        polish_iters=60, polish_restarts=1)
    tl = adapters.network_predicted_timeline(plan)
    assert tl.overlap_violations() == []
    assert tl.end_time == plan.gross_duration
    mtl = adapters.multichip_predicted_timeline(
        _tight2_cluster_plan(2, "ring"))
    assert mtl.overlap_violations() == []
    bad = Timeline("t")
    bad.add_span("a", "compute", 0, 0.0, 2.0)
    bad.add_span("b", "compute", 0, 1.0, 2.0)
    bad.add_span("c", "compute", 1, 1.0, 2.0)
    assert len(bad.overlap_violations()) == 1


def test_multichip_ici_spans_reconcile_with_ici_schedule():
    plan = _tight2_cluster_plan(4, "torus2x2")
    per_layer, final = ici_schedule(
        [lp.spec for lp in plan.layers],
        [lp.mode for lp in plan.layers],
        [lp.active_chips for lp in plan.layers], plan.cluster)
    tl = adapters.multichip_predicted_timeline(plan)
    for lp, elems in zip(plan.layers, per_layer):
        assert lp.ici_elements == elems
        spans = tl.select(layer=lp.index, lane="ici")
        if elems == 0:
            assert spans == []
            continue
        assert len(spans) == len(lp.shards)
        assert all(s.elements == elems and s.dur == lp.ici_duration
                   for s in spans)
    gather = [s for s in tl.select(lane="ici") if s.layer is None]
    assert sum(s.elements for s in gather) == \
        final * (len(plan.layers[-1].shards) if final else 0)


def test_chrome_trace_validates_and_mutations_are_caught(tmp_path):
    tl = strategy_timeline(zigzag(SPEC, 4), BIG, layer=0)
    trace = to_chrome_trace([tl])
    assert validate_chrome_trace(trace) == []
    path = tmp_path / "trace.json"
    write_chrome_trace(trace, str(path))
    assert validate_chrome_trace(json.loads(path.read_text())) == []
    assert trace["otherData"]["generator"] == "repro.obs"

    def mutated(fn):
        t = json.loads(json.dumps(trace))
        fn(t["traceEvents"])
        return validate_chrome_trace(t)

    def first_x(evs):
        return next(e for e in evs if e["ph"] == "X")

    assert mutated(lambda evs: evs[0].update(ph="Q"))
    assert mutated(lambda evs: evs[-1].pop("pid"))
    assert mutated(lambda evs: first_x(evs).update(cat="warp_drive"))
    assert mutated(lambda evs: first_x(evs).update(ts=-1.0))


def test_chrome_trace_covers_all_lanes_per_chip():
    tl = adapters.multichip_predicted_timeline(
        _tight2_cluster_plan(2, "ring"))
    trace = to_chrome_trace([tl])
    assert validate_chrome_trace(trace) == []
    name_of = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
               if e["ph"] == "M" and e["name"] == "process_name"}
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    for chip in tl.chips():
        pids = {pid for pid, n in name_of.items()
                if n.endswith(f"chip{chip}")}
        assert {"dma_in", "compute", "write_back"} <= \
            {e["cat"] for e in xs if e["pid"] in pids}


def test_drift_rows_attribute_divergence_to_first_step():
    pred = strategy_timeline(zigzag(SPEC, 4), BIG, layer=0)
    tampered = Timeline("tampered")
    victim = None
    for s in pred.spans:
        if victim is None and s.lane == "dma_in" and s.step == 2:
            victim = s
            tampered.add_span(s.name, s.lane, s.chip, s.t0, s.dur + 1.0,
                              layer=s.layer, step=s.step,
                              elements=s.elements + 7)
        else:
            tampered.extend([s])
    assert victim is not None
    rows = drift_rows(pred, tampered)
    bad = [r for r in rows if not r.clean]
    assert bad and all(r.lane == "dma_in" for r in bad)
    assert {r.first_divergent_step for r in rows} == {2}
    assert max(r.drift_elements for r in bad) == 7


def test_metrics_registry_and_monotone_traffic_counters():
    reg = MetricsRegistry()
    reg.incr("a/b", 2)
    reg.incr("a/b", 3)
    reg.set("a/c/d", 1.23456)
    snap = reg.snapshot()
    assert snap["a"]["b"] == 5 and snap["a"]["c"]["d"] == 1.2346
    plan = plan_network(NETWORKS["tight2"], BIG, name="tight2",
                        polish_iters=60, polish_restarts=1)
    tl = adapters.network_predicted_timeline(plan)
    reads = [c.value for c in tl.counters
             if c.name == "dram_read_elements"]
    assert reads == sorted(reads) and reads[-1] > 0
    assert any(e["ph"] == "C" for e in to_chrome_trace([tl])["traceEvents"])
    assert len(LANES) == 6
