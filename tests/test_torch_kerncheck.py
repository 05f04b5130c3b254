"""The port's kernel contract checker (``repro_torch.analysis.kerncheck``):
the cluster trace of every emitted K1 layer is contract-equivalent to its
plan, the K3/K4 and K5 schedules check clean, every rule is provoked by a
seeded mutation, and the port checks the same layers and steps as the JAX
package's checker on every registered network.

The first part mirrors ``tests/test_kerncheck.py`` case by case.  A
mutation of the JAX package's single-core trace has a counterpart in the
port's cluster trace: its dropped DMA wait is the compute warps' dropped
wait on a ring slot's ``full`` mbarrier (the pushes into the slot are
still in flight), and its extra DMA wait (a semaphore that never
signals) an extra cluster-barrier wait (a phase that never completes).
The second part holds the mutations only a cluster kernel has.
"""
import copy
import dataclasses
import json

import pytest

from _torch_port import fast_polish_port  # noqa: F401
from repro.analysis import kerncheck as jkerncheck
from repro.configs.networks import NETWORKS as J_NETWORKS
from repro.kernels import emit as jemit
from repro_torch.analysis import access, kerncheck
from repro_torch.analysis.kerncheck import (
    build_conv_trace, check_block_matmul, check_conv_trace, check_decode,
    check_decode_trace, check_network, decode_walk, network_budget, run_all)
from repro_torch.configs.networks import NETWORKS
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import H100_SXM
from repro_torch.kernels.emit import (KernelEmitError, emit_layer_kernel,
                                      plan_emitable_network)

SPECS = [ConvSpec(2, 8, 8, 3, 3, 3), ConvSpec(3, 6, 6, 4, 3, 3)]
# 32 kernel channels and runs of 8 output columns: a K1 cluster of 4 x 2
# blocks (8 channels, 4 columns each); 2 tiles per row, so the sweep has
# column deltas, row turns and both ring slots
CLUSTER_SPECS = [ConvSpec(3, 8, 10, 32, 3, 3)]

# Registered-network layers where the port plans another t_run than the
# JAX package at kerncheck's budget, with the reason.  None today: the
# port's grid_solve budgets the plan's peak as the reference does, and its
# per-block occupancy (a 1/cs share of Λ, no output blocks) fits wherever
# the reference's does.
T_RUN_DIFFERS: dict[tuple[str, int], str] = {}


def _trace_of(specs, layer=0, dtype="float32"):
    hw = network_budget(specs)
    plan = plan_emitable_network(specs, hw, name="mini")
    lp = plan.layers[layer]
    return build_conv_trace(emit_layer_kernel(lp), dtype), lp.strategy, \
        hw.size_mem


@pytest.fixture(scope="module")
def emitted_layer():
    """(trace, strategy, budget) of a real emitted layer, to mutate."""
    return _trace_of(SPECS)


@pytest.fixture(scope="module")
def cluster_layer():
    """The same for a layer that runs on a cluster of 4 blocks."""
    trace, strategy, budget = _trace_of(CLUSTER_SPECS)
    assert trace.cs == 8 and trace.cluster == (4, 2)
    assert {st.dst for st in trace.steps} == {"window", "slot0", "slot1"}
    return trace, strategy, budget


def _rules(diags):
    return {d.rule for d in diags}


def _kinds(diags):
    return {dict(d.data)["kind"] for d in diags if d.rule == "kern/hazard"}


def _shift_box(region: access.Region, axis: int, by: int) -> access.Region:
    box = list(region.box)
    lo, hi = box[axis]
    box[axis] = (lo + by, hi + by)
    return access.Region(region.tensor, tuple(box))


def _check(trace, strategy, budget):
    return check_conv_trace(trace, strategy, budget, layer=0)


# --------------------------------------------------------------------- #
# Positive: every registered network proves clean
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_registered_network_checks_clean(name):
    report = check_network(name)
    assert report.ok, report.render()
    assert report.checked_layers == len(NETWORKS[name])
    assert report.checked_steps > 0


def test_clean_trace_has_no_diagnostics(emitted_layer):
    trace, strategy, budget = emitted_layer
    assert _check(trace, strategy, budget) == []


def test_run_all_covers_networks_and_standalone_kernels():
    report = run_all(["tight2"])
    assert report.ok, report.render()
    assert report.checked_layers == len(NETWORKS["tight2"])


def test_cli_exit_codes(capsys):
    assert kerncheck.main(["--network", "tight2"]) == 0
    assert "OK" in capsys.readouterr().out
    assert kerncheck.main(["--network", "tight2", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is True


# --------------------------------------------------------------------- #
# Seeded mutations: one per rule, each caught with the precise rule id
# --------------------------------------------------------------------- #

def test_shifted_dma_region_fires_step_islice(emitted_layer):
    trace, strategy, budget = emitted_layer
    bad = copy.deepcopy(trace)
    k = len(bad.steps) // 2
    bad.steps[k] = dataclasses.replace(
        bad.steps[k], x_load=_shift_box(bad.steps[k].x_load, 2, 1))
    assert "kern/step-islice" in _rules(_check(bad, strategy, budget))


def test_shifted_window_fires_residency(emitted_layer):
    trace, strategy, budget = emitted_layer
    bad = copy.deepcopy(trace)
    bad.steps[1] = dataclasses.replace(
        bad.steps[1], window=_shift_box(bad.steps[1].window, 1, 1))
    assert "kern/residency" in _rules(_check(bad, strategy, budget))


def test_shifted_output_block_fires_write_back(emitted_layer):
    trace, strategy, budget = emitted_layer
    bad = copy.deepcopy(trace)
    bad.steps[2] = dataclasses.replace(
        bad.steps[2], out=bad.steps[0].out)        # double-writes block 0
    assert "kern/write-back" in _rules(_check(bad, strategy, budget))


def test_double_write_breaks_write_once_coverage(emitted_layer):
    trace, strategy, budget = emitted_layer
    bad = copy.deepcopy(trace)
    bad.steps[3] = dataclasses.replace(bad.steps[3], out=bad.steps[0].out)
    diags = _check(bad, strategy, budget)
    cover = [d for d in diags if d.rule == "kern/write-back"
             and "write-once" in d.message]
    assert cover and dict(cover[0].data)["missing"] > 0
    assert dict(cover[0].data)["multi"] > 0


def test_dropped_wait_fires_hazard(emitted_layer):
    """The compute warps' wait on the ring slot of step 1 dropped: they
    splice the slot while the service warp's store into it is unordered
    with their reads."""
    trace, strategy, budget = emitted_layer
    bad = copy.deepcopy(trace)
    bad.events = [e for e in bad.events
                  if not (isinstance(e, access.MbarWait)
                          and e.agent.role == "compute" and e.step == 1)]
    assert len(bad.events) == len(trace.events) - 1
    assert _kinds(_check(bad, strategy, budget)) & {"raw", "war", "waw",
                                                    "leak"}


def test_extra_wait_fires_lost_wait(emitted_layer):
    trace, strategy, budget = emitted_layer
    bad = copy.deepcopy(trace)
    waits = [i for i, e in enumerate(bad.events)
             if isinstance(e, access.ClusterWait)]
    last = bad.events[waits[-1]]
    bad.events.insert(waits[-1] + 1,
                      access.ClusterWait(last.agent, last.step))
    assert "lost-wait" in _kinds(_check(bad, strategy, budget))


def test_oversized_occupancy_fires_vmem(emitted_layer):
    trace, strategy, budget = emitted_layer
    bad = copy.deepcopy(trace)
    bad.vmem_elements = budget + 1
    diags = [d for d in _check(bad, strategy, budget)
             if d.rule == "kern/vmem"]
    assert diags and dict(diags[0].data)["budget"] == budget


def test_extra_traffic_fires_conservation(emitted_layer):
    trace, strategy, budget = emitted_layer
    bad = copy.deepcopy(trace)
    lam = list(bad.steps[1].lam_elements)
    lam[0] += 5
    bad.steps[1] = dataclasses.replace(bad.steps[1], lam_elements=tuple(lam))
    assert _rules(_check(bad, strategy, budget)) == {"kern/traffic"}


def test_emit_failure_becomes_diagnostic(monkeypatch):
    def boom(lp):
        raise KernelEmitError(f"layer {lp.index}: no kernel")
    monkeypatch.setattr(kerncheck, "emit_layer_kernel", boom)
    report = check_network("mini", SPECS)
    assert not report.ok
    assert {d.rule for d in report.errors} == {"kern/emit"}


# --------------------------------------------------------------------- #
# Standalone kernels: positive + mutated schedules
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("order", ["mnk", "nmk", "kmn", "mkn"])
def test_block_matmul_schedule_clean(order):
    assert check_block_matmul(256, 128, 256, bm=64, bn=64, bk=64,
                              order=order) == []


def test_block_matmul_broken_cmap_fires_coverage(monkeypatch):
    from repro_torch.kernels.block_matmul import matmul_grid

    def broken(m, n, k, *, bm, bn, bk, order):
        grid, amap, bmap, _, axis = matmul_grid(m, n, k, bm=bm, bn=bn,
                                                bk=bk, order=order)
        return grid, amap, bmap, lambda *ids: (0, 0), axis
    monkeypatch.setattr(kerncheck, "matmul_grid", broken)
    diags = check_block_matmul(256, 128, 256, bm=64, bn=64, bk=64,
                               order="mnk")
    assert diags and _rules(diags) == {"kern/coverage"}


def test_decode_schedule_clean():
    assert check_decode(8, 64, 2048, bkv=256) == []


def test_decode_repeating_kv_block_fires_coverage(monkeypatch):
    monkeypatch.setattr(kerncheck, "kv_rows",
                        lambda split, step, steps, bkv: (0, bkv))
    diags = check_decode(8, 64, 2048, bkv=256)
    assert diags and _rules(diags) == {"kern/coverage"}


# --------------------------------------------------------------------- #
# Mutations only a cluster kernel has
# --------------------------------------------------------------------- #

def test_cluster_trace_is_clean_in_both_dtypes(cluster_layer):
    """Both types push their shares by bulk copies of whole 16 bytes: a
    bfloat16 share's pushes complete half the bytes of a float32 one's,
    rounded up to 16."""
    trace, strategy, budget = cluster_layer
    assert _check(trace, strategy, budget) == []
    bf16, _, _ = _trace_of(CLUSTER_SPECS, dtype="bfloat16")
    for tr in (trace, bf16):
        assert not any(isinstance(e, access.Copy) for e in tr.events)
    pushes = {t: [e for e in tr.events if isinstance(e, access.Push)]
              for t, tr in (("f32", trace), ("bf16", bf16))}
    assert len(pushes["f32"]) == len(pushes["bf16"]) > 0
    for p32, p16 in zip(pushes["f32"], pushes["bf16"]):
        assert p32.tx == 4 * p32.dst.elements and p32.tx % 16 == 0
        assert p16.tx == 2 * p16.dst.elements == 16 * -(-p32.tx // 32)
    assert _check(bf16, strategy, budget) == []


def test_a_share_shifted_by_one_element_fires_traffic_and_step_islice(
        cluster_layer):
    trace, strategy, budget = cluster_layer
    bad = copy.deepcopy(trace)
    st = bad.steps[3]
    shares = list(st.shares)
    lo, hi = shares[1]
    shares[1] = (lo + 1, hi + 1)
    bad.steps[3] = dataclasses.replace(st, shares=tuple(shares))
    assert _rules(_check(bad, strategy, budget)) == {"kern/traffic",
                                                      "kern/step-islice"}


def test_dropping_a_slots_full_wait_fires_hazard(cluster_layer):
    """One rank splices a slot without waiting on its full barrier: the
    peers' pushes into it have not landed."""
    trace, strategy, budget = cluster_layer
    bad = copy.deepcopy(trace)
    bad.events = [e for e in bad.events
                  if not (isinstance(e, access.MbarWait) and e.tag == "full"
                          and e.agent.rank == 1 and e.step == 3)]
    assert len(bad.events) == len(trace.events) - 1
    diags = _check(bad, strategy, budget)
    assert _rules(diags) == {"kern/hazard"}
    assert {"war", "waw"} <= _kinds(diags)
    assert any("slot" in d.message for d in diags)


def test_refilling_a_slot_before_its_empty_barrier_fires_hazard(
        cluster_layer):
    """The service warps refill a slot without waiting on its empty
    barrier: their pushes race the peers' splices of the box it held."""
    trace, strategy, budget = cluster_layer
    bad = copy.deepcopy(trace)
    bad.events = [e for e in bad.events
                  if not (isinstance(e, access.MbarWait)
                          and e.tag == "empty")]
    diags = _check(bad, strategy, budget)
    assert _rules(diags) == {"kern/hazard"}
    assert {"barrier", "raw"} <= _kinds(diags)
    assert any("slot" in d.message and dict(d.data)["kind"] == "raw"
               for d in diags)


def test_a_ring_of_one_slot_fires_hazard(cluster_layer):
    """Both ring indices in one slot's cells, the barriers kept: a step's
    pushes overwrite the box the peers have not spliced yet."""
    trace, strategy, budget = cluster_layer
    bad = copy.deepcopy(trace)

    def slot_zero(ev):
        for field in ("cells", "dst"):
            cells = getattr(ev, field, None)
            if cells is not None and cells.space == "slot1":
                return dataclasses.replace(ev, **{field: dataclasses.replace(
                    cells, space="slot0")})
        return ev
    bad.events = [slot_zero(e) for e in bad.events]
    diags = _check(bad, strategy, budget)
    assert _rules(diags) == {"kern/hazard"}
    assert {"war", "waw"} <= _kinds(diags)
    assert all("slot0" in d.message for d in diags)


def test_dropping_the_final_cluster_wait_fires_a_read_after_exit(
        cluster_layer):
    """The last arrivals on a peer's empty barriers may then come after
    the peer exited."""
    trace, strategy, budget = cluster_layer
    bad = copy.deepcopy(trace)
    bad.events = [e for e in bad.events
                  if not (isinstance(e, access.ClusterWait)
                          and e.tag == "exit")]
    diags = _check(bad, strategy, budget)
    assert _rules(diags) == {"kern/hazard"}
    assert _kinds(diags) == {"exit"}
    assert all("empty" in d.message for d in diags)


def test_a_slot_map_off_by_one_row_fires_residency(cluster_layer):
    trace, strategy, budget = cluster_layer
    bad = copy.deepcopy(trace)
    hk = trace.spec.h_k
    bad.steps = [dataclasses.replace(
        st, row_slots=tuple((r + 1) % hk for r in st.row_slots))
        for st in bad.steps]
    assert _rules(_check(bad, strategy, budget)) == {"kern/residency"}


def test_two_ranks_writing_one_column_run_fire_write_back(cluster_layer):
    """The ranks' output columns must cut the step's run: two column
    groups of one channel group writing the same columns leave others
    unwritten."""
    trace, strategy, budget = cluster_layer
    bad = copy.deepcopy(trace)
    st = bad.steps[2]
    cols = list(st.columns)
    cols[1] = cols[0]
    bad.steps[2] = dataclasses.replace(st, columns=tuple(cols))
    assert _rules(_check(bad, strategy, budget)) == {"kern/write-back"}


def test_two_k4_blocks_accumulating_one_c_tile_fire_coverage(monkeypatch):
    """Every rank of K4's cluster walking the inner loop from tile 0."""
    orig = kerncheck.cluster_blocks

    def same_tiles(order, trips, grid_dims, cs, cluster=(1, 1)):
        for rank, lo, cnt, step in orig(order, trips, grid_dims, cs,
                                        cluster):
            lo[order[2]] = 0
            yield rank, lo, cnt, step
    assert check_block_matmul(320, 288, 96, bm=32, bn=32, bk=32,
                              order="mkn") == []
    monkeypatch.setattr(kerncheck, "cluster_blocks", same_tiles)
    diags = check_block_matmul(320, 288, 96, bm=32, bn=32, bk=32,
                               order="mkn")
    assert _rules(diags) == {"kern/coverage"}
    assert any("at once" in d.message for d in diags)


def test_k4_final_cluster_sync_dropped_fires_a_read_after_exit():
    trace = kerncheck.gemm_walk(320, 288, 96, bm=32, bn=32, bk=32,
                                order="mkn")
    assert trace.cs == 8 and len(trace.clusters) == 1
    assert access.cluster_hazard_scan(trace.clusters[0]) == []
    bad = [e for e in trace.clusters[0]
           if not (isinstance(e, access.ClusterWait) and e.tag == "exit")]
    assert {h.kind for h in access.cluster_hazard_scan(bad)} == {"exit"}


# K4 on the wgmma core: the planner's pick for TinyLlama's 2048 -> 256
# projection (m = 4 x 480 prompt tokens), 64 x 32 x 512 in "mkn": a
# cluster of 8 ranks, A resident, 4 resident tiles through a ring of 2.
WG_K4 = dict(m=1920, n=256, k=2048, bm=64, bn=32, bk=512, order="mkn")


@pytest.fixture(scope="module")
def wgmma_k4():
    trace = kerncheck.gemm_walk(**WG_K4)
    assert (trace.core, trace.cs, len(trace.clusters)) == ("wgmma", 8, 1)
    events = trace.clusters[0]
    assert access.cluster_hazard_scan(events) == []
    return events


def _scan(events):
    return {h.kind for h in access.cluster_hazard_scan(events)}


def _without(events, pred):
    kept = [e for e in events if not pred(e)]
    assert len(kept) < len(events)
    return kept


def test_the_wgmma_trace_holds_the_ring_and_the_push_hand_off(wgmma_k4):
    """Rank 0 alone fetches A (TMA boxes into its own slot) and pushes it
    into each peer's slot; every rank fetches its own B; the peers arm
    their own ``full`` and arrive on rank 0's ``ready``, then on its
    ``empty`` once the push has landed."""
    pushes = [e for e in wgmma_k4 if isinstance(e, access.Push)]
    to_peers = [p for p in pushes if p.tag.startswith("push to rank")]
    assert {p.agent.rank for p in to_peers} == {0}
    assert {p.bar.owner for p in to_peers} == set(range(1, 8))
    assert len(to_peers) == 7 * 4 and all(p.tx == 64 * 512 * 2
                                          for p in to_peers)
    boxes = {(p.agent.rank, p.dst.space) for p in pushes
             if p.tag == "TMA box"}
    assert {sp for r, sp in boxes if r} == {"B slot0", "B slot1"}
    assert {sp for r, sp in boxes if r == 0} == {"A slot0", "A slot1",
                                                 "B slot0", "B slot1"}
    arrivals = [e for e in wgmma_k4 if isinstance(e, access.MbarArrive)
                and e.bar.owner == 0 and e.agent.rank]
    assert {e.tag for e in arrivals} == {"ready", "landed"}
    assert len(arrivals) == 2 * 7 * 4
    inits = {e.bar.name: e.count for e in wgmma_k4
             if isinstance(e, access.MbarInit) and e.bar.owner == 0}
    assert inits["A empty0"] == 1 + 7 and inits["B empty0"] == 1
    assert inits["A ready0"] == 7 and inits["A full1"] == 1


def test_rank0_pushing_without_waiting_ready_fires_hazard(wgmma_k4):
    """The push overwrites a peer's slot that its consumers still read."""
    bad = _without(wgmma_k4, lambda e: isinstance(e, access.MbarWait)
                   and e.tag == "ready")
    assert "war" in _scan(bad)


def test_a_peer_leaving_out_its_arrival_on_rank0s_empty_hangs(wgmma_k4):
    """Rank 0's empty then counts one arrival short: its producer waits
    for ever before the third resident tile."""
    bad = _without(wgmma_k4, lambda e: isinstance(e, access.MbarArrive)
                   and e.tag == "landed" and e.agent.rank == 3)
    assert _scan(bad) == {"lost-wait"}


def test_refilling_a_wgmma_slot_before_its_empty_phase_fires_hazard(
        wgmma_k4):
    bad = _without(wgmma_k4, lambda e: isinstance(e, access.MbarWait)
                   and e.tag == "empty")
    assert {"barrier", "raw", "waw"} <= _scan(bad)


def test_a_wgmma_ring_of_one_slot_fires_hazard(wgmma_k4):
    """Both slots' cells in slot 0, the barriers kept: a tile lands over
    the one the consumers are reading."""
    def slot_zero(ev):
        for field in ("cells", "dst"):
            cells = getattr(ev, field, None)
            if cells is not None and cells.space.endswith("slot1"):
                return dataclasses.replace(ev, **{field: dataclasses.replace(
                    cells, space=cells.space[:-1] + "0")})
        return ev
    assert {"war", "waw"} <= _scan([slot_zero(e) for e in wgmma_k4])


def test_a_push_of_more_bytes_than_the_peer_expects_never_lands(wgmma_k4):
    first = next(i for i, e in enumerate(wgmma_k4)
                 if isinstance(e, access.Push) and e.tag == "push to rank 5")
    bad = list(wgmma_k4)
    bad[first] = dataclasses.replace(bad[first], tx=bad[first].tx + 16)
    kinds = _scan(bad)
    assert {"leak", "lost-wait"} <= kinds


def test_dropping_the_wgmma_exit_sync_fires_a_read_after_exit(wgmma_k4):
    """Rank 0 may then exit while a peer's push source read, or its
    arrivals on rank 0's barriers, are still to come."""
    bad = _without(wgmma_k4, lambda e: isinstance(e, access.ClusterWait)
                   and e.tag == "exit")
    assert _scan(bad) == {"exit"}


@pytest.mark.parametrize("order", ["mnk", "kmn", "nkm"])
def test_k3_and_k4_on_wgmma_check_clean_in_rings_of_their_depth(order):
    """Each rank's rings have ``planner.matmul_wg_stages`` slots, their
    ``full`` barriers one arrival, their ``empty`` one per warpgroup (and
    on rank 0 one per peer for the resident operand: A when n is
    innermost, B when m)."""
    from repro_torch.core.planner import matmul_wg_stages
    trace = kerncheck.gemm_walk(256, 256, 512, bm=128, bn=128, bk=128,
                                order=order)
    assert trace.core == "wgmma" and trace.clusters
    depth = matmul_wg_stages(128, 128, 128, order[2] != "k")
    for events in trace.clusters:
        assert access.cluster_hazard_scan(events) == []
        names = {e.bar.name for e in events
                 if isinstance(e, access.MbarInit)}
        assert {f"A full{d}" for d in range(depth)} <= names
        assert f"A full{depth}" not in names
        resident = {"n": "A", "m": "B"}.get(order[2]) if trace.cs > 1 \
            else None
        for e in events:
            if isinstance(e, access.MbarInit) and "empty" in e.bar.name:
                extra = trace.cs - 1 if (e.bar.name[0] == resident
                                         and e.bar.owner == 0) else 0
                assert e.count == 2 + extra


def test_every_standalone_case_is_modelled_on_the_core_core_of_picks():
    """bfloat16 (what ``run_all`` checks, clean) and float32 (on one
    block a K3 cluster: only the wgmma core multicasts): the wgmma core
    gets the ring trace, the others K4's cluster-barrier trace or none."""
    import torch
    from repro_torch.kernels.block_matmul import core_of
    gemm, _ = kerncheck.standalone_cases()
    planned = gemm[len(kerncheck._STANDALONE_GEMM):]
    assert len(planned) == 5              # TinyLlama's four, 8192^3
    for dtype in (torch.bfloat16, torch.float32):
        for cfg in gemm:
            if dtype is torch.float32:
                cfg = dict(cfg, cluster=(1, 1))
            trace = kerncheck.gemm_walk(**cfg, dtype=dtype)
            want = core_of(cfg["bm"], cfg["bn"], cfg["bk"], dtype)
            assert trace.core == want
            rings = any(isinstance(e, access.MbarInit)
                        for ev in trace.clusters for e in ev)
            assert rings == (want == "wgmma")
            if cfg in planned and dtype is torch.bfloat16:
                assert want == "wgmma" and trace.clusters
                tags = {getattr(e, "tag", "") for e in trace.clusters[0]}
                if trace.cs > 1 and cfg["order"][2] != "k":
                    assert {"ready", "landed", "push to rank 1"} <= tags
                elif trace.cs > 1:
                    assert "multicast to rank 1" in tags
    assert all(check_block_matmul(**cfg) == [] for cfg in gemm)


def test_a_k5_range_overlapping_its_neighbour_fires_coverage():
    trace = decode_walk(12, 64, 512, bkv=32, splits=4)
    assert trace.groups == 2 and check_decode_trace(trace) == []
    bad = copy.deepcopy(trace)
    bad.blocks = [(sp, g, st, r0 - 16, r1 - 16, q0, q1) if sp == 2
                  else (sp, g, st, r0, r1, q0, q1)
                  for sp, g, st, r0, r1, q0, q1 in bad.blocks]
    diags = check_decode_trace(bad)
    assert diags and _rules(diags) == {"kern/coverage"}


@pytest.mark.parametrize("splits,bkv", [(1, 64), (8, 64), (16, 32)])
def test_split_decode_schedules_check_clean(splits, bkv):
    assert check_decode(8, 64, 512, bkv=bkv, splits=splits) == []


def test_the_combine_must_read_the_partials_written():
    trace = decode_walk(8, 64, 512, bkv=64, splits=8)
    bad = copy.deepcopy(trace)
    bad.reads = bad.reads[:-1]
    assert _rules(check_decode_trace(bad)) == {"kern/coverage"}
    bad = copy.deepcopy(trace)
    bad.writes = bad.writes + bad.writes[:1]
    assert _rules(check_decode_trace(bad)) == {"kern/coverage"}


# --------------------------------------------------------------------- #
# The cluster hazard scan on hand-made traces
# --------------------------------------------------------------------- #

def _two_ranks(arrive_release=True, fence=False):
    """Rank 0 writes its buffer and arrives; rank 1 waits and reads it."""
    a, b = access.Agent(0), access.Agent(1)
    buf = access.span_cells("buf", 0, 0, 8)
    ev = [access.Write(a, buf, 0)]
    if fence:
        ev.append(access.Fence(a, 0))
    ev += [access.ClusterArrive(a, 0, release=arrive_release),
           access.ClusterWait(a, 0),
           access.ClusterArrive(b, 0), access.ClusterWait(b, 0),
           access.Read(b, buf, 0),
           access.ClusterArrive(a, 1), access.ClusterWait(a, 1),
           access.ClusterArrive(b, 1), access.ClusterWait(b, 1),
           access.BlockExit(a, 1), access.BlockExit(b, 1)]
    return ev


def test_a_release_arrive_orders_a_write_before_a_peers_read():
    assert access.cluster_hazard_scan(_two_ranks()) == []
    assert {h.kind for h in access.cluster_hazard_scan(
        _two_ranks(arrive_release=False))} == {"raw"}
    assert access.cluster_hazard_scan(
        _two_ranks(arrive_release=False, fence=True)) == []


def test_a_copy_lands_only_at_its_wait():
    a = access.Agent(0)
    buf = access.span_cells("buf", 0, 0, 4)
    ev = [access.Copy(a, buf, 0), access.CopyCommit(a, 0),
          access.Read(a, buf, 0), access.CopyWait(a, 0, keep=0),
          access.Read(a, buf, 0), access.Copy(a, buf, 1)]
    kinds = [h.kind for h in access.cluster_hazard_scan(ev)]
    assert kinds == ["raw", "leak"]


def test_block_sync_joins_the_roles_of_a_rank():
    comp, serv = access.Agent(0, "compute"), access.Agent(0, "service")
    buf = access.span_cells("buf", 0, 0, 4)
    ordered = [access.Write(comp, buf, 0), access.BlockSync(comp, 0),
               access.BlockSync(serv, 0), access.Read(serv, buf, 0)]
    assert access.cluster_hazard_scan(ordered) == []
    racy = [access.Write(comp, buf, 0), access.Read(serv, buf, 0)]
    assert [h.kind for h in access.cluster_hazard_scan(racy)] == ["raw"]


def _push_to_rank0(wait=True, expect=8, pushed=8):
    """Rank 1 pushes 2 elements into rank 0's buffer, completing
    ``pushed`` bytes on rank 0's barrier, which expects ``expect``; rank 0
    waits on the phase (or not) and reads the buffer."""
    a, b = access.Agent(0), access.Agent(1)
    bar = access.Mbar(0, "full")
    buf = access.span_cells("buf", 0, 0, 2)
    ev = [access.MbarInit(a, bar, 1, 0),
          access.ClusterArrive(a, 0), access.ClusterWait(a, 0),
          access.ClusterArrive(b, 0), access.ClusterWait(b, 0),
          access.Push(b, buf, bar, 0, 0, pushed),
          access.MbarArrive(a, bar, 0, 0, tx=expect)]
    if wait:
        ev.append(access.MbarWait(a, bar, 0, 0))
    ev += [access.Read(a, buf, 0),
           access.ClusterArrive(a, 1), access.ClusterWait(a, 1),
           access.ClusterArrive(b, 1), access.ClusterWait(b, 1),
           access.BlockExit(a, 1), access.BlockExit(b, 1)]
    return ev


def test_a_push_lands_when_its_phase_completes():
    """Read without the wait, the buffer races the push, and rank 0 may
    exit before it lands."""
    assert access.cluster_hazard_scan(_push_to_rank0()) == []
    assert {h.kind for h in access.cluster_hazard_scan(
        _push_to_rank0(wait=False))} == {"raw", "exit"}


def test_a_phase_that_gets_more_bytes_than_expected_never_completes():
    kinds = [h.kind for h in access.cluster_hazard_scan(
        _push_to_rank0(expect=4))]
    assert "lost-wait" in kinds and "leak" in kinds


def test_an_arrive_on_a_phase_before_the_last_completed_is_misuse():
    """Rank 1 arrives on phase 1 of rank 0's barrier without having seen
    phase 0 complete; and an arrive before the barrier's init."""
    a, b = access.Agent(0), access.Agent(1)
    bar = access.Mbar(0, "empty")
    ev = [access.MbarInit(a, bar, 1, 0),
          access.ClusterArrive(a, 0), access.ClusterWait(a, 0),
          access.ClusterArrive(b, 0), access.ClusterWait(b, 0),
          access.MbarArrive(b, bar, 0, 0), access.MbarArrive(b, bar, 1, 1),
          access.MbarWait(a, bar, 1, 1),
          access.ClusterArrive(a, 1), access.ClusterWait(a, 1),
          access.ClusterArrive(b, 1), access.ClusterWait(b, 1),
          access.BlockExit(a, 1), access.BlockExit(b, 1)]
    assert [h.kind for h in access.cluster_hazard_scan(ev)] == ["barrier"]
    early = [ev[5], ev[0]] + ev[1:5] + ev[6:]
    kinds = [h.kind for h in access.cluster_hazard_scan(early)]
    assert kinds[0] == "barrier" and "init" in access.cluster_hazard_scan(
        early)[0].detail


# --------------------------------------------------------------------- #
# The port against the JAX package's checker
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_port_checks_the_layers_and_steps_the_reference_checks(name):
    specs = list(NETWORKS[name])
    jhw = jkerncheck.network_budget(J_NETWORKS[name])
    hw = network_budget(specs)
    assert (hw.size_mem, hw.nbop_pe) == (jhw.size_mem, jhw.nbop_pe)
    mine, theirs = check_network(name), jkerncheck.check_network(name)
    assert mine.ok and theirs.ok
    assert mine.diagnostics == [] and theirs.diagnostics == []
    assert mine.checked_layers == theirs.checked_layers == len(specs)
    plan = plan_emitable_network(specs, hw, name=name)
    jplan = jemit.plan_emitable_network(J_NETWORKS[name], jhw, name=name)
    differs = set()
    for lp, jlp in zip(plan.layers, jplan.layers):
        em, jem = emit_layer_kernel(lp), jemit.emit_layer_kernel(jlp)
        if (em.t_run, em.order) != (jem.t_run, jem.order):
            differs.add((name, lp.index))
            continue
        trace = build_conv_trace(em)
        jtrace = jkerncheck.build_conv_trace(jem)
        assert len(trace.steps) == len(jtrace.steps)
        for st, jst in zip(trace.steps, jtrace.steps):
            assert st.x_load.box == jst.x_load.box
            assert st.window.box == jst.window.box
            assert st.out.box == jst.out.box
        assert trace.fetched_elements == sum(
            st.x_load.elements + st.lam_elements for st in jtrace.steps)
    assert differs == {k for k in T_RUN_DIFFERS if k[0] == name}
    if not differs:
        assert mine.checked_steps == theirs.checked_steps


@pytest.mark.parametrize("layer", range(7))
def test_kern_traffic_is_the_plans_charge_at_every_resnet8_layer(layer):
    """The quantity ``chip_smoke.py`` holds the card's fetch counter and
    the simulator's DRAM reads against, under the H100's budget."""
    specs = list(NETWORKS["resnet8"])
    hw = H100_SXM.as_hardware_model(dtype_bytes=4)
    lp = plan_emitable_network(specs, hw, name="resnet8").layers[layer]
    trace = build_conv_trace(emit_layer_kernel(lp))
    assert check_conv_trace(trace, lp.strategy, hw.size_mem) == []
    assert trace.fetched_elements == (
        lp.strategy.pixels_loaded() * lp.spec.c_in + lp.spec.kernel_elements)


def test_the_budget_must_bound_a_blocks_occupancy():
    """kern/vmem against a budget below the emitted kernel's occupancy."""
    hw = network_budget(SPECS)
    lp = plan_emitable_network(SPECS, hw, name="mini").layers[0]
    trace = build_conv_trace(emit_layer_kernel(lp))
    diags = check_conv_trace(trace, lp.strategy, trace.vmem_elements - 1)
    assert _rules(diags) == {"kern/vmem"}


# K3 on the wgmma core in a 2 x 2 cluster: the ranks of a tile row share
# each A tile and those of a tile column each B tile, every sharer
# multicasting its half of each box into both sharers' slots; 8 k steps
# through rings of 4 slots, so every slot is refilled.
WG_K3 = dict(m=256, n=256, k=512, bm=128, bn=128, bk=64, order="mnk",
             cluster=(2, 2))


@pytest.fixture(scope="module")
def wgmma_k3():
    trace = kerncheck.gemm_walk(**WG_K3)
    assert (trace.core, trace.cs, len(trace.clusters)) == ("wgmma", 4, 1)
    events = trace.clusters[0]
    assert access.cluster_hazard_scan(events) == []
    return events


def test_the_k3_trace_multicasts_each_share_to_its_sharers(wgmma_k3):
    """Rank r = ix + 2 iy: A goes to the ranks of its tile row (same iy),
    B to those of its tile column (same ix), half a box each (A one box of
    128 x 64, B two of 64 x 64); every
    ``empty`` counts the two warpgroups of both sharers, and every
    consumer arrives on both sharers' ``empty``."""
    sharers = {0: {"A": {0, 1}, "B": {0, 2}}, 3: {"A": {2, 3},
                                                  "B": {1, 3}}}
    pushes = [e for e in wgmma_k3 if isinstance(e, access.Push)]
    assert all(p.tag.startswith("multicast to rank") for p in pushes)
    for r, ops in sharers.items():
        for op, group in ops.items():
            mine = [p for p in pushes if p.agent.rank == r
                    and p.dst.space.startswith(op)]
            assert {p.bar.owner for p in mine} == group
            box = 128 * 64 * 2 if op == "A" else 64 * 64 * 2
            assert {p.tx for p in mine} == {box // 2}
    inits = {(e.bar.owner, e.bar.name): e.count for e in wgmma_k3
             if isinstance(e, access.MbarInit)}
    assert inits[(0, "A empty0")] == inits[(3, "B empty3")] == 2 * 2
    assert inits[(1, "A full0")] == 1
    remote = {(e.agent.rank, e.bar.owner) for e in wgmma_k3
              if isinstance(e, access.MbarArrive) and e.tag == "empty"
              and e.bar.name.startswith("A")}
    assert remote == {(0, 0), (0, 1), (1, 0), (1, 1), (2, 2), (2, 3),
                      (3, 2), (3, 3)}


def test_k3_consumers_freeing_only_their_own_slot_hang(wgmma_k3):
    """No remote ``empty`` arrival: a sharer's ``empty`` counts half its
    arrivals and its producer waits for ever before the ring wraps."""
    bad = _without(wgmma_k3, lambda e: isinstance(e, access.MbarArrive)
                   and e.tag == "empty" and e.bar.owner != e.agent.rank)
    assert _scan(bad) == {"lost-wait"}


def test_a_k3_multicast_with_a_wrong_cta_mask_fires_hazard(wgmma_k3):
    """Rank 0's first A share sent to rank 2 (another tile row) in place
    of rank 1: rank 2's slot takes bytes its ``full`` does not expect and
    rank 1's never completes."""
    bad = list(wgmma_k3)
    at = next(i for i, e in enumerate(bad) if isinstance(e, access.Push)
              and e.agent.rank == 0 and e.tag == "multicast to rank 1"
              and e.dst.space.startswith("A"))
    push = bad[at]
    bad[at] = dataclasses.replace(
        push, dst=dataclasses.replace(push.dst, owner=2),
        bar=dataclasses.replace(push.bar, owner=2),
        tag="multicast to rank 2")
    assert {"leak", "lost-wait"} <= _scan(bad)


def test_a_k3_refill_before_every_sharer_frees_the_slot_fires_hazard(
        wgmma_k3):
    """Each ``empty`` counting its own warpgroups alone: a producer
    multicasts into a sharer's slot while that sharer's consumers still
    read it."""
    bad = []
    for e in wgmma_k3:
        if isinstance(e, access.MbarInit) and "empty" in e.bar.name:
            e = dataclasses.replace(e, count=2)
        elif (isinstance(e, access.MbarArrive) and e.tag == "empty"
              and e.bar.owner != e.agent.rank):
            continue
        bad.append(e)
    assert "war" in _scan(bad)


def test_dropping_the_k3_exit_sync_fires_a_read_after_exit(wgmma_k3):
    """A rank may exit while a sharer's multicast into it, or its arrival
    on the rank's ``empty``, is still to come."""
    bad = _without(wgmma_k3, lambda e: isinstance(e, access.ClusterWait)
                   and e.tag == "exit")
    assert "exit" in _scan(bad)


@pytest.mark.parametrize("m,n,k,bm_,bn_,bk_,cluster", [
    (256, 512, 256, 128, 256, 64, (2, 1)),
    (256, 512, 256, 128, 256, 64, (1, 2)),
    (128, 512, 128, 64, 256, 128, (2, 2)),
    (256, 256, 64, 64, 128, 16, (2, 1)),
])
@pytest.mark.parametrize("order", ["mnk", "nmk"])
def test_k3_clusters_check_clean_on_both_grid_orders(m, n, k, bm_, bn_, bk_,
                                                     cluster, order):
    """The gpu tests' K3 clusters, both grid layouts (n on x for mnk, m
    for nmk): no hazard, every tile covered."""
    assert check_block_matmul(m, n, k, bm=bm_, bn=bn_, bk=bk_, order=order,
                              cluster=cluster) == []


def test_a_cluster_k3_does_not_take_is_an_emit_error():
    """Three tile rows take no 2 along m; K4 takes no m x n cluster."""
    diags = check_block_matmul(384, 256, 256, bm=128, bn=128, bk=64,
                               order="mnk", cluster=(2, 1))
    assert _rules(diags) == {"kern/emit"}
    diags = check_block_matmul(256, 256, 256, bm=128, bn=128, bk=64,
                               order="mkn", cluster=(1, 2))
    assert _rules(diags) == {"kern/emit"}
