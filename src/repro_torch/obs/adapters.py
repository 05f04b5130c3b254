"""Timeline builders: plans, simulator runs, and kernel traces onto the
shared event model.

Three producers, one vocabulary:

* **predicted** — a plan's Def-3 step ledger, decomposed per step into
  lane spans (``obs.events.decompose_step``; write-back weights mirror
  ``analysis.verifier._out_weights``), plus VMEM-occupancy and
  cumulative-traffic counters from a symbolic step walk;
* **simulated** — what the functional simulators *measured*
  (``sim.system`` / ``sim.s2`` step traces carry their own lane
  durations and DRAM element counts, not recomputed from the plan);
* **kernel** — the static walk of the planned conv kernel's cluster
  over an emitted layer (``analysis.kerncheck``), with the regions the
  cluster fetches and the output block of every step.

Network timelines lay layers back to back at their *gross* durations
(both predicted and simulated model the reuse-free schedule the
simulator executes; inter-layer reuse savings are analytic in
``sim.network`` and cancel in the drift comparison).  Multichip
timelines follow the plan's stage discipline — a layer's inbound ICI
spans open the stage on every active chip, shard spans start after them
(serial) or alongside them (``overlap``), and the stage cursor advances
by the plan's layer duration, so the predicted cluster timeline ends at
``plan.total_duration`` minus the analytic savings already folded in.

Kernel timelines cover the *compute* steps of an emitable plan: the
kernel writes each output block during its own step, one step earlier
than the plan's a3 write-back (which drains at the *next* step) —
per-step ``dma_in`` spans reconcile exactly; ``write_back`` reconciles
at layer granularity.  The ranks of the kernel's thread-block cluster
share each step's fetch; their shares add up to the step's box, so the
whole cluster's fetch stays on chip 0's lane and a layer's ``dma_in``
elements are what its blocks add to the kernel's fetch counter.
"""
from __future__ import annotations

from repro_torch.analysis import kerncheck
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import MemoryState, apply_step
from repro_torch.core.multichip import MultiChipPlan
from repro_torch.core.network_planner import NetworkPlan
from repro_torch.obs.events import Timeline
from repro_torch.sim.multichip import MultiChipSimReport
from repro_torch.sim.network import NetworkSimReport
from repro_torch.sim.trace import StepTrace


def _kernel_groups_of(strategy):
    """S2 strategies carry ``kernel_groups``; S1 strategies do not."""
    return getattr(strategy, "kernel_groups", None)


def _footprint_elements(m: MemoryState, spec: ConvSpec,
                        kernel_groups) -> int:
    """Resident elements of a formal state, with S2 cell weighting
    (mirrors ``analysis.verifier``'s occupancy ledger)."""
    kelem = spec.c_in * spec.h_k * spec.w_k
    base = m.inp.bit_count() * spec.c_in + m.ker.bit_count() * kelem
    if kernel_groups is None:
        return base + m.out.bit_count() * spec.c_out
    g_count = len(kernel_groups)
    cells = 0
    mask = m.out
    while mask:
        low = mask & -mask
        cells += len(kernel_groups[(low.bit_length() - 1) % g_count])
        mask ^= low
    return base + cells


def add_plan_layer(tl: Timeline, strategy, spec: ConvSpec,
                   hw: HardwareModel, *, chip: int, layer: int,
                   t0: float, cum_read: int = 0) -> tuple[float, int]:
    """Emit one layer's predicted step ledger onto ``tl`` starting at
    ``t0``; returns (end time, cumulative DRAM-read elements)."""
    kernel_groups = _kernel_groups_of(strategy)
    m = MemoryState()
    t = t0
    for idx, s in enumerate(strategy.to_steps()):
        t = tl.add_step(s, spec, hw, chip=chip, layer=layer, index=idx,
                        t0=t, kernel_groups=kernel_groups)
        m = apply_step(m, s)
        tl.add_counter("vmem_elements", chip, t,
                       _footprint_elements(m, spec, kernel_groups))
        cum_read += s.i_slice.bit_count() * spec.c_in \
            + s.k_sub.bit_count() * spec.c_in * spec.h_k * spec.w_k
        tl.add_counter("dram_read_elements", chip, t, cum_read)
    return t, cum_read


def add_sim_layer(tl: Timeline, traces: "list[StepTrace]",
                  hw: HardwareModel, *, chip: int, layer: int,
                  t0: float, cum_read: int = 0) -> tuple[float, int]:
    """Emit one layer's *measured* step traces onto ``tl``."""
    t = t0
    for tr in traces:
        tl.add_span(f"L{layer} s{tr.index} wb", "write_back", chip, t,
                    tr.write_duration, layer=layer, step=tr.index,
                    elements=tr.written_elements, w=tr.step.w)
        t += tr.write_duration
        tl.add_span(f"L{layer} s{tr.index} dma", "dma_in", chip, t,
                    tr.load_duration, layer=layer, step=tr.index,
                    elements=tr.read_elements, i_slice=tr.step.i_slice,
                    k_sub=tr.step.k_sub)
        t += tr.load_duration
        tl.add_span(f"L{layer} s{tr.index} acc", "compute", chip, t,
                    tr.compute_duration, layer=layer, step=tr.index,
                    group=tr.step.group)
        t += tr.compute_duration
        retry_dur = getattr(tr, "retry_duration", 0.0)
        if retry_dur:
            # injected DMA transients (repro_torch.resil): the re-issued
            # loads + backoff surface on the fault lane, keeping the invariant
            # wb + dma + acc + retry == tr.duration
            tl.add_span(f"L{layer} s{tr.index} dma-retry", "fault", chip,
                        t, retry_dur, layer=layer, step=tr.index,
                        elements=getattr(tr, "retry_elements", 0),
                        retries=getattr(tr, "retries", 0))
            t += retry_dur
        tl.add_counter("vmem_elements", chip, t, tr.mem_elements)
        cum_read += tr.read_elements
        tl.add_counter("dram_read_elements", chip, t, cum_read)
    return t, cum_read


# --------------------------------------------------------------------- #
# Single-chip network timelines
# --------------------------------------------------------------------- #

def network_predicted_timeline(plan: NetworkPlan,
                               label: str = "predicted") -> Timeline:
    tl = Timeline(label)
    t = 0.0
    cum = 0
    for lp in plan.layers:
        t, cum = add_plan_layer(tl, lp.strategy, lp.spec, plan.hw,
                                chip=0, layer=lp.index, t0=t,
                                cum_read=cum)
    return tl


def network_simulated_timeline(sim: NetworkSimReport,
                               label: str = "simulated") -> Timeline:
    tl = Timeline(label)
    t = 0.0
    cum = 0
    for lp, rep in zip(sim.plan.layers, sim.layer_reports):
        t, cum = add_sim_layer(tl, rep.traces, sim.plan.hw, chip=0,
                               layer=lp.index, t0=t, cum_read=cum)
    return tl


# --------------------------------------------------------------------- #
# Multichip timelines
# --------------------------------------------------------------------- #

def _add_stage_ici(tl: Timeline, lp, t0: float) -> None:
    if lp.ici_duration <= 0:
        return
    for shard in lp.shards:
        tl.add_span(f"L{lp.index} ici {lp.mode}", "ici", shard.chip, t0,
                    lp.ici_duration, layer=lp.index,
                    elements=lp.ici_elements, mode=lp.mode,
                    overlap=lp.overlap)


def _add_final_gather(tl: Timeline, plan: MultiChipPlan,
                      t0: float) -> None:
    if plan.final_gather_duration <= 0:
        return
    for shard in plan.layers[-1].shards:
        tl.add_span("final gather", "ici", shard.chip, t0,
                    plan.final_gather_duration,
                    elements=plan.final_gather_elements)


def multichip_predicted_timeline(plan: MultiChipPlan,
                                 label: str = "predicted") -> Timeline:
    tl = Timeline(label)
    t = 0.0
    for lp in plan.layers:
        _add_stage_ici(tl, lp, t)
        start = t if lp.overlap else t + lp.ici_duration
        for shard in lp.shards:
            add_plan_layer(tl, shard.strategy, shard.spec,
                           plan.cluster.chip, chip=shard.chip,
                           layer=lp.index, t0=start)
        t += lp.duration
    _add_final_gather(tl, plan, t)
    return tl


def multichip_simulated_timeline(sim: MultiChipSimReport,
                                 label: str = "simulated") -> Timeline:
    """Measured shard runs placed under the plan's stage discipline (the
    ICI transfers themselves are analytic — see ``sim.multichip``)."""
    plan = sim.plan
    tl = Timeline(label)
    t = 0.0
    for lp, reps in zip(plan.layers, sim.shard_reports):
        _add_stage_ici(tl, lp, t)
        start = t if lp.overlap else t + lp.ici_duration
        for shard, rep in zip(lp.shards, reps):
            add_sim_layer(tl, rep.traces, plan.cluster.chip,
                          chip=shard.chip, layer=lp.index, t0=start)
        t += lp.duration
    _add_final_gather(tl, plan, t)
    return tl


# --------------------------------------------------------------------- #
# Fault-injected timelines (repro_torch.resil)
# --------------------------------------------------------------------- #

def faulted_timeline(report, label: str = "faulted") -> Timeline:
    """Timeline of a fault-injected run (``repro_torch.resil.engine``).

    Committed attempts place their measured shard traces under the
    stage discipline exactly like :func:`multichip_simulated_timeline`
    (chips are the attempt's *physical* ids, so a post-recovery plan's
    slot 0 lands on the surviving chip's track); wasted attempts become
    ``fault`` spans on every chip of the doomed attempt plus the
    heartbeat-detection window on the dead chip; every re-plan becomes
    ``recovery`` spans (re-plan latency, then the recovery-point restage
    for chip deaths).  Duck-typed over ``FaultSimReport`` so
    ``repro_torch.obs`` stays below ``repro_torch.resil`` in the layering.
    """
    plan0 = report.plans[0]
    hw = plan0.cluster.chip
    tl = Timeline(label)
    for att in report.attempts:
        if att.wasted:
            for c in att.phys_chips:
                tl.add_span(f"L{att.layer} wasted attempt", "fault", c,
                            att.t0, att.duration, layer=att.layer,
                            cause="chip_death", dead_chip=att.dead_chip)
            tl.add_span(f"L{att.layer} detection", "fault",
                        att.dead_chip, att.t0 + att.duration,
                        att.detection, layer=att.layer,
                        cause="heartbeat_timeout")
            continue
        lp = att.lp
        if lp.ici_duration > 0:
            for shard in lp.shards:
                tl.add_span(f"L{att.layer} ici {lp.mode}", "ici",
                            att.phys_chips[shard.chip], att.t0,
                            lp.ici_duration, layer=att.layer,
                            elements=lp.ici_elements, mode=lp.mode,
                            overlap=lp.overlap)
        start = att.t0 if lp.overlap else att.t0 + lp.ici_duration
        for shard, rep in zip(lp.shards, att.reports):
            add_sim_layer(tl, rep.traces, hw,
                          chip=att.phys_chips[shard.chip],
                          layer=att.layer, t0=start)
    for rec in report.recoveries:
        tl.add_span(f"L{rec.layer} replan {rec.kind}", "recovery", 0,
                    rec.t0, rec.replan_cycles, layer=rec.layer,
                    kind=rec.kind, n_chips=rec.n_chips,
                    topology=rec.new_topology, verified=rec.verified)
        if rec.restage_cycles > 0:
            tl.add_span(f"L{rec.layer} restage", "recovery", 0,
                        rec.t0 + rec.replan_cycles, rec.restage_cycles,
                        layer=rec.layer, kind=rec.kind,
                        elements=rec.restage_elements)
    last = report.plans[-1]
    if last.final_gather_duration > 0 and report.attempts:
        t0 = report.faulted_duration - last.final_gather_duration
        for c in report.attempts[-1].phys_chips:
            tl.add_span("final gather", "ici", c, t0,
                        last.final_gather_duration,
                        elements=last.final_gather_elements)
    return tl


# --------------------------------------------------------------------- #
# Kernel-trace timelines (static walk of the planned conv kernel)
# --------------------------------------------------------------------- #

def kernel_timeline(plan: NetworkPlan, label: str = "kernel") -> Timeline:
    """Timeline of the emitted kernels' *traced* access sets, one kernel
    step per plan compute step (see the module note on write-back skew).
    ``plan`` must be emitable (``kernels.emit.plan_emitable_network``).

    A step's ``dma_in`` span carries what the cluster fetches: every
    rank's share of the step's box plus its Λ columns.  kerncheck proves
    the shares a disjoint cover of the box, so this is the box's
    elements plus Λ, and a layer's spans add up to
    ``KernelTrace.fetched_elements``."""
    from repro_torch.kernels.emit import emit_layer_kernel
    hw = plan.hw
    tl = Timeline(label)
    t = 0.0
    for lp in plan.layers:
        spec = lp.spec
        trace = kerncheck.build_conv_trace(emit_layer_kernel(lp))
        for st in trace.steps:
            pix = kerncheck._box_pixmask(spec, st.x_load)
            n_pix = pix.bit_count()
            lam = sum(st.lam_elements)
            load_dur = (n_pix + lam) * hw.t_l
            tl.add_span(f"L{lp.index} g{st.index} dma", "dma_in", 0, t,
                        load_dur, layer=lp.index, step=st.index,
                        elements=sum(hi - lo for lo, hi in st.shares) + lam,
                        i_slice=pix, region=st.x_load.describe())
            t += load_dur
            tl.add_span(f"L{lp.index} g{st.index} acc", "compute", 0, t,
                        hw.t_acc, layer=lp.index, step=st.index)
            t += hw.t_acc
            out_mask = kerncheck._out_patchmask(spec, st.out)
            n_out = out_mask.bit_count()
            tl.add_span(f"L{lp.index} g{st.index} wb", "write_back", 0,
                        t, n_out * hw.t_w, layer=lp.index, step=st.index,
                        elements=n_out * spec.c_out, w=out_mask)
            t += n_out * hw.t_w
        tl.add_counter("vmem_elements", 0, t, trace.vmem_elements)
    return tl
