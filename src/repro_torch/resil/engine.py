"""The fault-injection and layer-granular recovery engine.

:func:`run_faulted` executes a network on a cluster under a seeded
:class:`~repro_torch.resil.faults.FaultSchedule`, stage (= layer) by stage:

1. **Fault-free plan** — the network is planned exactly as the benchmark
   plans it; its total duration is the baseline the degraded run is
   compared against.
2. **Boundary faults** (``LinkDegrade`` / ``VmemShrink``) are detected
   *before* their stage runs: the remaining layers are re-planned
   (``core.multichip.replan_suffix``, warm-started via the shared
   ``solve_cached`` LRU) on the repriced cluster.  Nothing is
   recomputed.
3. **Chip death** strikes *during* its stage: the whole attempt is
   wasted (its partial writes never reach the durable store), the
   control plane (heartbeats on the simulated cycle clock —
   ``resil.controller``) detects the silent chip after
   ``detection_cycles``, the surviving topology is chosen
   (``resil.degrade``), the tail is re-planned, the last committed
   activation is restaged to the survivors, and the stage is retried.
4. **DMA transients** re-issue a step's loads with exponential backoff
   (injected into ``sim.system.System.run`` for S1 shards; priced
   analytically for S2 shards — reads are idempotent either way).

**Recovery points.**  A committed layer output is durable: write-backs
go to a store in a separate fault domain (host DRAM — the standard
layer-checkpoint assumption), so a chip death never loses committed
layers and only the in-flight stage is recomputed.  The price of that
assumption is explicit: *every* re-plan pays a *restage* of the current
layer's input (the last committed activation) from the durable store
into the chips' DRAM at ``t_l`` per element — a suffix plan assumes the
engine's canonical replicated input layout (zero inbound ICI for its
first layer), and the restage is what makes that layout true; without
it a boundary re-plan could beat the fault-free baseline by silently
pocketing the inbound transfer it never paid.  That comes on top of
the deterministic re-plan latency
(``replan_cycles_per_layer x remaining layers`` — wall-clock planning
seconds are machine-dependent and are reported separately, never
entering the ledger or the fingerprint).

**Exactly-once outputs.**  Every committed element is counted in an
integer write-count array (must be exactly 1 everywhere — a wasted
attempt contributes 0, a recovery exactly 1), the stitched output of
every committed layer must equal the fault-free reference convolution
under the simulator's stitching discipline (``allclose`` at the
``sim.multichip`` tolerances — S1 einsum accumulation order differs
from the reference at float32 ULP level, so bitwise equality against
the *analytic* reference is not the invariant even fault-free), and the
whole faulted run is reproducible bit-for-bit: the report's
``fingerprint`` hashes the committed bytes and the ledger, and two runs
of the same schedule must agree (checked by ``faultsim`` and the
tests).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Sequence

import numpy as np

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core import solver as solver_mod
from repro_torch.core.cost_model import ClusterModel
from repro_torch.core.multichip import (MultiChipLayerPlan, MultiChipPlan,
                                        plan_multichip_network, replan_suffix)
from repro_torch.obs.events import decompose_step
from repro_torch.resil.controller import RecoveryController
from repro_torch.resil.degrade import (repriced_cluster, shrunk_cluster,
                                       surviving_cluster)
from repro_torch.resil.faults import (ChipDeath, ClusterExhaustedError,
                                      DegradedInfeasibleError, DmaTransient,
                                      FaultSchedule, LinkDegrade, VmemShrink)
from repro_torch.sim.functional import reference_conv
from repro_torch.sim.layer import ConvLayer
from repro_torch.sim.multichip import LayerReport, run_shard

_RTOL = 1e-4        # the sim.multichip stitching tolerances
_ATOL = 1e-4
_ACC_TOL = 1e-6     # per-shard duration reconciliation


@dataclasses.dataclass
class StageAttempt:
    """One execution attempt of one global layer."""

    layer: int                        # global layer index
    t0: float                         # cycle the attempt started
    duration: float                   # modeled stage duration (lp.duration)
    phys_chips: tuple[int, ...]       # slot -> physical chip id
    wasted: bool = False              # chip death discarded this attempt
    dead_chip: int | None = None      # physical id of the chip that died
    detection: float = 0.0            # heartbeat latency paid (wasted only)
    retry_duration: float = 0.0       # DMA transients, summed over shards
    retry_elements: int = 0
    shard_durations: dict[int, float] = dataclasses.field(
        default_factory=dict)         # physical chip -> measured duration
    reports: list[LayerReport] = dataclasses.field(default_factory=list)
    lp: MultiChipLayerPlan | None = None   # the plan slice it executed

    @property
    def total(self) -> float:
        return self.duration + self.detection + self.retry_duration


@dataclasses.dataclass
class RecoveryAction:
    """One re-plan the engine performed (boundary fault or chip death)."""

    kind: str                         # 'chip_death'|'link_degrade'|...
    layer: int                        # first layer of the re-planned tail
    t0: float
    replan_cycles: float
    restage_cycles: float             # chip death only: recovery-point
    restage_elements: int             # activation restaged from the store
    new_topology: str
    n_chips: int
    elastic: "object | None" = None   # ElasticPlan (chip death only)
    planning_seconds: float = 0.0     # wall-clock, NOT in the ledger
    verified: bool = False
    solver_calls: int = 0             # this re-plan's own window only
    cache_hits: int = 0               # (LRU + persistent-store warmth)

    @property
    def total(self) -> float:
        return self.replan_cycles + self.restage_cycles


@dataclasses.dataclass
class FaultSimReport:
    """Everything one faulted run established."""

    name: str
    schedule: FaultSchedule
    baseline_duration: float          # fault-free plan total
    faulted_duration: float           # degraded ledger incl. recovery
    attempts: list[StageAttempt]
    recoveries: list[RecoveryAction]
    skipped_events: list[str]         # events whose slot did not exist
    committed: list[np.ndarray]       # per-layer stitched outputs
    write_counts_ok: bool             # every element committed exactly once
    layer_allclose: list[bool]        # stitched vs reference conv
    accounting_ok: bool               # measured == gross+pad_saved+retry
    stragglers_flagged: int
    findings: list[str]
    plans: list[MultiChipPlan]        # fault-free plan + every re-plan

    @property
    def recovery_exact(self) -> bool:
        """Exactly-once write semantics + stitched outputs equal to the
        fault-free reference conv (module note)."""
        return self.write_counts_ok and all(self.layer_allclose)

    @property
    def degraded_slowdown(self) -> float:
        if self.baseline_duration <= 0:
            return 1.0
        return self.faulted_duration / self.baseline_duration

    @property
    def no_free_lunch(self) -> bool:
        """Degraded duration never beats the fault-free baseline.  A
        pricing property, not a correctness invariant: reported, and
        asserted by the tests on the compute-dominated networks."""
        return self.faulted_duration >= self.baseline_duration - 1e-6

    @property
    def wasted_cycles(self) -> float:
        return sum(a.total for a in self.attempts if a.wasted)

    @property
    def recovery_cycles(self) -> float:
        return sum(r.total for r in self.recoveries)

    @property
    def retry_cycles(self) -> float:
        return sum(a.retry_duration for a in self.attempts)

    @property
    def recomputed_elements(self) -> int:
        """Output elements whose computation was discarded and redone."""
        out = 0
        for a in self.attempts:
            if a.wasted and a.lp is not None:
                spec = a.lp.spec
                out += spec.num_patches * spec.c_out
        return out

    @property
    def ok(self) -> bool:
        return self.recovery_exact and self.accounting_ok \
            and not self.findings

    @property
    def fingerprint(self) -> str:
        """Bit-for-bit reproducibility witness: same schedule + seed
        must reproduce this hash exactly (committed bytes + ledger)."""
        h = hashlib.sha256()
        for arr in self.committed:
            h.update(arr.tobytes())
        h.update(repr((self.baseline_duration, self.faulted_duration,
                       self.wasted_cycles, self.recovery_cycles,
                       self.retry_cycles,
                       [(a.layer, a.wasted, a.t0, a.total)
                        for a in self.attempts],
                       [(r.kind, r.layer, r.t0, r.total)
                        for r in self.recoveries])).encode())
        return h.hexdigest()

    def summary(self) -> str:
        sched = self.schedule.describe()
        return (f"faultsim: {self.name} [{sched}] "
                f"recovery_exact={self.recovery_exact} "
                f"exactly_once={self.write_counts_ok} "
                f"accounting_ok={self.accounting_ok} "
                f"no_free_lunch={self.no_free_lunch} "
                f"slowdown={self.degraded_slowdown:.3f}x "
                f"(baseline {self.baseline_duration:g} -> "
                f"faulted {self.faulted_duration:g}; wasted "
                f"{self.wasted_cycles:g} + recovery "
                f"{self.recovery_cycles:g} + retries "
                f"{self.retry_cycles:g}; recomputed "
                f"{self.recomputed_elements} elements; "
                f"{len(self.recoveries)} re-plans)")


def _stitch(lp: MultiChipLayerPlan, reports: "list[LayerReport]",
            ref_shape: "tuple[int, ...]",
            ) -> "tuple[np.ndarray, np.ndarray]":
    """Assemble shard outputs into the full output tensor plus the
    integer write-count array of the exactly-once proof."""
    assembled = np.full(ref_shape, np.nan, dtype=np.float32)
    counts = np.zeros(ref_shape, dtype=np.int32)
    for shard, rep in zip(lp.shards, reports):
        rows = slice(None) if shard.out_rows is None else \
            slice(*shard.out_rows)
        kers = slice(None) if shard.kernel_range is None else \
            slice(*shard.kernel_range)
        assembled[kers, rows, :] = rep.output
        counts[kers, rows, :] += 1
    return assembled, counts


def _s2_retry_price(shard, hw, step_idx: int, retries: int,
                    backoff_base: float) -> "tuple[float, int]":
    """Analytic retry charge for an S2 shard (no functional injection —
    a re-read is idempotent, only the ledger moves)."""
    steps = shard.strategy.to_steps()
    s = steps[min(step_idx, len(steps) - 1)]
    lanes = decompose_step(s, shard.spec, hw,
                           kernel_groups=shard.strategy.kernel_groups)
    dur = retries * lanes.load_dur \
        + backoff_base * (2 ** retries - 1)
    return dur, retries * lanes.load_elements


def run_faulted(specs: Sequence[ConvSpec], cluster: ClusterModel,
                schedule: FaultSchedule, *,
                name: str = "network", seed: int = 0,
                verify: "bool | None" = None,
                inject_corruption: "int | None" = None,
                **plan_kwargs) -> FaultSimReport:
    """Execute ``specs`` on ``cluster`` under ``schedule`` (module note).

    ``plan_kwargs`` are forwarded to every ``plan_multichip_network`` /
    ``replan_suffix`` call (polish budgets, rng_seed, ...).  ``verify``
    gates the static plan verifier on the fault-free plan AND every
    degraded re-plan (default: the ``REPRO_VERIFY_PLANS`` env knob); a
    degraded plan with an error-severity diagnostic raises
    ``PlanVerificationError`` out of this function.

    ``inject_corruption`` is the negative-path hook: after committing
    that global layer, one output element is corrupted and one write
    count is double-counted — the recovery checks must catch both (used
    by ``faultsim --inject-corruption`` and the tests; never set in
    production runs).
    """
    from repro_torch.analysis.verifier import should_verify
    specs = list(specs)
    n_layers = len(specs)
    do_verify = should_verify(verify)
    plan_kwargs.setdefault("include_single_chip_baseline", False)

    plan0 = plan_multichip_network(specs, cluster, name=name,
                                   verify=do_verify, **plan_kwargs)
    baseline = plan0.total_duration

    boundary = [e for e in schedule.events
                if isinstance(e, (LinkDegrade, VmemShrink))]
    deaths = [e for e in schedule.events if isinstance(e, ChipDeath)]
    dmas = [e for e in schedule.events if isinstance(e, DmaTransient)]
    applied: set[int] = set()      # indices into schedule.events
    idx_of = {id(e): i for i, e in enumerate(schedule.events)}

    controller = RecoveryController(
        list(range(cluster.n_chips)),
        detection_cycles=schedule.detection_cycles)

    cur_plan, off, cur_cluster = plan0, 0, cluster
    phys = list(range(cluster.n_chips))     # slot -> physical chip id
    committed: list[np.ndarray] = [None] * n_layers  # type: ignore
    allclose_ok: list[bool] = [False] * n_layers
    counts_ok = True
    accounting_ok = True
    attempts: list[StageAttempt] = []
    recoveries: list[RecoveryAction] = []
    skipped: list[str] = []
    findings: list[str] = []
    plans = [plan0]
    stragglers = 0
    t = 0.0
    hw = cur_cluster.chip

    def _replan(gi: int, new_cluster: ClusterModel, kind: str,
                restage_elems: int = 0) -> RecoveryAction:
        nonlocal cur_plan, off, cur_cluster, hw
        wall0 = time.perf_counter()
        stats0 = solver_mod.cache_stats()
        try:
            cur_plan = replan_suffix(specs, new_cluster, start=gi,
                                     name=name, verify=do_verify,
                                     **plan_kwargs)
        except Exception as exc:
            from repro_torch.core.network_planner import (
                InfeasibleNetworkError)
            if isinstance(exc, InfeasibleNetworkError):
                raise DegradedInfeasibleError(
                    f"{kind} at layer {gi}: degraded cluster "
                    f"({new_cluster.n_chips} chips, "
                    f"{new_cluster.topo.describe()}, "
                    f"size_mem={new_cluster.chip.size_mem}) fits no "
                    f"plan for the remaining layers") from exc
            raise
        off, cur_cluster, hw = gi, new_cluster, new_cluster.chip
        plans.append(cur_plan)
        # delta attribution: only this re-plan's window, so recovery hit
        # rates never claim the fault-free plan's (or each other's) hits
        replan_stats = solver_mod.cache_stats() - stats0
        from repro_torch.obs.metrics import REGISTRY
        REGISTRY.incr("planner/stage/resil_replan/calls",
                      replan_stats.solve_calls)
        REGISTRY.incr("planner/stage/resil_replan/hits",
                      replan_stats.solve_hits)
        replan_cost = schedule.replan_cycles_per_layer * (n_layers - gi)
        restage_cost = restage_elems * hw.t_l
        rec = RecoveryAction(
            kind=kind, layer=gi, t0=t,
            replan_cycles=replan_cost,
            restage_cycles=restage_cost,
            restage_elements=restage_elems,
            new_topology=new_cluster.topo.describe(),
            n_chips=new_cluster.n_chips,
            planning_seconds=time.perf_counter() - wall0,
            verified=do_verify,
            solver_calls=replan_stats.solve_calls,
            cache_hits=replan_stats.solve_hits)
        recoveries.append(rec)
        return rec

    gi = 0
    while gi < n_layers:
        lp = cur_plan.layers[gi - off]

        # ---- boundary faults: detected before the stage runs -------- #
        pending = [e for e in boundary
                   if e.layer == gi and idx_of[id(e)] not in applied]
        if pending:
            new_cluster = cur_cluster
            kinds = []
            for e in pending:
                applied.add(idx_of[id(e)])
                if isinstance(e, LinkDegrade):
                    new_cluster = repriced_cluster(new_cluster, e.factor)
                    kinds.append("link_degrade")
                else:
                    new_cluster = shrunk_cluster(new_cluster, e.factor)
                    kinds.append("vmem_shrink")
            spec = specs[gi]
            rec = _replan(gi, new_cluster, "+".join(kinds),
                          restage_elems=spec.num_pixels * spec.c_in)
            t += rec.total
            controller.advance(rec.total)
            continue                     # re-read lp from the new plan

        # ---- chip death: strikes during the stage ------------------- #
        death = next(
            (e for e in deaths
             if e.layer == gi and idx_of[id(e)] not in applied), None)
        if death is not None:
            applied.add(idx_of[id(death)])
            if death.chip >= cur_cluster.n_chips:
                skipped.append(
                    f"ChipDeath(layer={death.layer}, chip={death.chip}):"
                    f" slot does not exist ({cur_cluster.n_chips} chips)")
            else:
                dead_phys = phys[death.chip]
                survivors = [p for p in phys if p != dead_phys]
                att = StageAttempt(
                    layer=gi, t0=t, duration=lp.duration,
                    phys_chips=tuple(phys), wasted=True,
                    dead_chip=dead_phys,
                    detection=schedule.detection_cycles, lp=lp)
                attempts.append(att)
                # survivors beat at stage end; the dead chip is silent
                controller.advance(lp.duration)
                controller.stage_done(survivors, gi, {})
                controller.advance(schedule.detection_cycles)
                controller.expect_death(dead_phys)
                t += att.total
                if not survivors:
                    raise ClusterExhaustedError(
                        f"last chip died at layer {gi}")
                new_cluster = surviving_cluster(cur_cluster)
                spec = specs[gi]
                rec = _replan(gi, new_cluster, "chip_death",
                              restage_elems=spec.num_pixels * spec.c_in)
                rec.elastic = controller.elastic_plan(survivors)
                t += rec.total
                controller.advance(rec.total)
                phys = survivors
                continue                 # retry the stage, degraded

        # ---- normal execution (possibly with DMA transients) -------- #
        full = ConvLayer.random(lp.spec, seed=seed + gi)
        ref_shape = (lp.spec.n_kernels, lp.spec.h_out, lp.spec.w_out)
        stage_dmas = [e for e in dmas
                      if e.layer == gi and idx_of[id(e)] not in applied]
        reports: list[LayerReport] = []
        shard_durs: dict[int, float] = {}
        retry_dur_total, retry_elems_total = 0.0, 0
        for shard in lp.shards:
            hits = [e for e in stage_dmas if e.chip == shard.chip]
            for e in hits:
                applied.add(idx_of[id(e)])
            retry_at: dict[int, int] = {}
            analytic_dur, analytic_elems = 0.0, 0
            if hits:
                if shard.mode == "s2":
                    for e in hits:
                        d, el = _s2_retry_price(
                            shard, hw, e.step, e.retries,
                            schedule.backoff_base_cycles)
                        analytic_dur += d
                        analytic_elems += el
                else:
                    n_steps = len(shard.strategy.to_steps())
                    for e in hits:
                        si = min(e.step, n_steps - 1)
                        retry_at[si] = retry_at.get(si, 0) + e.retries
            rep = run_shard(full, shard, hw, retry_at=retry_at or None,
                            backoff_base=schedule.backoff_base_cycles)
            reports.append(rep)
            rep_retry = getattr(rep, "retry_duration", 0.0) + analytic_dur
            rep_retry_el = getattr(rep, "retry_elements", 0) \
                + analytic_elems
            retry_dur_total += rep_retry
            retry_elems_total += rep_retry_el
            measured = rep.total_duration + analytic_dur
            shard_durs[phys[shard.chip]] = measured
            if abs(measured - shard.pad_saved - rep_retry
                   - shard.gross_duration) > _ACC_TOL:
                accounting_ok = False
                findings.append(
                    f"L{gi} chip{shard.chip}: measured duration "
                    f"{measured:g} != gross {shard.gross_duration:g} "
                    f"+ pad_saved {shard.pad_saved:g} "
                    f"+ retries {rep_retry:g}")
            if not rep.correct:
                findings.append(
                    f"L{gi} chip{shard.chip}: shard run incorrect "
                    f"(max_err={rep.max_abs_err:g})")
        for e in stage_dmas:
            if idx_of[id(e)] not in applied:
                applied.add(idx_of[id(e)])
                skipped.append(
                    f"DmaTransient(layer={e.layer}, chip={e.chip}): "
                    f"no shard on that slot")

        assembled, counts = _stitch(lp, reports, ref_shape)
        if inject_corruption == gi:
            assembled[0, 0, 0] = assembled[0, 0, 0] * 2.0 + 1.0
            counts[0, 0, 0] += 1
        if not bool(np.all(counts == 1)):
            counts_ok = False
            findings.append(
                f"L{gi}: exactly-once violated — write counts "
                f"min={int(counts.min())} max={int(counts.max())}")
        ref = reference_conv(full)
        allclose_ok[gi] = not np.any(np.isnan(assembled)) and bool(
            np.allclose(assembled, ref, rtol=_RTOL, atol=_ATOL))
        if not allclose_ok[gi]:
            findings.append(
                f"L{gi}: stitched output diverged from the fault-free "
                f"reference conv")
        committed[gi] = assembled

        att = StageAttempt(
            layer=gi, t0=t, duration=lp.duration,
            phys_chips=tuple(phys),
            retry_duration=retry_dur_total,
            retry_elements=retry_elems_total,
            shard_durations=shard_durs, reports=reports, lp=lp)
        attempts.append(att)
        controller.advance(att.total)
        controller.stage_done(list(phys), gi, shard_durs)
        if controller.stragglers():
            stragglers += 1
        t += att.total
        gi += 1

    t += cur_plan.final_gather_duration

    # any scheduled event that never found its stage (layer out of range)
    for i, e in enumerate(schedule.events):
        if i not in applied:
            skipped.append(f"{type(e).__name__}(layer={e.layer}): layer "
                           f"out of range ({n_layers} layers)")

    return FaultSimReport(
        name=name, schedule=schedule,
        baseline_duration=baseline, faulted_duration=t,
        attempts=attempts, recoveries=recoveries,
        skipped_events=skipped,
        committed=committed, write_counts_ok=counts_ok,
        layer_allclose=allclose_ok, accounting_ok=accounting_ok,
        stragglers_flagged=stragglers,
        findings=findings, plans=plans)
