"""Static plan verifier: prove offload plans legal without simulating.

Every plan the planners emit is a *claim*: a Def-1/2 step sequence per
layer (or per shard), a Def-3 duration, inter-layer reuse savings, shard
geometry and ICI collective prices.  This module re-derives each claim
symbolically — a per-step residency ledger over the formalism's bitmask
semantics, exact tiling/halo geometry checks, a re-pricing of the ICI
schedule, and analytic duration floors — and emits structured
:class:`~repro_torch.analysis.diagnostics.Diagnostic` records instead of
executing anything.

Rule families (see README for the full table):

=====================  ====================================================
``step/semantics``     a1..a6 violation: freeing/writing non-resident data,
                       re-loading resident data, read-before-load
``step/compute``       kernel-not-resident / pixels-not-resident / PE
                       overrun in a computing step
``cover/*``            write-back coverage: every output unit computed and
                       written exactly once, memory empty at the end,
                       kernel groups partition the kernel set
``mem/step-budget``    resident elements exceed ``hw.size_mem`` at some
                       step (held inter-layer activations included)
``dur/ledger``         claimed duration differs from the Def-3 sum over
                       the materialised steps
``dur/floor``          claimed duration beats the analytic roofline /
                       communication floor — a cost-model bug
``reuse/*``            inter-layer reuse: savings exceed measured traffic,
                       producer/consumer flags unpaired, bad row window
``shard/*``            multi-chip geometry: bands / kernel ranges must
                       tile the layer, hybrid grids must match the
                       topology, halo windows must stay in bounds,
                       ``same_pad`` savings must respect their clamps
``ici/conservation``   plan's ICI element counts differ from the
                       topology's re-priced collective schedule
``ici/war-overlap``    an overlapped halo exchange delivers rows after the
                       consumer first reads them — a write-after-read on
                       live input, proved/refuted per band through the
                       ``analysis.access`` timed-delivery model (ERROR:
                       the planner claims it only overlaps sound stages)
=====================  ====================================================

The verifier is intentionally conservative in the same places the
planners are (held activations double-count their first loads, Def-3
footprints are post-step states), so every legal plan passes with zero
error-severity diagnostics — asserted across the preset networks x
clusters x topologies in ``tests/test_verifier*.py``.

Degraded re-plans are not special: when ``repro_torch.resil`` re-plans a
network's tail mid-run (chip death, link degradation, VMEM shrink), the
suffix plan flows through this same verifier unchanged — against the
*degraded* cluster's budget, link price and topology — via the
``verify`` knob ``core.multichip.replan_suffix`` forwards, and
``faultsim`` forces it on.  A recovery plan that only holds on the
healthy machine is exactly the kind of claim this module exists to
reject.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Sequence

from repro_torch.analysis import access
from repro_torch.analysis.diagnostics import (Diagnostic, PlanVerificationError,
                                        Severity, VerificationReport)
from repro_torch.core import multichip as mc
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import (MemoryState, Step, StepError, apply_step,
                                  check_compute_feasible)
from repro_torch.core.network_planner import (LayerPlan, NetworkPlan,
                                        _held_elements, _window_load_saved)
from repro_torch.core.strategies import GroupedStrategy, k_min
from repro_torch.core.strategies_s2 import S2Strategy, s2_lower_bound

_ABS = 1e-6      # duration comparisons: absolute slack (cycles)
_REL = 1e-9


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=_REL, abs_tol=_ABS)


def env_verify_enabled() -> bool:
    """The ``REPRO_VERIFY_PLANS`` knob: truthy values turn the planners'
    opt-in verification postcondition on by default."""
    return os.environ.get("REPRO_VERIFY_PLANS", "").lower() in (
        "1", "true", "yes", "on")


def should_verify(verify: "bool | None") -> bool:
    """Resolve a planner's ``verify`` parameter against the env knob."""
    return env_verify_enabled() if verify is None else verify


# --------------------------------------------------------------------- #
# Step walk: the per-step residency ledger
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class StepWalk:
    """Symbolic execution trace of one strategy's step sequence."""

    durations: list[float]          # weighted Def-3 duration per step
    occupancies: list[int]          # resident elements after each step
    written_cum: list[int]          # output elements written back so far
    diagnostics: list[Diagnostic]
    aborted: bool                   # semantics broke; later checks skipped

    @property
    def total_duration(self) -> float:
        return sum(self.durations)

    @property
    def n_steps(self) -> int:
        return len(self.durations)


def _out_weights(spec: ConvSpec,
                 kernel_groups: "tuple[tuple[int, ...], ...] | None",
                 ) -> "tuple[int, list[int], list[int]]":
    """(number of output units, write-back weight per unit, footprint
    weight per unit).

    S1 output units are patches: one *spatial* write each (Example 2
    convention) draining ``c_out`` resident elements.  S2 units are
    (patch, kernel-group) cells: writes and residency both count the
    group's kernels (cf. ``sim.s2.run_s2``)."""
    if kernel_groups is None:
        n = spec.num_patches
        return n, [1] * n, [spec.c_out] * n
    g_count = len(kernel_groups)
    n = spec.num_patches * g_count
    wb = [len(kernel_groups[u % g_count]) for u in range(n)]
    return n, wb, list(wb)


def _mask_weight(mask: int, weights: list[int]) -> int:
    total = 0
    while mask:
        low = mask & -mask
        u = low.bit_length() - 1
        total += weights[u] if u < len(weights) else 1
        mask ^= low
    return total


def walk_steps(spec: ConvSpec, hw: HardwareModel, steps: Sequence[Step],
               *,
               kernel_groups: "tuple[tuple[int, ...], ...] | None" = None,
               layer: "int | None" = None,
               chip: "int | None" = None) -> StepWalk:
    """Execute the Def-1/2 semantics symbolically over ``steps``.

    Emits ``step/semantics``, ``step/compute`` and ``cover/*``
    diagnostics; returns the per-step duration and occupancy ledgers for
    the caller's budget / floor / ledger rules.  ``kernel_groups`` marks
    an S2 schedule (output units are (patch, kernel-group) cells)."""
    diags: list[Diagnostic] = []
    kelem = spec.c_in * spec.h_k * spec.w_k
    n_units, wb_w, fp_w = _out_weights(spec, kernel_groups)

    if kernel_groups is not None:
        kids = sorted(kid for g in kernel_groups for kid in g)
        if kids != list(range(spec.n_kernels)):
            diags.append(Diagnostic.make(
                "cover/outputs", Severity.ERROR,
                f"kernel groups do not partition the {spec.n_kernels} "
                f"kernels", layer=layer, chip=chip,
                kernel_groups=kernel_groups))

    m = MemoryState()
    computed = written = 0
    durations: list[float] = []
    occupancies: list[int] = []
    written_cum: list[int] = []
    written_elems = 0
    aborted = False
    for idx, s in enumerate(steps):
        dup = s.w & written
        if dup:
            diags.append(Diagnostic.make(
                "cover/write-exactly-once", Severity.ERROR,
                f"{dup.bit_count()} output unit(s) written back twice",
                layer=layer, chip=chip, step=idx, units=dup))
        if s.out & computed:
            diags.append(Diagnostic.make(
                "cover/compute-exactly-once", Severity.ERROR,
                f"{(s.out & computed).bit_count()} output unit(s) "
                f"computed twice", layer=layer, chip=chip, step=idx))
        try:
            m_next = apply_step(m, s)
        except StepError as e:
            if not dup:   # a duplicate write already explains the a3 fault
                diags.append(Diagnostic.make(
                    "step/semantics", Severity.ERROR, str(e),
                    layer=layer, chip=chip, step=idx))
            aborted = True
            break
        try:
            check_compute_feasible(s, spec, hw, m_next)
        except StepError as e:
            diags.append(Diagnostic.make(
                "step/compute", Severity.ERROR, str(e),
                layer=layer, chip=chip, step=idx))
        computed |= s.out
        written |= s.w
        written_elems += _mask_weight(s.w, wb_w)
        load = s.i_slice.bit_count() * hw.t_l \
            + s.k_sub.bit_count() * kelem * hw.t_l
        write = _mask_weight(s.w, wb_w) * hw.t_w
        durations.append(load + write + (hw.t_acc if s.computes else 0.0))
        occupancies.append(m_next.inp.bit_count() * spec.c_in
                           + m_next.ker.bit_count() * kelem
                           + _mask_weight(m_next.out, fp_w))
        written_cum.append(written_elems)
        m = m_next

    if not aborted:
        full = (1 << n_units) - 1
        if computed != full:
            diags.append(Diagnostic.make(
                "cover/outputs", Severity.ERROR,
                f"{(full & ~computed).bit_count()} of {n_units} output "
                f"unit(s) never computed", layer=layer, chip=chip))
        if written != full:
            diags.append(Diagnostic.make(
                "cover/outputs", Severity.ERROR,
                f"{(full & ~written).bit_count()} of {n_units} output "
                f"unit(s) never written back", layer=layer, chip=chip))
        if not m.empty:
            diags.append(Diagnostic.make(
                "cover/memory-empty", Severity.ERROR,
                "on-chip memory not empty after the last step",
                layer=layer, chip=chip,
                residual=m.footprint_elements(spec)))
    return StepWalk(durations=durations, occupancies=occupancies,
                    written_cum=written_cum, diagnostics=diags,
                    aborted=aborted)


def verify_steps(spec: ConvSpec, hw: HardwareModel, steps: Sequence[Step],
                 *,
                 kernel_groups: "tuple[tuple[int, ...], ...] | None" = None,
                 held_elements: int = 0,
                 outputs_stay_resident: bool = False,
                 layer: "int | None" = None,
                 chip: "int | None" = None,
                 subject: str = "steps") -> VerificationReport:
    """Verify a raw step sequence: semantics, coverage, and the per-step
    memory budget (``held_elements`` rides along at every step; with
    ``outputs_stay_resident`` written-back outputs keep occupying memory,
    the producer side of inter-layer reuse)."""
    report = VerificationReport(subject=subject)
    walk = walk_steps(spec, hw, steps, kernel_groups=kernel_groups,
                      layer=layer, chip=chip)
    report.extend(walk.diagnostics)
    report.checked_steps += walk.n_steps
    _check_budget(report, walk, hw, held_elements=held_elements,
                  outputs_stay_resident=outputs_stay_resident,
                  layer=layer, chip=chip)
    return report


def _check_budget(report: VerificationReport, walk: StepWalk,
                  hw: HardwareModel, *, held_elements: int,
                  outputs_stay_resident: bool,
                  layer: "int | None", chip: "int | None") -> None:
    if hw.size_mem is None:
        return
    for idx, occ in enumerate(walk.occupancies):
        extra = held_elements
        if outputs_stay_resident:
            extra += walk.written_cum[idx]
        if occ + extra > hw.size_mem:
            report.add(Diagnostic.make(
                "mem/step-budget", Severity.ERROR,
                f"resident elements {occ + extra} exceed "
                f"size_mem={hw.size_mem}",
                layer=layer, chip=chip, step=idx,
                occupancy=occ, held=extra, size_mem=hw.size_mem))


# --------------------------------------------------------------------- #
# Analytic duration floors
# --------------------------------------------------------------------- #

def strategy_floor(strategy, hw: HardwareModel) -> float:
    """Analytic lower bound on a strategy's *full* Def-3 duration: every
    needed pixel and every kernel element loaded at least once, every
    output written once, and at least ``ceil(units / PE capacity)``
    compute steps.  Any plan claiming less carries a cost-model bug."""
    spec = strategy.spec
    needed = spec.all_pixels_mask.bit_count()
    if isinstance(strategy, S2Strategy):
        return s2_lower_bound(spec, hw) \
            + spec.num_patches * spec.c_out * hw.t_w
    try:
        p_cap = hw.nb_patches_max_s1(spec.nb_op_value, spec.c_out)
    except ValueError:
        p_cap = 1        # PE-infeasible S1: step/compute flags it; the
        #                  floor stays a valid (weaker) bound
    p_cap = max(1, min(p_cap, spec.num_patches))
    return (hw.t_l * (needed + spec.kernel_elements)
            + k_min(spec, p_cap) * hw.t_acc
            + spec.num_patches * hw.t_w)


# --------------------------------------------------------------------- #
# LayerPlan / NetworkPlan
# --------------------------------------------------------------------- #

def _verify_layer_plan(report: VerificationReport, lp: LayerPlan,
                       hw: HardwareModel, *, held_in: int,
                       held_out: int = 0) -> None:
    strat = lp.strategy
    spec = lp.spec
    kernel_groups = strat.kernel_groups \
        if isinstance(strat, S2Strategy) else None
    walk = walk_steps(spec, hw, strat.to_steps(),
                      kernel_groups=kernel_groups, layer=lp.index)
    report.extend(walk.diagnostics)
    report.checked_layers += 1
    report.checked_steps += walk.n_steps
    _check_budget(report, walk, hw, held_elements=held_in + held_out,
                  outputs_stay_resident=lp.reuse_output,
                  layer=lp.index, chip=None)

    if not walk.aborted and not _close(walk.total_duration,
                                       lp.gross_duration):
        report.add(Diagnostic.make(
            "dur/ledger", Severity.ERROR,
            f"claimed gross duration {lp.gross_duration:g} != Def-3 step "
            f"sum {walk.total_duration:g}", layer=lp.index,
            claimed=lp.gross_duration, ledger=walk.total_duration))

    # reuse savings clamps: never save more than the measured traffic
    first_load = strat.first_load_duration(hw)
    wb = strat.write_back_duration(hw)
    if lp.input_load_saved > first_load + _ABS:
        report.add(Diagnostic.make(
            "reuse/savings-clamp", Severity.ERROR,
            f"input_load_saved {lp.input_load_saved:g} exceeds first-load "
            f"traffic {first_load:g}", layer=lp.index))
    if lp.window_rows:
        if not spec.h_k <= lp.window_rows <= spec.h_in:
            report.add(Diagnostic.make(
                "reuse/window", Severity.ERROR,
                f"row window {lp.window_rows} outside "
                f"[h_k={spec.h_k}, h_in={spec.h_in}]", layer=lp.index))
        win_cap = _window_load_saved(spec, min(lp.window_rows, spec.h_in),
                                     hw)
        if lp.input_load_saved > win_cap + _ABS:
            report.add(Diagnostic.make(
                "reuse/savings-clamp", Severity.ERROR,
                f"window saving {lp.input_load_saved:g} exceeds the "
                f"window rows' needed pixels {win_cap:g}", layer=lp.index))
    if lp.input_load_saved and not (lp.reuse_input or lp.window_rows):
        report.add(Diagnostic.make(
            "reuse/savings-clamp", Severity.ERROR,
            f"input_load_saved {lp.input_load_saved:g} without a reuse "
            f"source", layer=lp.index))
    if lp.write_back_saved > (wb if lp.reuse_output else 0.0) + _ABS:
        report.add(Diagnostic.make(
            "reuse/savings-clamp", Severity.ERROR,
            f"write_back_saved {lp.write_back_saved:g} exceeds write-back "
            f"traffic {wb if lp.reuse_output else 0.0:g}", layer=lp.index))

    floor = strategy_floor(strat, hw)
    if lp.gross_duration < floor - _ABS:
        report.add(Diagnostic.make(
            "dur/floor", Severity.ERROR,
            f"gross duration {lp.gross_duration:g} beats the analytic "
            f"floor {floor:g} — cost-model bug", layer=lp.index,
            floor=floor, claimed=lp.gross_duration))


def _held_in_elements(plan: NetworkPlan, i: int) -> int:
    """Elements layer ``i`` holds for its upstream reuse while executing."""
    lp = plan.layers[i]
    if lp.reuse_input and i > 0:
        return _held_elements(plan.layers[i - 1].spec, lp.spec)
    if lp.window_rows:
        return lp.window_rows * lp.spec.w_in * lp.spec.c_in
    return 0


def verify_network_plan(plan: NetworkPlan) -> VerificationReport:
    """Symbolically verify every layer of a single-chip network plan plus
    the plan-level reuse pairing and duration recomposition."""
    report = VerificationReport(subject=f"network:{plan.name}")
    hw = plan.hw
    for i, lp in enumerate(plan.layers):
        # a row-window cascade retains the consumer's window while the
        # producer still executes (the window is a copy: the producer
        # keeps writing back) — charge it on the producer side too.
        held_out = 0
        if i + 1 < len(plan.layers) and plan.layers[i + 1].window_rows:
            nxt_spec = plan.layers[i + 1].spec
            held_out = plan.layers[i + 1].window_rows \
                * nxt_spec.w_in * nxt_spec.c_in
        _verify_layer_plan(report, lp, hw,
                           held_in=_held_in_elements(plan, i),
                           held_out=held_out)
        # reuse flags must pair up across adjacent layers
        nxt = plan.layers[i + 1] if i + 1 < len(plan.layers) else None
        if lp.reuse_output != (nxt is not None and nxt.reuse_input):
            report.add(Diagnostic.make(
                "reuse/pairing", Severity.ERROR,
                "reuse_output without a consuming reuse_input downstream"
                if lp.reuse_output else
                "reuse_input without a producing reuse_output upstream",
                layer=lp.index))
        if i == 0 and (lp.reuse_input or lp.window_rows):
            report.add(Diagnostic.make(
                "reuse/pairing", Severity.ERROR,
                "first layer cannot reuse an upstream activation",
                layer=lp.index))

    total = sum(lp.duration for lp in plan.layers)
    gross = sum(lp.gross_duration for lp in plan.layers)
    if not _close(total, plan.total_duration):
        report.add(Diagnostic.make(
            "plan/total", Severity.ERROR,
            f"total_duration {plan.total_duration:g} != sum of layer "
            f"durations {total:g}"))
    if not _close(gross, plan.gross_duration):
        report.add(Diagnostic.make(
            "plan/total", Severity.ERROR,
            f"gross_duration {plan.gross_duration:g} != sum of layer "
            f"gross durations {gross:g}"))
    return report


# --------------------------------------------------------------------- #
# MultiChipPlan
# --------------------------------------------------------------------- #

def _expected_band_spec(spec: ConvSpec, rows: int,
                        n_kernels: "int | None" = None) -> ConvSpec:
    sub = dataclasses.replace(spec, h_in=(rows - 1) * spec.s_h + spec.h_k)
    if n_kernels is not None:
        sub = dataclasses.replace(sub, n_kernels=n_kernels)
    return sub


def _check_bands_tile(report: VerificationReport, layer: int,
                      bands: "list[tuple[int, int]]", h_out: int) -> None:
    bands = sorted(bands)
    pos = 0
    ok = True
    for r0, r1 in bands:
        if r0 != pos or r1 <= r0:
            ok = False
            break
        pos = r1
    if not ok or pos != h_out:
        report.add(Diagnostic.make(
            "shard/band-tiling", Severity.ERROR,
            f"row bands {bands} do not tile [0, {h_out})", layer=layer,
            bands=tuple(bands), h_out=h_out))


def _check_kranges_tile(report: VerificationReport, layer: int,
                        kranges: "list[tuple[int, int]]",
                        n_kernels: int) -> None:
    kranges = sorted(kranges)
    pos = 0
    ok = True
    for k0, k1 in kranges:
        if k0 != pos or k1 <= k0:
            ok = False
            break
        pos = k1
    if not ok or pos != n_kernels:
        report.add(Diagnostic.make(
            "shard/kernel-tiling", Severity.ERROR,
            f"kernel ranges {kranges} do not tile [0, {n_kernels})",
            layer=layer, kranges=tuple(kranges), n_kernels=n_kernels))


def _verify_shard(report: VerificationReport, layer: int,
                  shard: mc.ShardPlan, layer_spec: ConvSpec,
                  hw: HardwareModel) -> "StepWalk | None":
    strat = shard.strategy
    kernel_groups = strat.kernel_groups \
        if isinstance(strat, S2Strategy) else None
    walk = walk_steps(shard.spec, hw, strat.to_steps(),
                      kernel_groups=kernel_groups,
                      layer=layer, chip=shard.chip)
    report.extend(walk.diagnostics)
    report.checked_steps += walk.n_steps
    _check_budget(report, walk, hw, held_elements=0,
                  outputs_stay_resident=False, layer=layer,
                  chip=shard.chip)

    # gross excludes the same_pad credit; the ledger must recompose it
    if not walk.aborted and not _close(
            walk.total_duration, shard.gross_duration + shard.pad_saved):
        report.add(Diagnostic.make(
            "dur/ledger", Severity.ERROR,
            f"shard gross {shard.gross_duration:g} + pad_saved "
            f"{shard.pad_saved:g} != Def-3 step sum "
            f"{walk.total_duration:g}", layer=layer, chip=shard.chip,
            ledger=walk.total_duration))

    r0, r1 = shard.out_rows if shard.out_rows is not None \
        else (0, layer_spec.h_out)
    if shard.pad_saved < -_ABS:
        report.add(Diagnostic.make(
            "shard/pad-clamp", Severity.ERROR,
            f"negative pad_saved {shard.pad_saved:g}", layer=layer,
            chip=shard.chip))
    elif shard.pad_saved > _ABS:
        cap = min(
            mc.band_pad_rows(layer_spec, r0, r1) * layer_spec.w_in * hw.t_l,
            strat.first_load_duration(hw))
        if shard.pad_saved > cap + _ABS:
            report.add(Diagnostic.make(
                "shard/pad-clamp", Severity.ERROR,
                f"pad_saved {shard.pad_saved:g} exceeds the band's padding "
                f"rows' first-load traffic {cap:g}", layer=layer,
                chip=shard.chip, cap=cap))

    floor = strategy_floor(strat, hw)
    if shard.gross_duration + shard.pad_saved < floor - _ABS:
        report.add(Diagnostic.make(
            "dur/floor", Severity.ERROR,
            f"shard duration {shard.gross_duration:g} (+pad "
            f"{shard.pad_saved:g}) beats the analytic floor {floor:g} — "
            f"cost-model bug", layer=layer, chip=shard.chip, floor=floor))
    return walk


def _shard_spec_mismatch(report: VerificationReport, layer: int,
                         shard: mc.ShardPlan, want: ConvSpec) -> None:
    if shard.spec != want:
        report.add(Diagnostic.make(
            "shard/grid", Severity.ERROR,
            f"shard spec {shard.spec} is not the expected halo-extended "
            f"sub-convolution {want}", layer=layer, chip=shard.chip))


def _check_overlap_war(report: VerificationReport, layer: int,
                       lp: mc.MultiChipLayerPlan,
                       walks: "dict[int, StepWalk]") -> None:
    """An overlapped stage prices at max(compute, ICI): the inbound halo
    streams while the consumer computes.  The halo rows are live input —
    a band that reads them before the exchange can have delivered them
    has a write-after-read hazard, and the overlap claim is unsound.

    Precise verdict through the happens-before timing model
    (:mod:`repro_torch.analysis.access`): the exchange is one timed transfer
    completing at ``ici_duration`` into each receiving band's halo rows;
    every step that touches those rows is a timed read at its Def-3
    start offset.  Since the planner only marks a stage overlapped after
    proving the window safe (``core.multichip.halo_first_use``), any
    violation here is a planner soundness bug — an ERROR, no longer an
    advisory warning."""
    bands = sorted((s.out_rows, s) for s in lp.shards
                   if s.out_rows is not None)
    last_r1 = bands[-1][0][1] if bands else None
    for (r0, r1), shard in bands:
        if r1 == last_r1:
            continue                      # bottom band: no lower neighbour
        sspec = shard.spec
        halo_rows = max(0, sspec.h_k - sspec.s_h)
        if halo_rows == 0:
            continue
        walk = walks.get(shard.chip)
        if walk is None or walk.aborted:
            continue
        tensor = f"chip{shard.chip}/x"
        dst = access.box_region(
            tensor, (sspec.h_in - halo_rows, sspec.h_in),
            (0, sspec.w_in))
        reads = []
        t = 0.0
        for dur, s in zip(walk.durations, shard.strategy.to_steps()):
            if s.i_slice:
                lo_row = ((s.i_slice & -s.i_slice).bit_length() - 1) \
                    // sspec.w_in
                hi_row = (s.i_slice.bit_length() - 1) // sspec.w_in + 1
                reads.append((t, access.box_region(
                    tensor, (lo_row, hi_row), (0, sspec.w_in))))
            t += dur
        v = access.first_violation_or_none(
            [(lp.ici_duration, dst)], reads)
        if v is not None:
            report.add(Diagnostic.make(
                "ici/war-overlap", Severity.ERROR,
                f"overlapped halo exchange completes at "
                f"t={v.complete_time:g} but the band reads its halo rows "
                f"at t={v.read_time:g} — write-after-read on the live "
                f"input window; this stage cannot price "
                f"max(compute, ICI)",
                layer=layer, chip=shard.chip,
                first_use=v.read_time, ici_duration=lp.ici_duration))


def verify_multichip_plan(plan: mc.MultiChipPlan) -> VerificationReport:
    """Symbolically verify a cluster schedule: every shard's step walk,
    the shard-grid tiling geometry, the re-priced ICI schedule, duration
    floors, and the total recomposition."""
    report = VerificationReport(subject=f"multichip:{plan.name}")
    cluster = plan.cluster
    hw = cluster.chip

    if plan.network_plan is not None:
        # 1-chip delegation: the embedded NetworkPlan carries the truth
        inner = verify_network_plan(plan.network_plan)
        report.extend(inner.diagnostics)
        report.checked_layers += inner.checked_layers
        report.checked_steps += inner.checked_steps
        if not _close(plan.total_duration,
                      plan.network_plan.total_duration):
            report.add(Diagnostic.make(
                "plan/total", Severity.ERROR,
                f"1-chip total {plan.total_duration:g} != delegated "
                f"network total {plan.network_plan.total_duration:g}"))
        return report

    grid = cluster.topo.grid(cluster.n_chips)
    t_ici = cluster.t_ici
    prev_mode: "str | None" = None
    for lp in plan.layers:
        spec = lp.spec
        report.checked_layers += 1
        walks: dict[int, StepWalk] = {}
        chips = [s.chip for s in lp.shards]
        if len(set(chips)) != len(chips) or not lp.shards:
            report.add(Diagnostic.make(
                "shard/grid", Severity.ERROR,
                f"shards map to duplicate chips {chips}", layer=lp.index))
        for shard in lp.shards:
            walk = _verify_shard(report, lp.index, shard, spec, hw)
            if walk is not None:
                walks[shard.chip] = walk

        if lp.mode == "replicate":
            if len(lp.shards) != 1:
                report.add(Diagnostic.make(
                    "shard/grid", Severity.ERROR,
                    f"replicate with {len(lp.shards)} shards",
                    layer=lp.index))
            for shard in lp.shards:
                _shard_spec_mismatch(report, lp.index, shard, spec)
        elif lp.mode == "row":
            bands = []
            for shard in lp.shards:
                if shard.out_rows is None:
                    report.add(Diagnostic.make(
                        "shard/band-tiling", Severity.ERROR,
                        "row shard without an output-row band",
                        layer=lp.index, chip=shard.chip))
                    continue
                r0, r1 = shard.out_rows
                bands.append((r0, r1))
                _shard_spec_mismatch(report, lp.index, shard,
                                     _expected_band_spec(spec, r1 - r0))
            _check_bands_tile(report, lp.index, bands, spec.h_out)
        elif lp.mode == "channel":
            kranges = []
            for shard in lp.shards:
                if shard.kernel_range is None:
                    report.add(Diagnostic.make(
                        "shard/kernel-tiling", Severity.ERROR,
                        "channel shard without a kernel range",
                        layer=lp.index, chip=shard.chip))
                    continue
                k0, k1 = shard.kernel_range
                kranges.append((k0, k1))
                _shard_spec_mismatch(
                    report, lp.index, shard,
                    dataclasses.replace(spec, n_kernels=k1 - k0))
            _check_kranges_tile(report, lp.index, kranges, spec.n_kernels)
        elif lp.mode == "hybrid":
            if lp.grid != grid:
                report.add(Diagnostic.make(
                    "shard/grid", Severity.ERROR,
                    f"hybrid grid {lp.grid} != topology grid {grid}",
                    layer=lp.index))
            cells = set()
            bands_set, kranges_set = set(), set()
            for shard in lp.shards:
                if shard.out_rows is None or shard.kernel_range is None:
                    report.add(Diagnostic.make(
                        "shard/grid", Severity.ERROR,
                        "hybrid shard missing its band or kernel range",
                        layer=lp.index, chip=shard.chip))
                    continue
                bands_set.add(shard.out_rows)
                kranges_set.add(shard.kernel_range)
                cells.add((shard.out_rows, shard.kernel_range))
                r0, r1 = shard.out_rows
                k0, k1 = shard.kernel_range
                _shard_spec_mismatch(
                    report, lp.index, shard,
                    _expected_band_spec(spec, r1 - r0, n_kernels=k1 - k0))
            _check_bands_tile(report, lp.index, sorted(bands_set),
                              spec.h_out)
            _check_kranges_tile(report, lp.index, sorted(kranges_set),
                                spec.n_kernels)
            if len(cells) != len(bands_set) * len(kranges_set):
                report.add(Diagnostic.make(
                    "shard/grid", Severity.ERROR,
                    f"hybrid shards cover {len(cells)} of the "
                    f"{len(bands_set)}x{len(kranges_set)} grid cells",
                    layer=lp.index))
        else:
            report.add(Diagnostic.make(
                "shard/grid", Severity.ERROR,
                f"unknown sharding mode {lp.mode!r}", layer=lp.index))

        # halo windows must stay inside the layer's (padded) input
        for shard in lp.shards:
            if shard.out_rows is None:
                continue
            r0, _ = shard.out_rows
            h0 = r0 * spec.s_h
            if h0 < 0 or h0 + shard.spec.h_in > spec.h_in:
                report.add(Diagnostic.make(
                    "shard/halo-source", Severity.ERROR,
                    f"band input window [{h0}, {h0 + shard.spec.h_in}) "
                    f"leaves the input [0, {spec.h_in}) — no neighbour "
                    f"holds those rows", layer=lp.index, chip=shard.chip))

        compute = max((s.gross_duration for s in lp.shards), default=0.0)
        if not _close(compute, lp.compute_duration):
            report.add(Diagnostic.make(
                "dur/ledger", Severity.ERROR,
                f"compute_duration {lp.compute_duration:g} != max over "
                f"shards {compute:g}", layer=lp.index))
        if not _close(lp.ici_duration, lp.ici_elements * t_ici):
            report.add(Diagnostic.make(
                "ici/conservation", Severity.ERROR,
                f"ici_duration {lp.ici_duration:g} != ici_elements "
                f"{lp.ici_elements} * t_ici {t_ici:g}", layer=lp.index))
        if lp.savings:
            report.add(Diagnostic.make(
                "reuse/savings-clamp", Severity.ERROR,
                f"sharded layer claims inter-layer savings "
                f"{lp.savings:g} (multi-chip residency is not modelled)",
                layer=lp.index))

        if lp.overlap and prev_mode == "row" and lp.mode == "row" \
                and lp.ici_elements == mc.halo_elements(spec) \
                and lp.ici_elements > 0:
            _check_overlap_war(report, lp.index, lp, walks)
        prev_mode = lp.mode

    # ICI re-pricing: element conservation against the pure schedule fn
    specs = [lp.spec for lp in plan.layers]
    modes = [lp.mode for lp in plan.layers]
    active = [lp.active_chips for lp in plan.layers]
    per_layer, final = mc.ici_schedule(specs, modes, active, cluster)
    for lp, want in zip(plan.layers, per_layer):
        if lp.ici_elements != want:
            report.add(Diagnostic.make(
                "ici/conservation", Severity.ERROR,
                f"inbound ICI {lp.ici_elements} elements != re-priced "
                f"collective schedule {want}", layer=lp.index,
                claimed=lp.ici_elements, repriced=want))
    if plan.final_gather_elements != final:
        report.add(Diagnostic.make(
            "ici/conservation", Severity.ERROR,
            f"final gather {plan.final_gather_elements} elements != "
            f"re-priced {final}", claimed=plan.final_gather_elements,
            repriced=final))
    if not _close(plan.final_gather_duration,
                  plan.final_gather_elements * t_ici):
        report.add(Diagnostic.make(
            "ici/conservation", Severity.ERROR,
            f"final gather duration {plan.final_gather_duration:g} != "
            f"elements {plan.final_gather_elements} * t_ici {t_ici:g}"))

    total = sum(lp.duration for lp in plan.layers) \
        + plan.final_gather_duration
    if not _close(total, plan.total_duration):
        report.add(Diagnostic.make(
            "plan/total", Severity.ERROR,
            f"total_duration {plan.total_duration:g} != stage sum + final "
            f"gather {total:g}"))
    return report


# --------------------------------------------------------------------- #
# Planner postcondition
# --------------------------------------------------------------------- #

def assert_verified(plan) -> VerificationReport:
    """Verify ``plan`` (NetworkPlan or MultiChipPlan); raise
    :class:`PlanVerificationError` on any error-severity diagnostic."""
    if isinstance(plan, NetworkPlan):
        report = verify_network_plan(plan)
    elif isinstance(plan, mc.MultiChipPlan):
        report = verify_multichip_plan(plan)
    else:
        raise TypeError(f"cannot verify {type(plan).__name__}")
    if not report.ok:
        raise PlanVerificationError(report)
    return report
