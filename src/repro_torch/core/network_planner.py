"""Network-level offloading planner (beyond-paper: whole-CNN scheduling).

The paper (and ``core.solver``) optimises ONE convolution layer.  A real
workload is a *network* — an ordered sequence of conv layers (LeNet-5,
ResNet-8, ... in ``repro_torch.configs``).  This module plans the whole sequence:

  1. every layer is solved with the Sec-5/7 machinery (heuristic seeds +
     multi-restart parallel polish, optional MILP) through an LRU cache, so
     repeated layer shapes (ResNet stages) are solved once;
  2. layer durations use the *full* Def-3 accounting — eq. 15 plus the
     kernel load and the output write-back that the paper's single-layer
     experiments exclude — because at network level the write-back of layer
     l and the input load of layer l+1 are exactly the terms inter-layer
     scheduling can remove;
  3. when the activation between two layers fits the on-chip budget next to
     the successor's working set, the HBM round trip is skipped: layer l
     keeps its outputs resident (no write-back) and layer l+1 reads each of
     its input pixels' *first* load from on-chip memory (reloads beyond the
     first still hit DRAM).  This is the layer-cascade reuse of
     Stoutchinin et al. / Jokic et al. transplanted onto the paper's
     formalism.  Elementwise ops between convs (ReLU, pooling) are assumed
     fused on-chip and free, per the usual accelerator dataflow.

Memory feasibility — the S1/S2 selection rule
--------------------------------------------
Every planned strategy must satisfy ``peak_footprint_elements() <=
hw.size_mem``.  Per layer, ``solver.solve_cached`` applies the rule:

  * solve S1 at the largest group size ``p' <= p`` whose contiguous
    strategy fits the budget (``solver.s1_max_feasible_p``);
  * when the budget forced ``p' < p`` — or no S1 group size fits at all,
    e.g. the kernel set Λ alone exceeds ``size_mem`` — price the S2
    kernel-group-swapping alternative (``strategies_s2.best_s2``, the
    paper's Sec-9 future-work regime) with the same full Def-3 accounting
    and keep the cheaper feasible one.

Both strategy families expose one protocol (``n_steps``, ``objective``,
``full_duration``, ``write_back_duration``, ``first_load_duration``,
``peak_footprint_elements``, ``peak_working_set_elements``,
``max_group_size``), so everything downstream — reuse gating, duration
accounting, simulation, benchmarks — treats them polymorphically.
``plan_network`` raises :class:`InfeasibleNetworkError` instead of ever
returning a plan whose peak footprint exceeds the budget.

Row-window (partial) cascading
------------------------------
When the full activation does not fit next to a neighbour's working set,
the planner falls back to holding only a *row window* of the consumer's
input on-chip: ``W`` rows (``W * w_in * c_in`` elements) stay resident,
saving the first loads of exactly those rows' pixels.  The fit condition is

    W * w_in * c_in  <=  size_mem - max(producer peak working set,
                                        consumer peak footprint)

with ``W >= h_k`` (at least one halo-extended output-row window, following
Stoutchinin et al.'s layer-cascade scheduling); the producer still writes
every output back (the window is a retained copy), so only consumer-side
first loads are saved.  Savings are always clamped to the consumer
strategy's measured first-load traffic and every ``LayerPlan.duration`` is
asserted non-negative.

``plan_network`` returns a ``NetworkPlan`` with per-layer strategies, the
aggregate predicted duration, the per-layer-greedy baseline (no reuse, no
polish — what a layer-at-a-time compiler would emit, under the same
feasibility rule), and a critical-path report naming the layers that
dominate the schedule.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence, Union

from repro_torch.core import solver as solver_mod
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.strategies import GroupedStrategy, row_by_row, zigzag
from repro_torch.core.strategies_s2 import S2Strategy

Strategy = Union[GroupedStrategy, S2Strategy]


class InfeasibleNetworkError(ValueError):
    """No strategy family fits a layer under ``hw.size_mem``."""


def resolve_group_size(spec: ConvSpec, hw: HardwareModel,
                       max_group: int | None = 16) -> int:
    """nb_patches_max_S1 (Sec 4.2) clipped to the patch count and to an
    optional planning cap (huge PEs would otherwise allow one giant group,
    which blows up the tiled-shape enumeration without helping reuse).
    Returns 1 when the PE cannot take one full S1 patch row — the solver
    then falls back to S2 kernel-group swapping."""
    try:
        p = hw.nb_patches_max_s1(spec.nb_op_value, spec.c_out)
    except ValueError:
        return 1
    p = min(p, spec.num_patches)
    if max_group is not None:
        p = min(p, max_group)
    return max(1, p)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's slot in the network schedule."""

    index: int
    spec: ConvSpec
    p: int
    result: solver_mod.SolveResult
    reuse_input: bool       # ALL first loads arrive from the previous layer
    reuse_output: bool      # output held on-chip for the next layer (no wb)
    window_rows: int        # >0: only this many input rows held (partial)
    gross_duration: float   # full Def-3 duration, no inter-layer reuse
    input_load_saved: float  # t_l saved on first loads (full or window)
    write_back_saved: float  # t_w saved when reuse_output

    def __post_init__(self):
        if self.duration < -1e-9:
            raise AssertionError(
                f"layer {self.index}: negative net duration "
                f"{self.duration} (gross {self.gross_duration}, "
                f"in_saved {self.input_load_saved}, "
                f"wb_saved {self.write_back_saved})")

    @property
    def strategy(self) -> Strategy:
        return self.result.strategy

    @property
    def mode(self) -> str:
        """'s1' or 's2' (kernel-group swapping fallback)."""
        return self.result.mode

    @property
    def duration(self) -> float:
        """Net contribution to the network schedule."""
        return self.gross_duration - self.input_load_saved \
            - self.write_back_saved


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """A solved whole-network offloading schedule."""

    name: str
    hw: HardwareModel
    layers: tuple[LayerPlan, ...]
    total_duration: float        # with inter-layer reuse
    gross_duration: float        # same strategies, no reuse
    baseline_duration: float     # per-layer greedy: best heuristic, no reuse
    planning_seconds: float
    solver_calls: int
    cache_hits: int

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def n_s2_layers(self) -> int:  # lint: public-api
        return sum(1 for lp in self.layers if lp.mode == "s2")

    @property
    def peak_footprint(self) -> int:
        return max(lp.strategy.peak_footprint_elements() for lp in self.layers)

    @property
    def gain_vs_baseline(self) -> float:
        if self.baseline_duration == 0:
            return 0.0
        return 1.0 - self.total_duration / self.baseline_duration

    @property
    def layers_per_second(self) -> float:
        if self.planning_seconds <= 0:
            return float("inf")
        return self.n_layers / self.planning_seconds

    def critical_path(self) -> list[tuple[int, float, float]]:
        """(layer index, duration, fraction of total) sorted by duration
        descending — the layers to attack next."""
        total = self.total_duration or 1.0
        rows = [(lp.index, lp.duration, lp.duration / total)
                for lp in self.layers]
        return sorted(rows, key=lambda r: -r[1])

    def report(self) -> str:
        lines = [f"network plan: {self.name}  "
                 f"({self.n_layers} layers, planned in "
                 f"{self.planning_seconds:.2f}s, "
                 f"{self.layers_per_second:.1f} layers/s, "
                 f"{self.cache_hits}/{self.solver_calls} cache hits)"]
        for lp in self.layers:
            tags = []
            if lp.reuse_input:
                tags.append("in<-chip")
            elif lp.window_rows:
                tags.append(f"win{lp.window_rows}<-chip")
            if lp.reuse_output:
                tags.append("out->chip")
            lines.append(
                f"  L{lp.index}: {lp.spec.c_in}x{lp.spec.h_in}x{lp.spec.w_in}"
                f" -> {lp.spec.c_out}x{lp.spec.h_out}x{lp.spec.w_out}"
                f"  p={lp.p} steps={lp.strategy.n_steps}"
                f" strat={lp.strategy.name}"
                f" dur={lp.duration:g}"
                f" (gross {lp.gross_duration:g})"
                f" gap={lp.result.gap:.1%}"
                f"{('  [' + ','.join(tags) + ']') if tags else ''}")
        crit = self.critical_path()[0]
        lines.append(
            f"  total={self.total_duration:g} (gross {self.gross_duration:g},"
            f" greedy baseline {self.baseline_duration:g},"
            f" gain {self.gain_vs_baseline:.1%});"
            f" critical layer L{crit[0]} ({crit[2]:.0%} of total)")
        return "\n".join(lines)


# --------------------------------------------------------------------- #
# Inter-layer reuse feasibility
# --------------------------------------------------------------------- #

def _held_elements(prev: ConvSpec, nxt: ConvSpec) -> int:
    """Resident elements of a fully held activation: the larger of prev's
    output map and nxt's input map (pooling/padding between them happens
    on-chip)."""
    return max(prev.num_patches * prev.c_out, nxt.num_pixels * nxt.c_in)


def activation_fits(prev: ConvSpec, prev_strategy: Strategy,
                    nxt: ConvSpec, nxt_strategy: Strategy,
                    hw: HardwareModel,
                    producer_extra_held: int = 0) -> bool:
    """Can layer ``prev``'s output stay fully resident until ``nxt``
    consumed it?

    Both ends must fit, using the unified strategy-protocol accounting:
    while ``prev`` executes, the accumulating held map (no longer drained
    by write-backs) coexists with prev's peak *working set* — for S2
    producers that is the largest (input pixels + swapped kernel group) of
    any step, so S2 layers keep producer-side residency only when the held
    map fits next to the swapped kernel groups; while ``nxt`` executes,
    the held activation coexists with nxt's peak footprint.

    ``producer_extra_held`` counts elements already resident while
    ``prev`` executes — its own held *input* map when the previous pair
    also reuses (a middle layer holds both maps at once).
    ``size_mem=None`` is the paper's unconstrained Sec-7.1 setting:
    always fits.
    """
    if hw.size_mem is None:
        return True
    held = _held_elements(prev, nxt)
    producer_ok = (held + producer_extra_held
                   + prev_strategy.peak_working_set_elements()
                   <= hw.size_mem)
    consumer_ok = held + nxt_strategy.peak_footprint_elements() \
        <= hw.size_mem
    return producer_ok and consumer_ok


def row_window_rows(prev: ConvSpec, prev_strategy: Strategy,
                    nxt: ConvSpec, nxt_strategy: Strategy,
                    hw: HardwareModel,
                    producer_extra_held: int = 0) -> int:
    """Partial (row-window) cascading: how many of the consumer's input
    rows can stay resident when the full activation does not fit.

    The window (``W * w_in * c_in`` elements) must coexist with the
    producer's peak *footprint* while the producer finishes (in the window
    regime the producer still drains outputs through write-backs, so its
    output buffers stay resident — unlike full residency where they
    accumulate into the held map) AND with the consumer's peak footprint
    while it is consumed; it must cover at least one halo-extended
    output-row window (``h_k`` input rows).  ``producer_extra_held`` is
    the producer's own held input map, as in :func:`activation_fits`.
    Returns 0 when no admissible window exists."""
    if hw.size_mem is None:
        return 0                      # full residency always fits
    per_row = nxt.w_in * nxt.c_in
    spare = hw.size_mem - max(
        prev_strategy.peak_footprint_elements() + producer_extra_held,
        nxt_strategy.peak_footprint_elements())
    if spare < per_row:
        return 0
    rows = min(spare // per_row, nxt.h_in)
    return rows if rows >= nxt.h_k else 0


def _window_load_saved(nxt: ConvSpec, rows: int, hw: HardwareModel) -> float:
    """t_l saved by serving the first ``rows`` input rows' first loads
    from the held window (only pixels some patch actually needs count)."""
    mask = (1 << (rows * nxt.w_in)) - 1
    return (mask & nxt.all_pixels_mask).bit_count() * hw.t_l


# --------------------------------------------------------------------- #
# Baselines
# --------------------------------------------------------------------- #

def greedy_feasible_strategy(spec: ConvSpec, p: int,
                             hw: HardwareModel) -> Strategy:
    """Per-layer-greedy choice under the memory-feasibility rule: best of
    the paper's two heuristics (Row-by-Row / ZigZag) at the largest
    budget-feasible group size, else the S2 kernel-group-swapping
    fallback.  Raises :class:`InfeasibleNetworkError` when nothing fits."""
    p_fit = solver_mod.s1_max_feasible_p(spec, p, hw)
    if p_fit is not None:
        cands = [row_by_row(spec, p_fit), zigzag(spec, p_fit)]
        if hw.size_mem is not None:
            cands = [s for s in cands
                     if s.peak_footprint_elements() <= hw.size_mem]
        if cands:
            return min(cands, key=lambda s: s.objective(hw))
    try:
        res = solver_mod.best_s2_cached(spec, hw)
        # the baseline is polish-free by definition: use the enumeration
        # winner, not the polished/MILP-certified strategy
        return res.seed_strategy if res.seed_strategy is not None \
            else res.strategy
    except ValueError as e:
        raise InfeasibleNetworkError(
            f"no S1 or S2 strategy fits size_mem={hw.size_mem} "
            f"for layer {spec}") from e


def greedy_network_duration(specs: Sequence[ConvSpec], hw: HardwareModel,
                            p: int | Sequence[int] | None = None,
                            max_group: int | None = 16) -> float:
    """Per-layer-greedy baseline: every layer takes the best *feasible*
    heuristic (Row-by-Row / ZigZag, shrunk to fit the budget, or the S2
    fallback), no polish, no MILP, and every activation makes the full HBM
    round trip (write-back + reload).  Raises
    :class:`InfeasibleNetworkError` instead of pricing an infeasible
    schedule."""
    ps = _resolve_ps(specs, hw, p, max_group)
    return sum(greedy_feasible_strategy(spec, pp, hw).full_duration(hw)
               for spec, pp in zip(specs, ps))


def _resolve_ps(specs: Sequence[ConvSpec], hw: HardwareModel,
                p: int | Sequence[int] | None,
                max_group: int | None) -> list[int]:
    if p is None:
        return [resolve_group_size(s, hw, max_group) for s in specs]
    if isinstance(p, int):
        return [min(p, s.num_patches) for s in specs]
    ps = list(p)
    if len(ps) != len(specs):
        raise ValueError(f"{len(ps)} group sizes for {len(specs)} layers")
    return ps


# --------------------------------------------------------------------- #
# Plan assembly (strategies -> reuse decisions -> layer schedule)
# --------------------------------------------------------------------- #

def _assemble_layers(specs: Sequence[ConvSpec], ps: Sequence[int],
                     results: Sequence[solver_mod.SolveResult],
                     hw: HardwareModel, allow_reuse: bool,
                     ) -> tuple[list[LayerPlan], float, float]:
    """Fixed per-layer strategies -> (layers, total, gross total): the
    inter-layer reuse pass and duration accounting, shared between the
    first assembly and the reuse-aware refinement candidates.

    Reuse decision per adjacent pair: hold the full activation on-chip if
    it fits, else the largest admissible row window.  The decision is
    sequential: a middle layer holding its input map (from the previous
    pair) has less room for an accumulating output map, so the
    producer-side check carries that already-held amount forward."""
    # reuse_after[i]: ("full", 0) | ("window", rows) | None   for i -> i+1
    reuse_after: list[tuple[str, int] | None] = []
    for i in range(len(specs) - 1):
        held_in = 0                  # resident while layer i executes
        if i > 0 and reuse_after[i - 1] is not None:
            kind, rows = reuse_after[i - 1]
            held_in = (_held_elements(specs[i - 1], specs[i])
                       if kind == "full"
                       else rows * specs[i].w_in * specs[i].c_in)
        choice: tuple[str, int] | None = None
        if allow_reuse:
            if activation_fits(specs[i], results[i].strategy,
                               specs[i + 1], results[i + 1].strategy, hw,
                               producer_extra_held=held_in):
                choice = ("full", 0)
            else:
                rows = row_window_rows(
                    specs[i], results[i].strategy,
                    specs[i + 1], results[i + 1].strategy, hw,
                    producer_extra_held=held_in)
                if rows:
                    choice = ("window", rows)
        reuse_after.append(choice)

    layers: list[LayerPlan] = []
    total = gross_total = 0.0
    for i, (spec, pp, res) in enumerate(zip(specs, ps, results)):
        strat = res.strategy
        gross = strat.full_duration(hw)
        mode_in = reuse_after[i - 1] if i > 0 else None
        mode_out = reuse_after[i] if i < len(specs) - 1 else None
        reuse_in = mode_in is not None and mode_in[0] == "full"
        window_rows = mode_in[1] if mode_in and mode_in[0] == "window" else 0
        # savings never exceed the strategy's measured first-load DRAM
        # traffic: full residency saves exactly that; a window saves its
        # rows' needed pixels, clamped for strategies that load fewer.
        if reuse_in:
            in_saved = strat.first_load_duration(hw)
        elif window_rows:
            in_saved = min(_window_load_saved(spec, window_rows, hw),
                           strat.first_load_duration(hw))
        else:
            in_saved = 0.0
        reuse_out = mode_out is not None and mode_out[0] == "full"
        wb_saved = strat.write_back_duration(hw) if reuse_out else 0.0
        lp = LayerPlan(index=i, spec=spec, p=pp, result=res,
                       reuse_input=reuse_in, reuse_output=reuse_out,
                       window_rows=window_rows,
                       gross_duration=gross,
                       input_load_saved=in_saved,
                       write_back_saved=wb_saved)
        layers.append(lp)
        total += lp.duration
        gross_total += gross
    return layers, total, gross_total


# --------------------------------------------------------------------- #
# Front door
# --------------------------------------------------------------------- #

def plan_network(specs: Sequence[ConvSpec], hw: HardwareModel,
                 *,
                 name: str = "network",
                 p: int | Sequence[int] | None = None,
                 max_group: int | None = 16,
                 nb_data_reload: int = 2,
                 polish_iters: int = 6_000,
                 polish_restarts: int = 4,
                 use_milp: bool = False,
                 time_limit: float = 10.0,
                 rng_seed: int = 0,
                 allow_reuse: bool = True,
                 solve_fn: Callable[..., solver_mod.SolveResult] | None = None,
                 verify: bool | None = None,
                 ) -> NetworkPlan:
    """Solve every layer and assemble the network schedule.

    Every returned strategy is feasible under ``hw.size_mem`` (S1, shrunk
    S1, or the S2 kernel-group-swapping fallback — see the module note);
    :class:`InfeasibleNetworkError` is raised when a layer fits no family.
    Deterministic for fixed ``rng_seed`` (restart seeds are derived from
    it; see ``solver.polish_multi``).  ``solve_fn`` overrides the cached
    solver (tests / custom search).

    ``verify=True`` runs the static plan verifier
    (``repro_torch.analysis.verifier``) as a postcondition and raises
    ``PlanVerificationError`` on any error-severity diagnostic; the
    default ``None`` defers to the ``REPRO_VERIFY_PLANS`` env knob."""
    specs = list(specs)
    if not specs:
        raise ValueError("empty network")
    ps = _resolve_ps(specs, hw, p, max_group)
    fn = solve_fn or solver_mod.solve_cached

    # per-stage cache attribution: snapshot counters around each stage
    # and report deltas, so interleaved stages (this solve loop, the
    # refine pass below, a concurrent multichip DP or resil re-plan)
    # never claim each other's hits
    track = fn is solver_mod.solve_cached
    stats0 = solver_mod.cache_stats() if track else None

    t0 = time.perf_counter()
    results = []
    for i, (spec, pp) in enumerate(zip(specs, ps)):
        try:
            results.append(
                fn(spec, pp, hw, nb_data_reload=nb_data_reload,
                   time_limit=time_limit, polish_iters=polish_iters,
                   use_milp=use_milp, rng_seed=rng_seed,
                   polish_restarts=polish_restarts))
        except ValueError as e:
            raise InfeasibleNetworkError(
                f"layer {i} ({spec.c_in}x{spec.h_in}x{spec.w_in}"
                f"->{spec.c_out}): no strategy fits "
                f"size_mem={hw.size_mem}") from e
    t_solved = time.perf_counter()
    solve_stats = (solver_mod.cache_stats() - stats0) if track else None
    # feasibility validation: never emit a plan whose peak exceeds the
    # budget (regression guard for custom solve_fn paths too).
    if hw.size_mem is not None:
        for i, res in enumerate(results):
            peak = res.strategy.peak_footprint_elements()
            if peak > hw.size_mem:
                raise InfeasibleNetworkError(
                    f"layer {i}: strategy {res.strategy.name} peak "
                    f"footprint {peak} exceeds size_mem={hw.size_mem}")

    layers, total, gross_total = _assemble_layers(
        specs, ps, results, hw, allow_reuse)

    # reuse-aware refinement: the per-layer joint (p, strategy) search can
    # pick a cheaper-gross strategy whose larger footprint blocks an
    # inter-layer reuse worth more than the layer-level gain.  For every
    # pair that got no full residency, re-solve the consumer under a
    # budget tightened to leave room for (a) the full held input map and
    # (b) one minimal halo window, and keep whichever full assembly is
    # cheaper (each capped solve hits the same LRU).
    refine0 = solver_mod.cache_stats() if track else None
    if allow_reuse and hw.size_mem is not None and fn is \
            solver_mod.solve_cached:
        for i in range(1, len(specs)):
            if layers[i].reuse_input:
                continue
            caps = []
            if not layers[i].window_rows:
                caps.append(hw.size_mem
                            - specs[i].h_k * specs[i].w_in * specs[i].c_in)
            caps.append(hw.size_mem - _held_elements(specs[i - 1],
                                                     specs[i]))
            peak_i = results[i].strategy.peak_footprint_elements()
            for cap in sorted(set(caps), reverse=True):
                if cap <= 0 or peak_i <= cap:
                    continue
                capped_hw = dataclasses.replace(hw, size_mem=cap)
                try:
                    alt = fn(specs[i], ps[i], capped_hw,
                             nb_data_reload=nb_data_reload,
                             time_limit=time_limit,
                             polish_iters=polish_iters,
                             use_milp=use_milp, rng_seed=rng_seed,
                             polish_restarts=polish_restarts)
                except ValueError:
                    continue
                alt_results = list(results)
                alt_results[i] = alt
                alt_layers, alt_total, alt_gross = _assemble_layers(
                    specs, ps, alt_results, hw, allow_reuse)
                if alt_total < total:
                    results, layers = alt_results, alt_layers
                    total, gross_total = alt_total, alt_gross
    planning_seconds = time.perf_counter() - t0

    cache_hits = solver_calls = 0
    if track:
        refine_stats = solver_mod.cache_stats() - refine0
        cache_hits = solve_stats.solve_hits + refine_stats.solve_hits
        solver_calls = solve_stats.solve_calls + refine_stats.solve_calls

    # observability hooks: per-stage wall-clocks accumulate in the
    # process-wide metrics registry (lazy import — repro_torch.obs depends on
    # repro_torch.core, never the reverse at module level)
    from repro_torch.obs.metrics import REGISTRY
    REGISTRY.incr("planner/plan_network_calls")
    REGISTRY.incr("planner/solve_s", t_solved - t0)
    REGISTRY.incr("planner/refine_s", planning_seconds - (t_solved - t0))
    REGISTRY.incr("planner/solver_calls", solver_calls)
    REGISTRY.incr("planner/cache_hits", cache_hits)
    if track:
        REGISTRY.incr("planner/stage/solve/calls", solve_stats.solve_calls)
        REGISTRY.incr("planner/stage/solve/hits", solve_stats.solve_hits)
        REGISTRY.incr("planner/stage/refine/calls",
                      refine_stats.solve_calls)
        REGISTRY.incr("planner/stage/refine/hits", refine_stats.solve_hits)

    base0 = solver_mod.cache_stats()
    with REGISTRY.timer("planner/baseline_s"):
        baseline = greedy_network_duration(specs, hw, p=p,
                                           max_group=max_group)
    # the greedy baseline prices layers through best_s2_cached — its own
    # attribution window, so it never pollutes the solve/refine hit rates
    base_stats = solver_mod.cache_stats() - base0
    REGISTRY.incr("planner/stage/baseline/s2_calls", base_stats.s2_calls)
    REGISTRY.incr("planner/stage/baseline/s2_hits", base_stats.s2_hits)
    plan = NetworkPlan(
        name=name, hw=hw, layers=tuple(layers),
        total_duration=total, gross_duration=gross_total,
        baseline_duration=baseline,
        planning_seconds=planning_seconds,
        solver_calls=solver_calls, cache_hits=cache_hits)
    # lazy import: repro_torch.analysis depends on this module
    from repro_torch.analysis.verifier import assert_verified, should_verify
    if should_verify(verify):
        assert_verified(plan)
    return plan
