"""S2: offloading strategies that do NOT keep all kernels on-chip — the
paper's stated future work (Sec 9: "strategies that operate at a finer
granularity than patches and do not assume that all kernels are stored in
on-chip memory during computation"), expressed in the same Def 1/2
formalism.

A step computes a (patch group, kernel group) pair: output *units* are
(patch, kernel-group) cells, ``out`` ids = pid * G + g for G kernel groups.
Two canonical orders trade input reloads against kernel reloads — exactly
the weight-stationary / output-stationary dataflow choice of the GeMM
planner:

  * ``kernel_major`` (weight-stationary): for each kernel group, sweep all
    patch groups — kernels loaded once each, input reloaded G times;
  * ``patch_major`` (input-stationary): for each patch group, cycle the
    kernel groups — input loaded once (plus halos), kernels reloaded
    n_patch_groups times.

Why S2 matters: S1 *requires* size_MEM ≥ all kernels + a patch + outputs;
S2 runs under arbitrarily small kernel budgets.  ``best_s2`` searches
(kernel-group size × order) under a memory cap and the PE budget —
a concrete optimizer for the paper's future-work regime.

The search runs in three stages (mirroring ``core.solver`` for S1):

  1. *seed enumeration* — every kernel-group size 1..N (ragged final
     group allowed) × both canonical orders × a few patch-group sizes,
     priced with closed-form formulas (no schedule materialised), so the
     enumeration is O(candidates) instead of O(candidates × cells);
  2. *polish* — a simulated-annealing search over the joint space of
     schedule order × patch partition × ragged kernel partition
     (``polish_s2``), the Sec-5 polishing discipline ported to S2.  The
     cost is maintained through a symmetric consecutive-overlap matrix
     (load cost = constant − overlaps), so order moves are O(1) and
     partition moves are one vectorised numpy rebuild;
  3. an exact schedule-*order* MILP for tiny grids (``ilp.build_s2_order_ilp``
     via HiGHS), so optimality gaps stay reported on small instances.
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import Step
from repro_torch.core.strategies import zigzag

# Polish budget for the S2 annealing search; ``tests/conftest.py`` caps it
# and REPRO_S2_POLISH_ITERS overrides (the S2 analogue of REPRO_FULL_POLISH).
DEFAULT_POLISH_ITERS = int(os.environ.get("REPRO_S2_POLISH_ITERS", "3000"))

# grids with at most this many (patch-group, kernel-group) cells get the
# exact schedule-order MILP on top of the polish
S2_MILP_MAX_CELLS = 9


def _chunks(seq, n):
    return [tuple(seq[i:i + n]) for i in range(0, len(seq), n)]


@dataclasses.dataclass(frozen=True)
class S2Strategy:
    """Ordered (patch-group, kernel-group-index) schedule."""

    name: str
    spec: ConvSpec
    kernel_groups: tuple[tuple[int, ...], ...]
    schedule: tuple[tuple[tuple[int, ...], int], ...]   # ((patch ids), kg)

    def __post_init__(self):
        seen: set[tuple[int, int]] = set()
        for g, kg in self.schedule:
            for pid in g:
                for kid in self.kernel_groups[kg]:
                    cell = (pid, kid)
                    if cell in seen:
                        raise ValueError(f"{cell} computed twice")
                    seen.add(cell)
        want = self.spec.num_patches * self.spec.n_kernels
        if len(seen) != want:
            raise ValueError(
                f"{self.name}: covers {len(seen)} of {want} cells")

    @property
    def n_steps(self) -> int:
        return len(self.schedule)

    @property
    def n_kernel_groups(self) -> int:
        return len(self.kernel_groups)

    def out_unit(self, pid: int, kg: int) -> int:
        return pid * self.n_kernel_groups + kg

    # ------------------------------------------------------------------ #
    def to_steps(self) -> list[Step]:
        """Def-16-style eager-free semantics for BOTH inputs and kernels;
        outputs written back at the next step."""
        spec = self.spec
        steps: list[Step] = []
        res_pix = 0
        res_ker = 0
        prev_out = 0
        for g, kg in self.schedule:
            need_pix = spec.group_mask(g)
            need_ker = 0
            for kid in self.kernel_groups[kg]:
                need_ker |= 1 << kid
            out = 0
            for pid in g:
                out |= 1 << self.out_unit(pid, kg)
            steps.append(Step(
                f_inp=res_pix & ~need_pix,
                f_ker=res_ker & ~need_ker,
                w=prev_out,
                i_slice=need_pix & ~res_pix,
                k_sub=need_ker & ~res_ker,
                out=out,
                group=tuple(g),
                kernel_group=self.kernel_groups[kg]))
            res_pix, res_ker, prev_out = need_pix, need_ker, out
        steps.append(Step(f_inp=res_pix, f_ker=res_ker, w=prev_out))
        return steps

    # ------------------------------------------------------------------ #
    def objective(self, hw: HardwareModel) -> float:
        """Full Def-3 duration: unlike S1 (eq. 15), kernel loads COUNT —
        trading them against input reloads is the whole point of S2."""
        spec = self.spec
        total = 0.0
        res_pix = res_ker = 0
        kelem = spec.c_in * spec.h_k * spec.w_k
        for g, kg in self.schedule:
            need_pix = spec.group_mask(g)
            need_ker = 0
            for kid in self.kernel_groups[kg]:
                need_ker |= 1 << kid
            total += (need_pix & ~res_pix).bit_count() * hw.t_l
            total += (need_ker & ~res_ker).bit_count() * kelem * hw.t_l
            total += hw.t_acc
            res_pix, res_ker = need_pix, need_ker
        return total

    def peak_memory_elements(self) -> int:
        """Max on-chip elements during any step (inputs + kernels + the
        step's output cells + the previous step's not-yet-written cells)."""
        spec = self.spec
        kelem = spec.c_in * spec.h_k * spec.w_k
        peak = 0
        prev_out_elems = 0
        for g, kg in self.schedule:
            pix = spec.group_mask(g).bit_count() * spec.c_in
            ker = len(self.kernel_groups[kg]) * kelem
            out = len(g) * len(self.kernel_groups[kg])
            peak = max(peak, pix + ker + out + prev_out_elems)
            prev_out_elems = out
        return peak

    # -- strategy protocol (shared with strategies.GroupedStrategy) ------ #
    def max_group_size(self) -> int:
        return max(len(g) for g, _ in self.schedule)

    def peak_footprint_elements(self) -> int:
        """Protocol alias: peak resident elements during any step."""
        return self.peak_memory_elements()

    def peak_working_set_elements(self) -> int:
        """Peak resident elements excluding output buffers: the largest
        (input pixels + swapped kernel group) of any step — what must fit
        next to a held activation on the producer side."""
        spec = self.spec
        kelem = spec.c_in * spec.h_k * spec.w_k
        return max(spec.group_mask(g).bit_count() * spec.c_in
                   + len(self.kernel_groups[kg]) * kelem
                   for g, kg in self.schedule)

    def write_back_duration(self, hw: HardwareModel) -> float:
        """t_w cost of writing every (patch, kernel) output cell back —
        S2 drains outputs at cell granularity (cf. sim.s2.run_s2)."""
        return self.spec.num_patches * self.spec.c_out * hw.t_w

    def full_duration(self, hw: HardwareModel) -> float:
        """Def-3 duration of the materialised schedule.  The S2 objective
        already includes kernel (re)loads, so only write-backs are added;
        matches ``sim.s2.run_s2`` exactly (tests/test_s2_sim.py)."""
        return self.objective(hw) + self.write_back_duration(hw)

    def first_load_duration(self, hw: HardwareModel) -> float:
        """t_l traffic of first-time input-pixel loads (reloads beyond the
        first still hit DRAM even under inter-layer reuse)."""
        covered = 0
        for g, _ in self.schedule:
            covered |= self.spec.group_mask(g)
        return covered.bit_count() * hw.t_l


# --------------------------------------------------------------------- #
# Constructors
# --------------------------------------------------------------------- #

def _kernel_groups(spec: ConvSpec, kg_size: int):
    return tuple(_chunks(list(range(spec.n_kernels)), kg_size))


def kernel_major(spec: ConvSpec, p: int, kg_size: int) -> S2Strategy:
    """Weight-stationary: kernels loaded once each; input swept per group."""
    kgs = _kernel_groups(spec, kg_size)
    patch_groups = [tuple(g) for g in zigzag(spec, p).groups]
    sched = [(g, kg) for kg in range(len(kgs)) for g in patch_groups]
    return S2Strategy(f"s2_kernel_major_kg{kg_size}", spec, kgs,
                      tuple(sched))


def patch_major(spec: ConvSpec, p: int, kg_size: int) -> S2Strategy:
    """Input-stationary: each patch group stays while kernel groups cycle."""
    kgs = _kernel_groups(spec, kg_size)
    patch_groups = [tuple(g) for g in zigzag(spec, p).groups]
    sched = [(g, kg) for g in patch_groups for kg in range(len(kgs))]
    return S2Strategy(f"s2_patch_major_kg{kg_size}", spec, kgs,
                      tuple(sched))


def nb_patches_max_s2(spec: ConvSpec, hw: HardwareModel,  # lint: public-api
                      kg_size: int) -> int:
    """PE budget per step with only kg_size output channels computed."""
    cap = hw.nbop_pe // (spec.nb_op_value * kg_size)
    if cap < 1:
        raise ValueError("PE cannot fit one patch x kernel-group step")
    return cap


def s2_lower_bound(spec: ConvSpec, hw: HardwareModel) -> float:
    """Analytic lower bound on the S2 objective: every needed pixel and
    every kernel element loaded at least once, and at least enough steps to
    push all (patch, kernel) cells through the PE."""
    cells = spec.num_patches * spec.n_kernels
    cells_per_step = max(1, hw.nbop_pe // spec.nb_op_value)
    min_steps = -(-cells // cells_per_step)
    return (hw.t_l * (spec.all_pixels_mask.bit_count() + spec.kernel_elements)
            + min_steps * hw.t_acc)


@dataclasses.dataclass
class S2Result:
    strategy: S2Strategy
    objective: float
    peak_memory: int
    feasible_s1: bool        # could S1 have run under this memory cap?
    seed_strategy: S2Strategy | None = None   # best enumerated, no polish
    seed_objective: float | None = None
    milp_status: str = "skipped"              # exact order MILP (tiny grids)
    milp_objective: float | None = None

    @property
    def gain_vs_seed(self) -> float:  # lint: public-api
        """Polish + MILP gain over the enumeration winner (Fig-13 style)."""
        if not self.seed_objective:
            return 0.0
        return 1.0 - self.objective / self.seed_objective


# --------------------------------------------------------------------- #
# Seed enumeration: closed-form pricing of the canonical orders
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class _ZigProfile:
    """Per-p reusable terms of the zigzag patch-group sequence."""

    p: int
    cnt: tuple[int, ...]        # |pixels(g_i)|
    glen: tuple[int, ...]       # |g_i|
    zig_loads: int              # pixels loaded sweeping g_0..g_{m-1} once
    cross: int                  # |pixels(g_0) \ pixels(g_{m-1})|


def _zig_profile(spec: ConvSpec, p: int) -> _ZigProfile:
    groups = zigzag(spec, p).groups
    masks = [spec.group_mask(g) for g in groups]
    cnt = tuple(m.bit_count() for m in masks)
    glen = tuple(len(g) for g in groups)
    loads = cnt[0] + sum((masks[i] & ~masks[i - 1]).bit_count()
                         for i in range(1, len(masks)))
    cross = (masks[0] & ~masks[-1]).bit_count()
    return _ZigProfile(p, cnt, glen, loads, cross)


def _kg_lens(n_kernels: int, kg_size: int) -> np.ndarray:
    """Kernel-group sizes for a ragged chunking (final group may be short)."""
    full, rest = divmod(n_kernels, kg_size)
    lens = [kg_size] * full + ([rest] if rest else [])
    return np.asarray(lens, dtype=np.int64)


def _price_candidate(spec: ConvSpec, hw: HardwareModel, prof: _ZigProfile,
                     ks: np.ndarray, order: str) -> tuple[float, int]:
    """(objective, peak_elements) of ``kernel_major``/``patch_major`` at
    patch-group size ``prof.p`` and kernel-group sizes ``ks`` — closed
    form, no schedule materialised (verified against the built strategies
    in tests/test_s2_polish.py)."""
    kelem = spec.c_in * spec.h_k * spec.w_k
    m, g_count = len(prof.cnt), len(ks)
    cnt = np.asarray(prof.cnt, dtype=np.int64)
    glen = np.asarray(prof.glen, dtype=np.int64)
    steps = m * g_count
    out = glen[:, None] * ks[None, :]                     # (m, G)
    base = cnt[:, None] * spec.c_in + ks[None, :] * kelem
    prev = np.zeros_like(out)
    if order == "kernel_major":
        # every sweep reloads its kernel group once; the input is re-swept
        # per sweep (first sweep pays the full zigzag loads, later sweeps
        # pay the wrap-around transition plus the zigzag interior)
        pix = prof.zig_loads + (g_count - 1) * (
            prof.cross + prof.zig_loads - prof.cnt[0])
        ker_ids = spec.n_kernels
        prev[1:, :] = out[:-1, :]
        prev[0, 1:] = glen[-1] * ks[:-1]
    else:
        # input loaded once along the zigzag; kernels recycle per patch
        # group (unless there is a single kernel group, which stays put)
        pix = prof.zig_loads
        ker_ids = spec.n_kernels if g_count == 1 else m * spec.n_kernels
        prev[:, 1:] = glen[:, None] * ks[None, :-1]
        prev[1:, 0] = glen[:-1] * ks[-1]
    obj = hw.t_l * pix + hw.t_l * kelem * ker_ids + steps * hw.t_acc
    peak = int((base + out + prev).max())
    return obj, peak


def _s1_min_mem(spec: ConvSpec) -> int:
    return (spec.kernel_elements
            + spec.patch_masks[0].bit_count() * spec.c_in + spec.c_out)


def enumerate_s2_seed(spec: ConvSpec, hw: HardwareModel,
                      size_mem: int | None,
                      kg_sizes: Iterable[int] | None = None,
                      ) -> tuple[S2Strategy, float, int] | None:
    """Best (order, p, kernel-group size) under the caps, priced closed
    form; only the winner is materialised.  Ragged final kernel groups are
    included — every kg size 1..N is admissible, not just divisors."""
    if kg_sizes is None:
        kg_sizes = range(1, spec.n_kernels + 1)
    profiles: dict[int, _ZigProfile] = {}
    best = None            # (obj, order, p, kg, peak)
    for kg in kg_sizes:
        if not 1 <= kg <= spec.n_kernels:
            continue
        cap = hw.nbop_pe // (spec.nb_op_value * kg)
        if cap < 1:
            continue       # PE cannot take one (patch x kernel-group) step
        p_max = min(cap, spec.num_patches)
        ks = _kg_lens(spec.n_kernels, kg)
        for p in sorted({p_max, max(1, p_max // 2), max(1, p_max // 4),
                         4, 2, 1}):
            if p > p_max:
                continue
            prof = profiles.get(p)
            if prof is None:
                prof = profiles[p] = _zig_profile(spec, p)
            for order in ("kernel_major", "patch_major"):
                obj, peak = _price_candidate(spec, hw, prof, ks, order)
                if size_mem is not None and peak > size_mem:
                    continue
                if best is None or obj < best[0]:
                    best = (obj, order, p, kg, peak)
    if best is None:
        return None
    obj, order, p, kg, peak = best
    make_strategy = kernel_major if order == "kernel_major" else patch_major
    strat = make_strategy(spec, p, kg)
    return strat, strat.objective(hw), strat.peak_memory_elements()


def best_s2(spec: ConvSpec, hw: HardwareModel,
            size_mem: int | None = None,
            kg_sizes: Iterable[int] | None = None,
            polish_iters: int | None = None,
            rng_seed: int = 0,
            use_milp: bool = True,
            milp_time_limit: float = 2.0) -> S2Result:
    """Search (kernel-group size x order x patch-group size) under the
    memory cap, then polish the winner over the joint schedule space and,
    on tiny grids, certify the order with an exact MILP.  The S1
    comparison records whether the cap even admits an S1 strategy."""
    size_mem = size_mem if size_mem is not None else hw.size_mem
    seed = enumerate_s2_seed(spec, hw, size_mem, kg_sizes)
    if seed is None:
        raise ValueError(f"no S2 strategy fits size_mem={size_mem}")
    seed_strat, seed_obj, seed_peak = seed
    feasible_s1 = size_mem is None or _s1_min_mem(spec) <= size_mem

    if polish_iters is None:
        polish_iters = DEFAULT_POLISH_ITERS
    best_strat, best_obj, best_peak = seed_strat, seed_obj, seed_peak
    if polish_iters > 0:
        pol = polish_s2(seed_strat, hw, size_mem=size_mem,
                        iters=polish_iters, rng_seed=rng_seed)
        pol_obj = pol.objective(hw)
        pol_peak = pol.peak_memory_elements()
        if pol_obj < best_obj and (size_mem is None or pol_peak <= size_mem):
            best_strat, best_obj, best_peak = pol, pol_obj, pol_peak

    milp_status, milp_obj = "skipped", None
    if use_milp and best_strat.n_steps <= S2_MILP_MAX_CELLS:
        milp_strat, milp_status = milp_order_s2(
            best_strat, hw, size_mem=size_mem, time_limit=milp_time_limit)
        if milp_strat is not None:
            milp_obj = milp_strat.objective(hw)
            if milp_obj < best_obj and (
                    size_mem is None
                    or milp_strat.peak_memory_elements() <= size_mem):
                best_strat, best_obj = milp_strat, milp_obj
                best_peak = milp_strat.peak_memory_elements()

    return S2Result(best_strat, best_obj, best_peak,
                    feasible_s1=feasible_s1,
                    seed_strategy=seed_strat, seed_objective=seed_obj,
                    milp_status=milp_status, milp_objective=milp_obj)


# --------------------------------------------------------------------- #
# Polishing search over the joint S2 schedule space
# --------------------------------------------------------------------- #

_S2_PENALTY = 1e12


class _S2Grid:
    """Mutable (patch partition x ragged kernel partition x schedule
    order) state with vectorised cost bookkeeping.

    The schedule is a full grid: every (patch group i, kernel group j)
    pair appears exactly once, so any order permutation, any movement of
    patches between patch groups, and any movement of kernels between
    kernel groups preserves the computes-every-cell-once invariant.

    Cost identity: total load duration equals the (partition-dependent)
    constant ``sum over cells of (pixels + kernel elements)`` minus the
    sum of *consecutive-cell overlaps*, which is SYMMETRIC —
    ``|A \\ B| = |A| - |A ∩ B|`` — so 2-opt order reversals are exact
    O(1) delta evaluations against the overlap matrix ``W``.
    """

    def __init__(self, spec: ConvSpec, hw: HardwareModel,
                 patch_groups: Sequence[Sequence[int]],
                 kernel_groups: Sequence[Sequence[int]],
                 order: Sequence[tuple[int, int]],
                 size_mem: int | None):
        self.spec = spec
        self.hw = hw
        self.size_mem = size_mem
        self.kelem = spec.c_in * spec.h_k * spec.w_k
        self.pg: list[list[int]] = [list(g) for g in patch_groups]
        self.kg: list[list[int]] = [list(g) for g in kernel_groups]
        self.m = len(self.pg)
        self.g = len(self.kg)
        self.order: list[int] = [i * self.g + j for i, j in order]
        self.pmask = [spec.group_mask(g) for g in self.pg]
        self._rebuild_partition_arrays()

    # -- partition-dependent arrays ------------------------------------- #
    def _rebuild_partition_arrays(self) -> None:
        m, g = self.m, self.g
        self.pcnt = np.array([pm.bit_count() for pm in self.pmask],
                             dtype=np.int64)
        self.glen = np.array([len(gr) for gr in self.pg], dtype=np.int64)
        self.klen = np.array([len(gr) for gr in self.kg], dtype=np.int64)
        self.P = np.array(
            [[(a & b).bit_count() for b in self.pmask] for a in self.pmask],
            dtype=np.int64)
        t_l = self.hw.t_l
        # W[c, c'] = overlap(load sets of cells c, c') in duration units
        self.W = t_l * np.kron(self.P, np.ones((g, g))) \
            + t_l * self.kelem * np.kron(np.ones((m, m)), np.diag(self.klen))
        out = (self.glen[:, None] * self.klen[None, :]).ravel()
        succ = (self.pcnt[:, None] * self.spec.c_in
                + self.klen[None, :] * self.kelem).ravel()
        self.cell_peak = succ + out               # single-cell peak
        if self.size_mem is not None:
            # pair[c', c]: peak when cell c executes right after c' (the
            # outputs of c' are still pending write-back) — asymmetric.
            # ``bad_dir`` is the exact feasibility matrix; the annealing's
            # symmetric 2-opt deltas use the conservative union (a
            # transition is avoided if either direction overflows), the
            # directed MILP uses the exact directed penalties.
            pair = succ[None, :] + out[None, :] + out[:, None]
            self.bad_dir = pair > self.size_mem
            self.W_dir = np.where(self.bad_dir, self.W - _S2_PENALTY,
                                  self.W)
            self.W = np.where(self.bad_dir | self.bad_dir.T,
                              self.W - _S2_PENALTY, self.W)
        else:
            self.bad_dir = None
            self.W_dir = self.W
        self.load_const = t_l * (self.g * int(self.pcnt.sum())
                                 + self.m * self.kelem
                                 * int(self.klen.sum()))

    # -- cost ----------------------------------------------------------- #
    def consec_overlap(self) -> float:
        o = np.asarray(self.order)
        return float(self.W[o[:-1], o[1:]].sum())

    def cost(self) -> float:
        return (self.load_const - self.consec_overlap()
                + len(self.order) * self.hw.t_acc)

    def feasible(self) -> bool:
        if self.size_mem is None:
            return True
        if (self.cell_peak > self.size_mem).any():
            return False
        o = np.asarray(self.order)
        return not bool(self.bad_dir[o[:-1], o[1:]].any())

    # -- order moves (O(1) delta) --------------------------------------- #
    def reverse_delta(self, a: int, b: int) -> float:
        """Cost delta of reversing order[a..b] (inclusive)."""
        o = self.order
        gain = 0.0
        if a > 0:
            gain += self.W[o[a - 1], o[b]] - self.W[o[a - 1], o[a]]
        if b + 1 < len(o):
            gain += self.W[o[a], o[b + 1]] - self.W[o[b], o[b + 1]]
        return -gain

    def apply_reverse(self, a: int, b: int) -> None:
        self.order[a:b + 1] = self.order[a:b + 1][::-1]

    # -- partition moves (vectorised rebuild) --------------------------- #
    def max_cell_macs(self) -> int:
        return int(self.glen.max()) * self.spec.nb_op_value \
            * int(self.klen.max())

    def move_patch(self, a: int, ia: int, b: int) -> None:
        pid = self.pg[a].pop(ia)
        self.pg[b].append(pid)
        self.pmask[a] = self.spec.group_mask(self.pg[a])
        self.pmask[b] = self.spec.group_mask(self.pg[b])
        self._rebuild_partition_arrays()

    def swap_patches(self, a: int, ia: int, b: int, ib: int) -> None:
        self.pg[a][ia], self.pg[b][ib] = self.pg[b][ib], self.pg[a][ia]
        self.pmask[a] = self.spec.group_mask(self.pg[a])
        self.pmask[b] = self.spec.group_mask(self.pg[b])
        self._rebuild_partition_arrays()

    def move_kernel(self, a: int, b: int) -> None:
        self.kg[b].append(self.kg[a].pop())
        self._rebuild_partition_arrays()

    # -- materialise ---------------------------------------------------- #
    def snapshot(self):
        return ([list(g) for g in self.pg], [list(g) for g in self.kg],
                list(self.order))

    def restore(self, snap) -> None:
        pg, kg, order = snap
        self.pg = [list(g) for g in pg]
        self.kg = [list(g) for g in kg]
        self.order = list(order)
        self.pmask = [self.spec.group_mask(g) for g in self.pg]
        self._rebuild_partition_arrays()

    def strategy(self, name: str) -> S2Strategy:
        kgs = tuple(tuple(g) for g in self.kg)
        sched = tuple((tuple(self.pg[c // self.g]), c % self.g)
                      for c in self.order)
        return S2Strategy(name, self.spec, kgs, sched)


def _grid_of(strategy: S2Strategy) -> tuple[list[tuple[int, ...]],
                                            list[tuple[int, int]]] | None:
    """Recover the (patch groups, cell order) grid behind a schedule, or
    None when the schedule is not a full patch-group x kernel-group grid
    (polish requires the grid invariant for partition moves)."""
    pgroups: list[tuple[int, ...]] = []
    index: dict[tuple[int, ...], int] = {}
    cells: list[tuple[int, int]] = []
    for g, kg in strategy.schedule:
        i = index.get(g)
        if i is None:
            i = index[g] = len(pgroups)
            pgroups.append(g)
        cells.append((i, kg))
    want = len(pgroups) * strategy.n_kernel_groups
    if len(cells) != want or len(set(cells)) != want:
        return None
    return pgroups, cells


def polish_s2(seed: S2Strategy, hw: HardwareModel,
              size_mem: int | None = None,
              iters: int | None = None,
              rng_seed: int = 0) -> S2Strategy:
    """Simulated-annealing polish of an S2 strategy over the JOINT space:
    schedule order (2-opt / relocation, O(1) bitmask-overlap deltas),
    patch moves between patch groups, and kernel moves between ragged
    kernel groups — the Sec-5 polishing discipline ported to S2.
    Returns the best feasible strategy found (the seed if none better)."""
    if iters is None:
        iters = DEFAULT_POLISH_ITERS
    grid = _grid_of(seed)
    if grid is None or seed.n_steps < 2:
        return seed
    pgroups, cells = grid
    spec = seed.spec
    st = _S2Grid(spec, hw, pgroups, seed.kernel_groups, cells, size_mem)
    if not st.feasible():
        return seed
    rng = random.Random(rng_seed)
    n = len(st.order)
    cur = st.cost()
    best_cost, best_snap = cur, st.snapshot()
    t0, t1 = max(2.0, cur * 0.02), 0.05
    for it in range(iters):
        temp = t0 * (t1 / t0) ** (it / max(1, iters - 1))
        kind = rng.random()
        if kind < 0.55:                       # 2-opt order reversal
            a = rng.randrange(n - 1)
            b = min(n - 1, a + rng.randint(1, max(1, n // 4)))
            delta = st.reverse_delta(a, b)
            if delta <= 0 or rng.random() < np.exp(-delta / temp):
                st.apply_reverse(a, b)
                cur += delta
            else:
                continue
        elif kind < 0.75 and st.m >= 2:       # patch swap / relocation
            a, b = rng.sample(range(st.m), 2)
            if not st.pg[a]:
                continue
            snap = st.snapshot()
            if rng.random() < 0.5 and st.pg[b]:
                st.swap_patches(a, rng.randrange(len(st.pg[a])),
                                b, rng.randrange(len(st.pg[b])))
            else:
                if len(st.pg[a]) <= 1:
                    continue
                st.move_patch(a, rng.randrange(len(st.pg[a])), b)
            if st.max_cell_macs() > hw.nbop_pe:
                st.restore(snap)
                continue
            new = st.cost()
            if new <= cur or rng.random() < np.exp(-(new - cur) / temp):
                cur = new
            else:
                st.restore(snap)
                continue
        elif st.g >= 2:                       # kernel move (ragged groups)
            a, b = rng.sample(range(st.g), 2)
            if len(st.kg[a]) <= 1:
                continue
            snap = st.snapshot()
            st.move_kernel(a, b)
            if st.max_cell_macs() > hw.nbop_pe:
                st.restore(snap)
                continue
            new = st.cost()
            if new <= cur or rng.random() < np.exp(-(new - cur) / temp):
                cur = new
            else:
                st.restore(snap)
                continue
        else:
            continue
        if cur < best_cost - 1e-9 and st.feasible():
            best_cost, best_snap = cur, st.snapshot()
    st.restore(best_snap)
    polished = st.strategy(f"{seed.name}+polish")
    if polished.objective(hw) < seed.objective(hw):
        return polished
    return seed


def milp_order_s2(strategy: S2Strategy, hw: HardwareModel,
                  size_mem: int | None = None,
                  time_limit: float = 2.0) -> tuple[S2Strategy | None, str]:
    """Exact schedule-order optimisation of ``strategy``'s grid via the
    Sec-5-style MILP in ``ilp.build_s2_order_ilp`` (tiny instances only:
    the model is quadratic in the cell count).  Partitions stay fixed —
    this certifies the *order* dimension of the polish."""
    grid = _grid_of(strategy)
    if grid is None:
        return None, "skipped_not_grid"
    pgroups, cells = grid
    st = _S2Grid(strategy.spec, hw, pgroups, strategy.kernel_groups,
                 cells, size_mem)
    from repro_torch.core import ilp as ilp_mod
    order, status = ilp_mod.solve_s2_order(st.W_dir, time_limit=time_limit)
    if order is None:
        return None, status
    st.order = list(order)
    cand = st.strategy(f"{strategy.name}+milp")
    if size_mem is not None and not st.feasible():
        return None, "infeasible_order"
    return cand, status
