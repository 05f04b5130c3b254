"""Multi-chip sharded offloading planner (beyond-paper: ROADMAP item 1).

The paper formalises offloading ONE convolution to ONE accelerator with one
on-chip memory.  This module generalises the Def-3 duration accounting to a
:class:`~repro_torch.core.cost_model.ClusterModel` — ``n_chips`` identical chips
on an ICI ring — by letting every layer choose a *sharding mode*:

``replicate``
    The single-chip path: the whole layer runs on chip 0 through the
    existing ``solver.solve_cached`` machinery; the other chips idle.
``row``
    Patch/row sharding: the output rows are split into contiguous bands,
    one per chip; each chip solves the halo-extended sub-convolution of
    its band (a smaller :class:`ConvSpec` through the same LRU-cached
    solver, so equal bands are solved once).  Consecutive row-sharded
    layers exchange only the halo rows over ICI (Stoutchinin et al.'s
    layer-cascade halo, arXiv:1902.01492, lifted to chip boundaries).
``channel``
    Kernel/output-channel sharding: the kernel set Λ is split across
    chips (each solves a ``n_kernels/n`` sub-convolution over the full
    map).  Every chip needs the whole input map — priced as an ICI
    all-gather — and the outputs stay channel-sharded until a consumer
    needs a different layout.  This is the regime where sharding relaxes
    the paper's eq.-12 memory bound: each chip keeps only Λ/n resident,
    so budgets that force the single-chip planner into S2 kernel-group
    swapping stay S1-feasible when sharded.
``hybrid``
    Row x kernel-channel sharding of ONE layer on a 2-D torus: the
    chips form a ``rows x cols`` grid (``Topology.grid``), the output
    rows split into ``rows`` bands along axis 0 and the kernel set into
    ``cols`` groups along axis 1; chip ``(i, j)`` solves band ``i`` of
    kernel group ``j``.  The inbound collective decomposes per axis:
    halo rows shift along the row axis, each band's input map
    all-gathers along the kernel-channel axis (rows in parallel) — the
    kernel split here is over *output* channels, so no partial sums are
    needed; ``Topology.reduce_scatter`` prices the input-channel
    variant for the follow-up.  A ``rows x 1`` grid degenerates to
    ``row`` and a ``1 x cols`` grid to ``channel`` exactly (the
    produced layout and every transition collapse to the pure mode's —
    property-tested).  Hybrid needs the full grid active, so it is
    infeasible for a layer with fewer output rows than grid rows (or
    fewer kernels than grid cols).

Duration accounting (Def 3 extended):

    layer duration = max over chips of the shard's full Def-3 duration
                     + bottleneck-link ICI elements * t_ici     (serial)
    layer duration = max(max-over-chips compute, ICI)         (overlap)

By default ICI transfers are serialised against compute (conservative,
predictable — the paper's sequential-step spirit) while the links
themselves run in parallel, so an ICI phase costs its *bottleneck link's*
element count — priced per :class:`~repro_torch.core.cost_model.Topology`
(unidirectional ring, bidirectional ring, 2-D torus) in the direction of
Chen et al.'s communication lower bounds for convolution accelerators
(arXiv:1911.05662).  The unidirectional ring reproduces the PR-3/PR-4
numbers bit-exactly (regression-gated); bidirectional links halve every
split-tensor collective's bottleneck, so a biring plan is never slower
than the ring plan of the same network.  With
``overlap=True`` the inbound exchange of each stage is double-buffered
under compute (the Stoutchinin et al. halo-cascade discipline,
arXiv:1902.01492, and the same double-buffering our Def-3 HBM accounting
already assumes), so a stage costs ``max(compute, ICI)``; the final
gather has no compute to hide under and stays serial.  A row->row halo
exchange writes rows the consumer already holds live, so its overlap
claim is only made when sound: the DP prices it overlapped only if
every receiving band's first halo read (:func:`halo_first_use`, Def-3
timed) lands after the exchange completes — trying a zigzag-swapped
band variant that reads the halo last when the solved schedule reads
too early — and otherwise serialises that stage (per-layer
``MultiChipLayerPlan.overlap`` flags record the verdict, and
``analysis.verifier``'s ``ici/war-overlap`` rule re-proves it as a hard
ERROR).  Resharding is
charged whenever consecutive layers pick modes whose activation layouts
differ (see ``_transition_elements``); the mode sequence is chosen by a
small Viterbi-style dynamic program over (layer, mode) states, so a cheap
layer never strands the next layer in an expensive layout.

Row bands are near-even by default; ``balance_rows=True`` sizes them by
solved per-chip *duration* (``balanced_row_heights``) so the
max-over-chips term never exceeds the row-balanced one.

``same_pad=True`` asserts the specs' already-padded inputs are ``SAME``
padding (``max(0, h_k - s_h)`` zero rows split top/bottom): edge bands
then skip the first loads of the padding rows inside their halo-extended
windows — position-*dependent* band durations that make
``balanced_row_heights`` bite systematically (edge bands get more rows).
The savings are analytic (clamped to the shard strategy's first-load
traffic) and carried on each ``ShardPlan.pad_saved`` so the cluster
simulator can still reconcile measured durations exactly.

Layout approximations (documented, tested loose): band boundaries between
consecutive row-sharded layers are assumed aligned (pooling between convs
redistributes rows on-chip, as in ``core.network_planner``); pure-row
bands on a torus are laid row-major across the grid, and the wrap
boundary between grid rows is priced as one hop like every other
boundary; multi-chip inter-layer VMEM reuse stays a ROADMAP follow-up.

``plan_multichip_network`` wraps :func:`plan_network` so the 1-chip case
reproduces today's single-chip plans *exactly* (inter-layer reuse
included); for ``n_chips > 1`` the per-layer accounting is gross (no
cross-layer on-chip residency — chips' VMEM is spent on shard working
sets; co-scheduled multi-chip cascading is a ROADMAP follow-up).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from repro_torch.core import formalism
from repro_torch.core import solver as solver_mod
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import ClusterModel, HardwareModel
from repro_torch.core.network_planner import (InfeasibleNetworkError, NetworkPlan,
                                        plan_network, resolve_group_size)
from repro_torch.core.strategies import GroupedStrategy, zigzag

MODES = ("replicate", "row", "channel")
HYBRID_MODES = MODES + ("hybrid",)

# initial activation layout: the host stages the network input in every
# chip's DRAM, so layer 0 pays no ICI in any mode.
_INPUT_LAYOUT = "all"


def mode_alphabet(cluster: ClusterModel) -> tuple[str, ...]:
    """Sharding modes available on this cluster's topology: hybrid
    row x channel grids need a second torus axis to shard along."""
    if cluster.topo.kind == "torus":
        return HYBRID_MODES
    return MODES


# --------------------------------------------------------------------- #
# Shard geometry
# --------------------------------------------------------------------- #

def row_shard_specs(spec: ConvSpec, n_chips: int,
                    heights: Sequence[int] | None = None,
                    ) -> list[tuple[int, tuple[int, int], ConvSpec]]:
    """Split ``spec``'s output rows into contiguous bands, one per chip.

    Returns ``(chip, (row0, row1), shard_spec)`` triples; the shard spec
    is the halo-extended sub-convolution of the band (``(rows-1)*s_h +
    h_k`` input rows), so ``shard_spec.h_out == row1 - row0``.  Chips
    beyond ``h_out`` idle (no triple emitted).  ``heights`` overrides the
    default near-even split with explicit per-chip band heights (the
    duration-balanced partition of :func:`balanced_row_heights`)."""
    n = min(n_chips, spec.h_out)
    if heights is None:
        base, extra = divmod(spec.h_out, n)
        heights = [base + (1 if c < extra else 0) for c in range(n)]
    elif len(heights) != n or sum(heights) != spec.h_out or \
            min(heights) < 1:
        raise ValueError(
            f"band heights {list(heights)} do not tile {spec.h_out} "
            f"output rows over {n} chips")
    shards = []
    r0 = 0
    for c, rows in enumerate(heights):
        h_in_band = (rows - 1) * spec.s_h + spec.h_k
        shards.append((c, (r0, r0 + rows),
                       dataclasses.replace(spec, h_in=h_in_band)))
        r0 += rows
    return shards


def _band_solve(spec: ConvSpec, rows: int, hw,
                max_group: int | None, solve_kwargs: dict
                ) -> tuple[float, float] | None:
    """(full Def-3 duration, first-load duration) of a ``rows``-row
    band's halo-extended sub-convolution through the LRU-cached solver;
    None when no feasible strategy exists at that height."""
    sub = dataclasses.replace(spec, h_in=(rows - 1) * spec.s_h + spec.h_k)
    p = resolve_group_size(sub, hw, max_group)
    try:
        res = solver_mod.solve_cached(sub, p, hw, **solve_kwargs)
    except ValueError:
        return None
    if hw.size_mem is not None and \
            res.strategy.peak_footprint_elements() > hw.size_mem:
        return None
    return (res.strategy.full_duration(hw),
            res.strategy.first_load_duration(hw))


def band_solve_duration(spec: ConvSpec, rows: int, hw,  # lint: public-api
                        max_group: int | None,
                        solve_kwargs: dict) -> float | None:
    """Full Def-3 duration of a ``rows``-row band's halo-extended
    sub-convolution through the LRU-cached solver; None when no feasible
    strategy exists at that height."""
    info = _band_solve(spec, rows, hw, max_group, solve_kwargs)
    return None if info is None else info[0]


def same_pad_rows(spec: ConvSpec) -> tuple[int, int]:
    """(top, bottom) zero rows of a ``SAME``-padded (already-padded)
    input: ``max(0, h_k - s_h)`` total, split top-light like XLA."""
    pad = max(0, spec.h_k - spec.s_h)
    return pad // 2, pad - pad // 2


def band_pad_rows(spec: ConvSpec, r0: int, r1: int) -> int:
    """Padding rows inside band ``[r0, r1)``'s halo-extended input
    window under ``SAME`` padding — rows an edge band never needs to
    load from DRAM (they are zeros the chip can materialise)."""
    top, bot = same_pad_rows(spec)
    h0 = r0 * spec.s_h
    h1 = h0 + (r1 - r0 - 1) * spec.s_h + spec.h_k
    return max(0, top - h0) + max(0, h1 - (spec.h_in - bot))


def _band_pad_saving(spec: ConvSpec, r0: int, r1: int, hw,
                     first_load: float) -> float:
    """Analytic duration saved by not loading a band's padding rows:
    their spatial pixels' first loads, clamped to the strategy's
    measured first-load traffic (reloads stay charged — conservative)."""
    pads = band_pad_rows(spec, r0, r1)
    if not pads:
        return 0.0
    return min(pads * spec.w_in * hw.t_l, first_load)


def balanced_row_heights(spec: ConvSpec, hw, n_chips: int,
                         max_group: int | None,
                         solve_kwargs: dict,
                         same_pad: bool = False) -> list[int] | None:
    """Duration-balanced band heights: choose per-chip band heights whose
    solved max-over-chips duration is minimal, instead of balancing raw
    row counts.  The per-height duration curve ``d(rows)`` is probed
    through the shared solver LRU (a binary-search-style scan over the
    candidate heights around the even split — every band pays the same
    ``h_k - s_h`` halo rows, so heights far above ``ceil(h_out/n)`` only
    raise the max), then an exact small DP picks the partition of
    ``h_out`` rows into ``n`` bands minimising ``max d(height)``.  The
    even split is always admissible, so the result never exceeds the
    row-balanced max-over-chips duration (tests/test_multichip_overlap).
    With ``same_pad`` the duration of a band is position-dependent (edge
    bands skip their padding rows' first loads), so the DP prices band
    ``[j-r, j)`` at its actual position and the returned heights keep
    band order — the asymmetric optimum gives edge bands more rows.
    Returns None when some required height has no feasible strategy."""
    n = min(n_chips, spec.h_out)
    base, extra = divmod(spec.h_out, n)
    r_cap = min(spec.h_out, base + (1 if extra else 0) + 1)
    d: dict[int, float] = {}
    fl: dict[int, float] = {}
    for r in range(1, r_cap + 1):
        info = _band_solve(spec, r, hw, max_group, solve_kwargs)
        if info is not None:
            d[r], fl[r] = info

    def band_dur(r0: int, r: int) -> float:
        if not same_pad:
            return d[r]
        return max(0.0, d[r] - _band_pad_saving(spec, r0, r0 + r, hw,
                                                fl[r]))

    inf = float("inf")
    # best[j][k]: minimal max-duration tiling the first j rows with k bands
    best = [[inf] * (n + 1) for _ in range(spec.h_out + 1)]
    pick = [[0] * (n + 1) for _ in range(spec.h_out + 1)]
    best[0][0] = 0.0
    for j in range(1, spec.h_out + 1):
        for k in range(1, n + 1):
            for r in d:
                if r > j:
                    continue
                v = max(best[j - r][k - 1], band_dur(j - r, r))
                if v < best[j][k]:
                    best[j][k] = v
                    pick[j][k] = r
    if best[spec.h_out][n] == inf:
        return None
    heights = []
    j, k = spec.h_out, n
    while k:
        r = pick[j][k]
        heights.append(r)
        j, k = j - r, k - 1
    if same_pad:
        heights.reverse()            # positions matter: keep band order
    else:
        heights.sort(reverse=True)   # widest band on chip 0, like the
    return heights                   # near-even split's extra-row layout


def kernel_shard_specs(spec: ConvSpec, n_chips: int
                       ) -> list[tuple[int, tuple[int, int], ConvSpec]]:
    """Split ``spec``'s kernel set into near-even groups, one per chip.

    Returns ``(chip, (kid0, kid1), shard_spec)`` triples with
    ``shard_spec.n_kernels == kid1 - kid0``; chips beyond ``n_kernels``
    idle."""
    n = min(n_chips, spec.n_kernels)
    base, extra = divmod(spec.n_kernels, n)
    shards = []
    k0 = 0
    for c in range(n):
        k = base + (1 if c < extra else 0)
        shards.append((c, (k0, k0 + k),
                       dataclasses.replace(spec, n_kernels=k)))
        k0 += k
    return shards


def hybrid_shard_specs(spec: ConvSpec, rows: int, cols: int,
                       heights: Sequence[int] | None = None,
                       ) -> list[tuple[int, tuple[int, int],
                                       tuple[int, int], ConvSpec]]:
    """Carve ``spec`` into a ``rows x cols`` grid of (row band x kernel
    group) shards, chip ``i * cols + j`` taking band ``i`` of kernel
    group ``j``.  Returns ``(chip, (row0, row1), (kid0, kid1),
    shard_spec)`` quadruples.  Unlike the pure modes, the grid must be
    fully active — a layer with fewer output rows than ``rows`` (or
    fewer kernels than ``cols``) cannot be hybrid-sharded."""
    if rows > spec.h_out or cols > spec.n_kernels:
        raise ValueError(
            f"hybrid grid {rows}x{cols} does not fit layer "
            f"h_out={spec.h_out}, n_kernels={spec.n_kernels}")
    bands = row_shard_specs(spec, rows, heights)
    kgroups = kernel_shard_specs(spec, cols)
    shards = []
    for i, (_, band, bspec) in enumerate(bands):
        for j, (_, krange, _) in enumerate(kgroups):
            shards.append((i * cols + j, band, krange,
                           dataclasses.replace(
                               bspec, n_kernels=krange[1] - krange[0])))
    return shards


def halo_elements(spec: ConvSpec) -> int:
    """Elements one band boundary exchanges between consecutive
    row-sharded layers: the consumer's halo rows (``h_k - s_h`` input
    rows when the stride undershoots the kernel, else none), channel
    expanded."""
    return max(0, spec.h_k - spec.s_h) * spec.w_in * spec.c_in


def halo_pixel_mask(spec: ConvSpec) -> int:
    """Pixel mask of a band shard's inbound halo: the last
    ``max(0, h_k - s_h)`` rows of its local input window — the rows a
    row->row transition delivers from the chip below."""
    halo_rows = max(0, spec.h_k - spec.s_h)
    mask = 0
    for h in range(spec.h_in - halo_rows, spec.h_in):
        mask |= ((1 << spec.w_in) - 1) << (h * spec.w_in)
    return mask


def halo_first_use(strategy, spec: ConvSpec, hw: HardwareModel) -> float:
    """Def-3 time a shard schedule computes before its first step loads
    a halo pixel — the window an overlapped inbound halo exchange can
    stream in without a write-after-read on the live input.  ``inf``
    when the schedule never reads the halo (or there is none); ``0.0``
    for non-grouped (S2) strategies, whose kernel-swap interleaving the
    timing model does not cover — conservatively never overlap-safe."""
    mask = halo_pixel_mask(spec)
    if not mask:
        return float("inf")
    if not isinstance(strategy, GroupedStrategy):
        return 0.0
    t = 0.0
    for s in strategy.to_steps():
        if s.i_slice & mask:
            return t
        t += formalism.step_duration(s, spec, hw)
    return float("inf")


def _halo_safe_time(shards: Sequence["ShardPlan"],
                    hw: HardwareModel) -> float:
    """Earliest halo first-use across the bands that receive one (every
    band but the bottom); ``inf`` when no band ever reads its halo."""
    bands = [s for s in shards if s.out_rows is not None]
    if not bands:
        return float("inf")
    last_r1 = max(s.out_rows[1] for s in bands)
    return min((halo_first_use(s.strategy, s.spec, hw)
                for s in bands if s.out_rows[1] != last_r1),
               default=float("inf"))


# --------------------------------------------------------------------- #
# ICI pricing: activation layouts and resharding
# --------------------------------------------------------------------- #

_REQUIRED_LAYOUT = {"replicate": "single", "row": "row", "channel": "all",
                    "hybrid": "rowgrid"}


def _produced_layout(mode: str, active_chips: int,
                     grid: tuple[int, int] | None = None) -> str:
    """Layout of a layer's output map.  A single active shard owns the
    whole map, whatever the nominal mode; a hybrid grid with a trivial
    axis collapses to the pure mode's layout (the ``r x 1`` / ``1 x c``
    degeneracies)."""
    if active_chips <= 1:
        return "single"
    if mode == "hybrid":
        ny, nx = grid
        if nx == 1:
            return "row"
        if ny == 1:
            return "channel"
        return "hybrid"
    return {"replicate": "single", "row": "row", "channel": "channel"}[mode]


def _transition_elements(frm: str, mode: str, nxt: ConvSpec,
                         a_full: int, cluster: ClusterModel) -> int:
    """Bottleneck-link ICI elements to reshape an activation from layout
    ``frm`` into what ``mode`` requires for consumer ``nxt``, priced by
    the cluster's :class:`~repro_torch.core.cost_model.Topology` collectives:

    * gather/scatter against one chip and the all-gather from any
      sharded layout funnel ``(k-1)/k`` of the tensor through a
      bottleneck link per ring axis (halved on bidirectional links);
    * a pipelined broadcast pushes the full tensor through the source's
      link, once per torus axis;
    * row->row costs only the halo (links run in parallel, so one
      boundary's rows bound the phase);
    * channel->row (and any reshard out of hybrid) is an all-to-all,
      priced at the all-gather bound;
    * the hybrid input layout (``rowgrid``: band rows along axis 0,
      replicated along axis 1) decomposes per axis — band all-gather
      along the kernel-channel rings plus the axis-0 halo shift; its
      trivial-axis cases collapse to the ``row`` / ``all`` rules, which
      is what makes ``r x 1`` / ``1 x c`` grids price exactly like the
      pure modes.

    On the unidirectional ring every rule reduces to the PR-3 formulas
    bit-exactly (``ceil(A*(n-1)/n)`` splits, ``A`` broadcast).
    """
    n_chips = cluster.n_chips
    if n_chips == 1 or frm == "all":
        return 0
    topo = cluster.topo
    ny, nx = topo.grid(n_chips)
    to = _REQUIRED_LAYOUT[mode]
    if to == "rowgrid":                    # trivial-axis degeneracies
        if nx == 1:
            to = "row"
        elif ny == 1:
            to = "all"
    if to == "single":
        return 0 if frm == "single" else topo.gather(n_chips, a_full)
    if to == "row":
        if frm == "row":
            return halo_elements(nxt)
        if frm == "single":
            return topo.scatter(n_chips, a_full)
        return topo.all_to_all(n_chips, a_full)   # channel / hybrid
    if to == "all":
        if frm == "single":
            return topo.bcast(n_chips, a_full)    # pipelined broadcast
        return topo.allgather(n_chips, a_full)
    # to == "rowgrid": every chip needs its band's rows, all channels
    if frm == "single":
        return (topo.scatter_axis0(n_chips, a_full)
                + topo.bcast_axis1(n_chips, a_full))
    if frm in ("row", "hybrid"):
        return (topo.allgather_axis1(n_chips, a_full)
                + (halo_elements(nxt) if ny > 1 else 0))
    return topo.all_to_all(n_chips, a_full)       # channel -> rowgrid


# --------------------------------------------------------------------- #
# Plan dataclasses
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One chip's slice of one layer."""

    chip: int
    spec: ConvSpec                       # the shard's sub-convolution
    p: int
    result: solver_mod.SolveResult
    out_rows: tuple[int, int] | None     # row/hybrid: output-row band
    kernel_range: tuple[int, int] | None  # channel/hybrid: kernel ids
    gross_duration: float                # full Def-3 duration on its chip
    pad_saved: float = 0.0               # same_pad: edge-band first loads
    #   skipped (gross_duration already excludes them; the simulator
    #   reconciles measured == gross + pad_saved)

    @property
    def strategy(self):
        return self.result.strategy

    @property
    def mode(self) -> str:
        return self.result.mode          # 's1' | 's2'


@dataclasses.dataclass(frozen=True)
class MultiChipLayerPlan:
    """One layer's slot in the cluster schedule."""

    index: int
    spec: ConvSpec
    mode: str                # 'replicate' | 'row' | 'channel' | 'hybrid'
    shards: tuple[ShardPlan, ...]
    compute_duration: float              # max over chips (Def-3 gross)
    ici_elements: int                    # bottleneck-link elements, inbound
    ici_duration: float
    savings: float = 0.0                 # 1-chip path: inter-layer reuse
    overlap: bool = False                # this stage's inbound ICI is
    #   double-buffered under compute; for halo exchanges the planner
    #   only sets it after proving the bands read their halo late enough
    #   (halo_first_use), so serial-priced stages can coexist in an
    #   overlap=True plan
    grid: tuple[int, int] | None = None  # hybrid: (rows, cols) shard grid

    def __post_init__(self):
        if self.duration < -1e-9:
            raise AssertionError(
                f"layer {self.index}: negative duration {self.duration}")

    @property
    def active_chips(self) -> int:
        return len(self.shards)

    @property
    def duration(self) -> float:
        """Serialised (paper Def-3 spirit): compute + ICI.  Overlapped
        (double-buffered halo exchange, Stoutchinin-style): the inbound
        ICI hides under the stage's compute, max(compute, ICI)."""
        if self.overlap:
            return max(self.compute_duration, self.ici_duration) \
                - self.savings
        return self.compute_duration + self.ici_duration - self.savings


@dataclasses.dataclass(frozen=True)
class MultiChipPlan:
    """A solved whole-network cluster schedule."""

    name: str
    cluster: ClusterModel
    layers: tuple[MultiChipLayerPlan, ...]
    total_duration: float
    final_gather_elements: int           # last layout -> chip 0
    final_gather_duration: float
    single_chip_duration: float | None   # plan_network total (reuse incl.)
    network_plan: NetworkPlan | None     # the delegated 1-chip plan
    planning_seconds: float
    solver_calls: int
    cache_hits: int
    overlap: bool = False                # overlap requested; each layer's
    #   own flag records whether its stage actually overlapped
    balance_rows: bool = False           # duration-balanced band heights

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def n_sharded_layers(self) -> int:
        return sum(1 for lp in self.layers if lp.mode != "replicate")

    @property
    def mode_string(self) -> str:
        tag = {"replicate": "R", "row": "W", "channel": "K", "hybrid": "H"}
        return "".join(tag[lp.mode] for lp in self.layers)

    @property
    def ici_duration(self) -> float:
        return (sum(lp.ici_duration for lp in self.layers)
                + self.final_gather_duration)

    @property
    def ici_fraction(self) -> float:
        if self.total_duration <= 0:
            return 0.0
        return self.ici_duration / self.total_duration

    @property
    def speedup_vs_single_chip(self) -> float | None:
        if self.single_chip_duration is None or self.total_duration <= 0:
            return None
        return self.single_chip_duration / self.total_duration

    @property
    def peak_footprint(self) -> int:
        """Largest per-chip resident peak across all shards."""
        return max(s.strategy.peak_footprint_elements()
                   for lp in self.layers for s in lp.shards)

    def report(self) -> str:
        c = self.cluster
        lines = [f"multichip plan: {self.name}  "
                 f"({c.n_chips} chips, {c.topo.describe()}, "
                 f"t_ici={c.t_ici:g}, "
                 f"{self.n_layers} layers, planned in "
                 f"{self.planning_seconds:.2f}s, "
                 f"{self.cache_hits}/{self.solver_calls} cache hits)"]
        for lp in self.layers:
            per_chip = " ".join(f"c{s.chip}:{s.gross_duration:g}"
                                for s in lp.shards)
            combine = ("max overlapped ici" if lp.overlap else "+ ici")
            mode = lp.mode if lp.grid is None else \
                f"hybrid{lp.grid[0]}x{lp.grid[1]}"
            lines.append(
                f"  L{lp.index}: {mode:<9} x{lp.active_chips} "
                f"dur={lp.duration:g} (compute {lp.compute_duration:g}"
                f" {combine} {lp.ici_duration:g}"
                f"{f' - reuse {lp.savings:g}' if lp.savings else ''})"
                f"  [{per_chip}]")
        if self.final_gather_duration:
            lines.append(f"  final gather -> chip 0: "
                         f"{self.final_gather_elements} elements, "
                         f"{self.final_gather_duration:g}")
        tail = f"  total={self.total_duration:g} " \
               f"(ici {self.ici_fraction:.1%}, modes {self.mode_string})"
        if self.single_chip_duration is not None:
            tail += f"; 1-chip {self.single_chip_duration:g} " \
                    f"(speedup {self.speedup_vs_single_chip:.2f}x)"
        lines.append(tail)
        return "\n".join(lines)


# --------------------------------------------------------------------- #
# Per-layer mode evaluation
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class _ModeEval:
    mode: str
    shards: tuple[ShardPlan, ...]
    compute_duration: float
    grid: tuple[int, int] | None = None  # hybrid shard grid
    halo_safe: float = float("inf")      # earliest halo read across bands
    alt: "_ModeEval | None" = None       # zigzag-swapped overlap variant

    @property
    def layout(self) -> str:
        return _produced_layout(self.mode, len(self.shards), self.grid)


def _zigzag_swapped(shards: Sequence[ShardPlan], spec: ConvSpec,
                    hw: HardwareModel, same_pad: bool,
                    nb_data_reload: int) -> "tuple[ShardPlan, ...] | None":
    """Variant of a row eval with every halo-receiving band re-solved as
    a plain zigzag sweep: the sweep reads its input top to bottom, so
    the halo rows (the window's last rows) are read last, maximising
    the overlap-safe window.  ``None`` when nothing changes or a swap
    would break the memory budget."""
    bands = [s for s in shards if s.out_rows is not None]
    if not bands:
        return None
    last_r1 = max(s.out_rows[1] for s in bands)
    new: list[ShardPlan] = []
    changed = False
    for s in shards:
        if s.out_rows is None or s.out_rows[1] == last_r1 \
                or not isinstance(s.strategy, GroupedStrategy):
            new.append(s)
            continue
        zz = zigzag(s.spec, s.p)
        if zz.groups == s.strategy.groups:
            new.append(s)
            continue
        if hw.size_mem is not None and \
                zz.peak_footprint_elements() > hw.size_mem:
            return None
        obj = zz.objective(hw)
        res = dataclasses.replace(
            s.result, strategy=zz, objective=obj, polish_objective=obj,
            milp_status="overlap-swap", milp_objective=None,
            reload_ok=zz.max_reloads() <= nb_data_reload)
        saved = 0.0
        if same_pad:
            r0, r1 = s.out_rows
            saved = _band_pad_saving(spec, r0, r1, hw,
                                     zz.first_load_duration(hw))
        new.append(dataclasses.replace(
            s, result=res, gross_duration=zz.full_duration(hw) - saved,
            pad_saved=saved))
        changed = True
    if not changed:
        return None
    return tuple(new)


def _eval_mode(spec: ConvSpec, mode: str, cluster: ClusterModel,
               max_group: int | None, solve_kwargs: dict,
               balance_rows: bool = False,
               same_pad: bool = False,
               overlap: bool = False,
               ) -> _ModeEval | None:
    """Solve every shard of ``spec`` under ``mode`` through the LRU-cached
    solver; None when any shard fits no strategy family or the mode does
    not apply (hybrid off-torus, or a hybrid grid the layer can't fill).
    With ``overlap``, row evals also carry their halo-safety window
    (:func:`_halo_safe_time`) and, when it helps, a zigzag-swapped
    alternative whose bands read the halo later."""
    hw = cluster.chip
    grid = None
    if mode == "replicate":
        raw = [(0, None, None, spec)]
    elif mode == "row":
        heights = None
        if balance_rows:
            heights = balanced_row_heights(spec, hw, cluster.n_chips,
                                           max_group, solve_kwargs,
                                           same_pad=same_pad)
        raw = [(c, band, None, s)
               for c, band, s in row_shard_specs(spec, cluster.n_chips,
                                                 heights)]
    elif mode == "channel":
        raw = [(c, None, krange, s)
               for c, krange, s in kernel_shard_specs(spec, cluster.n_chips)]
    elif mode == "hybrid":
        if cluster.topo.kind != "torus":
            return None                  # needs a second axis to shard on
        ny, nx = cluster.topo.grid(cluster.n_chips)
        if ny > spec.h_out or nx > spec.n_kernels:
            return None                  # infeasible chip grid: the full
        grid = (ny, nx)                  # rows x cols grid must be active
        heights = None
        if balance_rows:
            # the widest kernel group's bands dominate the per-chip max
            kmax = max(k1 - k0 for _, (k0, k1), _ in
                       kernel_shard_specs(spec, nx))
            heights = balanced_row_heights(
                dataclasses.replace(spec, n_kernels=kmax), hw, ny,
                max_group, solve_kwargs, same_pad=same_pad)
        raw = hybrid_shard_specs(spec, ny, nx, heights)
    else:
        raise ValueError(f"unknown sharding mode {mode!r}")
    shards = []
    for chip, band, krange, sspec in raw:
        p = resolve_group_size(sspec, hw, max_group)
        try:
            res = solver_mod.solve_cached(sspec, p, hw, **solve_kwargs)
        except ValueError:
            return None
        if hw.size_mem is not None and \
                res.strategy.peak_footprint_elements() > hw.size_mem:
            return None
        saved = 0.0
        if same_pad:
            # every shard skips the padding rows inside its own input
            # window — replicate/channel shards span the full height, so
            # they get the whole-map credit and the mode DP stays
            # consistently priced across the alphabet
            r0, r1 = band if band is not None else (0, spec.h_out)
            saved = _band_pad_saving(
                spec, r0, r1, hw,
                res.strategy.first_load_duration(hw))
        shards.append(ShardPlan(
            chip=chip, spec=sspec, p=p, result=res,
            out_rows=band, kernel_range=krange,
            gross_duration=res.strategy.full_duration(hw) - saved,
            pad_saved=saved))
    halo_safe, alt = float("inf"), None
    if overlap and mode == "row":
        halo_safe = _halo_safe_time(shards, hw)
        swapped = _zigzag_swapped(shards, spec, hw, same_pad,
                                  solve_kwargs.get("nb_data_reload", 2))
        if swapped is not None:
            alt_safe = _halo_safe_time(swapped, hw)
            if alt_safe > halo_safe:
                alt = _ModeEval(
                    mode=mode, shards=swapped,
                    compute_duration=max(s.gross_duration
                                         for s in swapped),
                    grid=grid, halo_safe=alt_safe)
    return _ModeEval(mode=mode, shards=tuple(shards),
                     compute_duration=max(s.gross_duration for s in shards),
                     grid=grid, halo_safe=halo_safe, alt=alt)


def ici_schedule(specs: Sequence[ConvSpec], modes: Sequence[str],
                 active: Sequence[int], cluster: ClusterModel,
                 ) -> tuple[list[int], int]:
    """Re-derive the per-layer inbound ICI element counts (and the final
    gather to chip 0) from a mode sequence — the pure pricing function
    the planner charges and the simulator cross-checks."""
    if len(specs) != len(modes) or len(specs) != len(active):
        raise ValueError("specs/modes/active length mismatch")
    grid = cluster.topo.grid(cluster.n_chips)
    per_layer = []
    layout = _INPUT_LAYOUT
    for spec, mode, n_act in zip(specs, modes, active):
        per_layer.append(_transition_elements(
            layout, mode, spec, spec.num_pixels * spec.c_in, cluster))
        layout = _produced_layout(mode, n_act,
                                  grid if mode == "hybrid" else None)
    last = specs[-1]
    final = _transition_elements(
        layout, "replicate", last, last.num_patches * last.c_out, cluster)
    return per_layer, final


# --------------------------------------------------------------------- #
# Front door
# --------------------------------------------------------------------- #

def plan_multichip_network(specs: Sequence[ConvSpec], cluster: ClusterModel,
                           *,
                           name: str = "network",
                           max_group: int | None = 16,
                           nb_data_reload: int = 2,
                           polish_iters: int = 6_000,
                           polish_restarts: int = 4,
                           use_milp: bool = False,
                           time_limit: float = 10.0,
                           rng_seed: int = 0,
                           modes: Sequence[str] | None = None,
                           include_single_chip_baseline: bool = True,
                           overlap: bool = False,
                           balance_rows: bool = False,
                           same_pad: bool = False,
                           verify: bool | None = None,
                           ) -> MultiChipPlan:
    """Plan a conv network on ``cluster.n_chips`` chips wired as
    ``cluster.topology`` (unidirectional/bidirectional ring or 2-D torus).

    ``n_chips == 1`` delegates to :func:`plan_network` and reproduces its
    plan exactly (same strategies, same total duration, inter-layer reuse
    included).  Otherwise every layer's feasible sharding modes are priced
    — shards through ``solver.solve_cached`` (budget-aware S1/S2 choice,
    LRU-shared with the single-chip planner), resharding over
    topology-priced ICI collectives — and a dynamic program picks the
    mode sequence minimising total duration including a final gather of
    the last activation to chip 0.  ``modes`` defaults to the topology's
    alphabet (:func:`mode_alphabet`: hybrid row x channel grids need a
    torus).  Raises :class:`InfeasibleNetworkError` when some layer fits
    under no mode — the message names the layer, budget, chip count and
    topology.

    ``overlap=True`` prices each layer's inbound ICI as double-buffered
    against compute — per-layer duration ``max(compute, ICI)`` instead of
    ``compute + ICI`` (the halo/reshard of stage l streams while stage
    l-1's band is still computing; only the final gather stays serial).
    Halo exchanges between consecutive row-sharded layers only get the
    overlapped price when the receiving bands provably read their halo
    rows after the exchange can have delivered them (WAR-free by
    ``halo_first_use`` timing); unsound stages are re-solved with
    halo-last zigzag bands or serialised, whichever is cheaper, and each
    layer's ``overlap`` flag records what was actually priced.
    ``balance_rows=True`` sizes row bands by solved per-chip *duration*
    (:func:`balanced_row_heights`) instead of raw row counts.
    ``same_pad=True`` asserts the already-padded inputs are SAME padding,
    so edge bands skip their padding rows' first loads (position-
    dependent band durations; see the module note).  All three default
    to False, which reproduces the serialised row-balanced accounting
    bit-exactly (the paper's Def-3 spirit; the benchmark's trajectory
    baseline).

    ``verify=True`` runs the static plan verifier
    (``repro_torch.analysis.verifier``) as a postcondition and raises
    ``PlanVerificationError`` on any error-severity diagnostic; the
    default ``None`` defers to the ``REPRO_VERIFY_PLANS`` env knob.
    """
    specs = list(specs)
    if not specs:
        raise ValueError("empty network")
    if same_pad and cluster.n_chips == 1:
        raise ValueError(
            "same_pad models the sharded planner's band accounting; the "
            "1-chip path delegates to plan_network, which does not model "
            "padding — plan with n_chips >= 2 or drop same_pad")
    if modes is None:
        modes = mode_alphabet(cluster)
    solve_kwargs = dict(nb_data_reload=nb_data_reload,
                        time_limit=time_limit, polish_iters=polish_iters,
                        use_milp=use_milp, rng_seed=rng_seed,
                        polish_restarts=polish_restarts)
    plan_kwargs = dict(max_group=max_group, **solve_kwargs)

    from repro_torch.analysis.verifier import assert_verified, should_verify
    do_verify = should_verify(verify)

    if cluster.n_chips == 1:
        # the delegated plan is verified through the MultiChipPlan below
        net = plan_network(specs, cluster.chip, name=name, verify=False,
                           **plan_kwargs)
        layers = tuple(
            MultiChipLayerPlan(
                index=lp.index, spec=lp.spec, mode="replicate",
                shards=(ShardPlan(
                    chip=0, spec=lp.spec, p=lp.p, result=lp.result,
                    out_rows=None, kernel_range=None,
                    gross_duration=lp.gross_duration),),
                compute_duration=lp.gross_duration,
                ici_elements=0, ici_duration=0.0,
                savings=lp.input_load_saved + lp.write_back_saved,
                overlap=overlap)
            for lp in net.layers)
        plan = MultiChipPlan(
            name=name, cluster=cluster, layers=layers,
            total_duration=net.total_duration,
            final_gather_elements=0, final_gather_duration=0.0,
            single_chip_duration=net.total_duration,
            network_plan=net,
            planning_seconds=net.planning_seconds,
            solver_calls=net.solver_calls, cache_hits=net.cache_hits,
            overlap=overlap, balance_rows=balance_rows)
        if do_verify:
            assert_verified(plan)
        return plan

    # per-stage cache attribution: deltas of a full counter snapshot, so
    # the DP window below never claims the nested single-chip baseline's
    # (or a concurrent planner's) hits
    stats0 = solver_mod.cache_stats()
    t0 = time.perf_counter()

    # 1) per-layer feasible mode evaluations
    evals: list[dict[str, _ModeEval]] = []
    for i, spec in enumerate(specs):
        layer_evals = {}
        for mode in modes:
            ev = _eval_mode(spec, mode, cluster, max_group, solve_kwargs,
                            balance_rows=balance_rows, same_pad=same_pad,
                            overlap=overlap)
            if ev is not None:
                layer_evals[mode] = ev
        if not layer_evals:
            raise InfeasibleNetworkError(
                f"layer {i} ({spec.c_in}x{spec.h_in}x{spec.w_in}"
                f"->{spec.c_out}): no sharding mode fits "
                f"size_mem={cluster.chip.size_mem} on "
                f"{cluster.n_chips} chips ({cluster.topo.describe()}; "
                f"a hybrid grid also needs rows<=h_out={spec.h_out} "
                f"and cols<=n_kernels={spec.n_kernels})")
        evals.append(layer_evals)

    # 2) Viterbi DP over (layer, mode): resharding couples neighbours
    t_ici = cluster.t_ici
    # cost[mode] = best total through layer i ending in this mode
    cost: dict[str, float] = {}
    back: list[dict[str, tuple[str | None, int, str]]] = []
    for i, layer_evals in enumerate(evals):
        nxt_cost: dict[str, float] = {}
        choices: dict[str, tuple[str | None, int, str]] = {}
        # resharding moves the consumer's (post-pooling) input map — the
        # tensor that must land in the consumer's layout.
        a_full = specs[i].num_pixels * specs[i].c_in

        def stage_price(ev: _ModeEval, elems: int,
                        prev_layout: str) -> tuple[float, str]:
            """(duration, variant) of this layer fed by ``elems`` inbound
            ICI elements.  Serial Def-3 pricing by default; with
            ``overlap``, a generic reshard hides under compute — the
            consumer cannot start before it anyway, so max(compute, ICI)
            is the pipeline bound — but a row->row *halo* exchange
            writes rows the consumer already holds live, so it may only
            overlap when every receiving band provably reads its halo
            after the exchange can have delivered it
            (:func:`halo_first_use`).  Otherwise the planner considers
            the zigzag-swapped variant ('ovl-alt': bands re-solved so
            the halo is read last) and serial pricing, picking the
            cheaper; ``ici/war-overlap`` in ``analysis.verifier``
            re-proves whichever claim is made."""
            ici = elems * t_ici
            if not overlap:
                return ev.compute_duration + ici, "serial"
            halo_like = (ev.mode == "row" and prev_layout == "row"
                         and elems == halo_elements(specs[i])
                         and elems > 0)
            if not halo_like:
                return max(ev.compute_duration, ici), "ovl"
            cands = [(ev.compute_duration + ici, "serial")]
            if ici <= ev.halo_safe + 1e-9:
                cands.append((max(ev.compute_duration, ici), "ovl"))
            elif ev.alt is not None and ici <= ev.alt.halo_safe + 1e-9:
                cands.append(
                    (max(ev.alt.compute_duration, ici), "ovl-alt"))
            return min(cands)

        for mode, ev in layer_evals.items():
            if i == 0:
                elems = _transition_elements(
                    _INPUT_LAYOUT, mode, specs[i], a_full, cluster)
                val, variant = stage_price(ev, elems, _INPUT_LAYOUT)
                nxt_cost[mode] = val
                choices[mode] = (None, elems, variant)
                continue
            best: tuple[float, str | None, int, str] = \
                (float("inf"), None, 0, "serial")
            for pmode, pcost in cost.items():
                prev_layout = evals[i - 1][pmode].layout
                elems = _transition_elements(
                    prev_layout, mode, specs[i], a_full, cluster)
                val, variant = stage_price(ev, elems, prev_layout)
                if pcost + val < best[0]:
                    best = (pcost + val, pmode, elems, variant)
            nxt_cost[mode] = best[0]
            choices[mode] = (best[1], best[2], best[3])
        cost = nxt_cost
        back.append(choices)

    # final gather of the last activation to chip 0
    last = specs[-1]
    a_last = last.num_patches * last.c_out
    best_mode, best_total, final_elems = None, float("inf"), 0
    for mode, val in cost.items():
        elems = _transition_elements(
            evals[-1][mode].layout, "replicate", last, a_last, cluster)
        if val + elems * t_ici < best_total:
            best_mode, best_total = mode, val + elems * t_ici
            final_elems = elems

    # 3) backtrack
    chosen: list[str] = [best_mode]
    in_elems: list[int] = []
    variants: list[str] = []
    for i in range(len(specs) - 1, -1, -1):
        prev_mode, elems, variant = back[i][chosen[0]]
        in_elems.insert(0, elems)
        variants.insert(0, variant)
        if i > 0:
            chosen.insert(0, prev_mode)
    planning_seconds = time.perf_counter() - t0
    # the DP's own attribution window closes BEFORE the single-chip
    # baseline runs — historically the readback after that baseline let
    # the nested plan_network claim its solves in this plan's counters
    dp_stats = solver_mod.cache_stats() - stats0
    # observability hooks (lazy import — see core.network_planner)
    from repro_torch.obs.metrics import REGISTRY
    REGISTRY.incr("planner/multichip_calls")
    REGISTRY.incr("planner/multichip_s", planning_seconds)
    REGISTRY.incr("planner/stage/multichip/calls", dp_stats.solve_calls)
    REGISTRY.incr("planner/stage/multichip/hits", dp_stats.solve_hits)

    def _layer(i: int) -> MultiChipLayerPlan:
        ev = evals[i][chosen[i]]
        if variants[i] == "ovl-alt":
            ev = ev.alt
        return MultiChipLayerPlan(
            index=i, spec=specs[i], mode=chosen[i],
            shards=ev.shards,
            compute_duration=ev.compute_duration,
            ici_elements=in_elems[i],
            ici_duration=in_elems[i] * t_ici,
            overlap=variants[i] != "serial",
            grid=ev.grid)

    layers = tuple(_layer(i) for i in range(len(specs)))

    single = None
    if include_single_chip_baseline:
        base0 = solver_mod.cache_stats()
        try:
            # a pricing reference, not an emitted plan: skip verification
            net = plan_network(specs, cluster.chip, name=name,
                               verify=False, **plan_kwargs)
            single = net.total_duration
            if same_pad:
                # credit the baseline with the same whole-map padding
                # savings the shards get, clamped to each layer's first
                # loads NOT already covered by inter-layer reuse — so
                # speedup_vs_single_chip compares consistently-padded
                # accountings and never double-counts a saved load
                hw = cluster.chip
                for lp in net.layers:
                    whole = _band_pad_saving(
                        lp.spec, 0, lp.spec.h_out, hw,
                        lp.result.strategy.first_load_duration(hw))
                    single -= min(whole, max(
                        0.0, lp.result.strategy.first_load_duration(hw)
                        - lp.input_load_saved))
        except InfeasibleNetworkError:
            single = None               # sharding extends feasibility
        base_stats = solver_mod.cache_stats() - base0
        REGISTRY.incr("planner/stage/single_baseline/calls",
                      base_stats.solve_calls)
        REGISTRY.incr("planner/stage/single_baseline/hits",
                      base_stats.solve_hits)

    plan = MultiChipPlan(
        name=name, cluster=cluster, layers=layers,
        total_duration=best_total,
        final_gather_elements=final_elems,
        final_gather_duration=final_elems * t_ici,
        single_chip_duration=single,
        network_plan=None,
        planning_seconds=planning_seconds,
        solver_calls=dp_stats.solve_calls,
        cache_hits=dp_stats.solve_hits,
        overlap=overlap, balance_rows=balance_rows)
    if do_verify:
        assert_verified(plan)
    return plan


def replan_suffix(specs: Sequence[ConvSpec], cluster: ClusterModel, *,
                  start: int, name: str = "network",
                  **kwargs) -> MultiChipPlan:
    """Re-plan the tail ``specs[start:]`` of a network — the
    degraded-mode re-planning entry point (``repro_torch.resil``): after a
    chip death, link degradation or budget shrink, the remaining layers
    are planned afresh on the surviving/repriced ``cluster``.  The call
    is warm-started automatically: per-layer solves go through the
    ``solver.solve_cached`` LRU shared with every other planner, so
    layers whose shard geometry survives the degradation hit the cache.

    Layer indices in the returned plan are local to the suffix (global
    layer = ``start`` + local); the engine keeps the mapping.  The first
    suffix layer is priced from the planner's usual ``_INPUT_LAYOUT``
    ("all" — every chip holds its input), which recovery pays for
    explicitly by restaging the last committed activation from the
    durable store (see ``repro_torch.resil.engine``).
    """
    if not 0 <= start < len(specs):
        raise ValueError(
            f"suffix start {start} out of range for {len(specs)} layers")
    return plan_multichip_network(
        list(specs[start:]), cluster,
        name=f"{name}[{start}:]", **kwargs)
