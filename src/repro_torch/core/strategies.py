"""Strategies (paper Sec 4): S1-baseline, S1 grouped, Row-by-Row, ZigZag —
plus two beyond-paper group constructors (Tiled, Hilbert).

A *grouped strategy* (Def 16) is an ordered partition of the patch set X into
groups ``g_1..g_n`` with ``|g_k| <= nb_patches_max_S1``.  Executing group
``g_k`` as step ``s_k`` gives, with the eager-free policy of Def 16:

    M_k.inp   = pixels(g_k)                       (exactly)
    I_slice_k = pixels(g_k) \\ pixels(g_{k-1})
    F_inp_k   = M_{k-1}.inp \\ pixels(g_k)

so the S1 objective (eq. 15) reduces to

    delta = t_l * sum_k |pixels(g_k) \\ pixels(g_{k-1})| + n * t_acc .

Outputs are written back at the *next* step (Sec 7.1 assumption), which
forces a terminal flush step s_{n+1} that frees the kernels (F^ker_n = Λ of
Def 16) and writes back the last group's outputs, leaving memory empty.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import Step


Groups = list[tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class GridMeta:
    """A grouped strategy recognised as a Pallas grid sweep.

    The S1 conv kernels iterate a ``(h_out, w_out // t_run)`` grid, one
    row-run of ``t_run`` output columns per step, rows top-to-bottom and
    column tiles in ``order`` ("zigzag" alternates direction per row,
    "row" restarts at the left edge).  When
    :meth:`GroupedStrategy.as_grid` returns this, the strategy's step
    sequence is *exactly* the kernel's grid order and
    ``kernels.emit.emit_layer_kernel`` can execute the plan.
    """

    order: str                  # "zigzag" | "row"
    t_run: int
    h_out: int
    w_out_tiles: int

    @property
    def grid(self) -> tuple[int, int]:
        return (self.h_out, self.w_out_tiles)


@dataclasses.dataclass(frozen=True)
class GroupedStrategy:
    """An ordered partition of patches into compute groups."""

    name: str
    spec: ConvSpec
    groups: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        seen: set[int] = set()
        for g in self.groups:
            if not g:
                raise ValueError("empty group")
            for pid in g:
                if pid in seen:
                    raise ValueError(f"patch {pid} in two groups")
                seen.add(pid)
        if len(seen) != self.spec.num_patches:
            raise ValueError(
                f"{self.name}: groups cover {len(seen)} of "
                f"{self.spec.num_patches} patches")

    @property
    def n_steps(self) -> int:
        return len(self.groups)

    def max_group_size(self) -> int:
        return max(len(g) for g in self.groups)

    def as_grid(self) -> GridMeta | None:
        """Recognise this strategy as a kernel grid sweep, if it is one.

        Requires every group to be one row-run of a uniform ``t_run``
        dividing ``w_out``, with the runs visited in zigzag or row order
        (zigzag preferred when both match, e.g. ``h_out == 1``).
        Within-group patch order is irrelevant — steps are built from
        group *masks* — so groups are compared as sets.  Returns None
        for anything else (tiled/hilbert groups, ragged runs), which the
        emitter reports as a non-emitable plan.
        """
        spec = self.spec
        t = len(self.groups[0])
        if any(len(g) != t for g in self.groups):
            return None
        if spec.w_out % t != 0:
            return None
        tiles = spec.w_out // t
        if len(self.groups) != spec.h_out * tiles:
            return None
        got = [tuple(sorted(g)) for g in self.groups]
        for order in ("zigzag", "row"):
            want = []
            for i in range(spec.h_out):
                cols = range(tiles)
                if order == "zigzag" and i % 2 == 1:
                    cols = reversed(cols)
                for jt in cols:
                    want.append(tuple(spec.patch_id(i, jt * t + u)
                                      for u in range(t)))
            if got == want:
                return GridMeta(order=order, t_run=t, h_out=spec.h_out,
                                w_out_tiles=tiles)
        return None

    # ------------------------------------------------------------------ #
    def to_steps(self) -> list[Step]:
        """Materialise Def 16 into the Def 1/2 step sequence."""
        spec = self.spec
        all_kernels = (1 << spec.n_kernels) - 1
        steps: list[Step] = []
        prev_pix = 0
        prev_out = 0
        for k, g in enumerate(self.groups):
            need = spec.group_mask(g)
            out = 0
            for pid in g:
                out |= 1 << pid
            steps.append(Step(
                f_inp=prev_pix & ~need,
                f_ker=0,
                w=prev_out,                    # write-back at next step
                i_slice=need & ~prev_pix,
                k_sub=all_kernels if k == 0 else 0,
                out=out,
                group=tuple(g)))
            prev_pix, prev_out = need, out
        # terminal flush: empty the memory, write the last outputs back.
        steps.append(Step(f_inp=prev_pix, f_ker=all_kernels, w=prev_out))
        return steps

    # ------------------------------------------------------------------ #
    def objective(self, hw: HardwareModel) -> float:
        """Eq. 15: t_l * sum|I_slice| + n * t_acc (kernel load + writes
        excluded, as in the paper's Sec 5.4/7.1 experiments)."""
        return (hw.t_l * self.pixels_loaded()
                + self.n_steps * hw.t_acc)

    def pixels_loaded(self) -> int:
        """sum_k |pixels(g_k) \\ pixels(g_{k-1})| (spatial units)."""
        total, prev = 0, 0
        for g in self.groups:
            cur = self.spec.group_mask(g)
            total += (cur & ~prev).bit_count()
            prev = cur
        return total

    def loads_per_pixel(self) -> dict[int, int]:
        loads: dict[int, int] = {}
        prev = 0
        for g in self.groups:
            cur = self.spec.group_mask(g)
            new = cur & ~prev
            for j in self.spec.pixels_of_mask(new):
                loads[j] = loads.get(j, 0) + 1
            prev = cur
        return loads

    def max_reloads(self) -> int:
        return max(self.loads_per_pixel().values())

    def peak_input_footprint(self) -> int:
        """max_k |pixels(g_k)| in spatial units."""
        return max(self.spec.group_mask(g).bit_count() for g in self.groups)

    def peak_footprint_elements(self) -> int:
        """Upper bound on resident tensor elements during any step: the
        kernel set Λ, the largest group's input pixels (channel-expanded),
        and two groups' outputs (write-back happens at the *next* step, so
        the previous group's outputs coexist with the current one's)."""
        return (self.spec.kernel_elements
                + self.peak_input_footprint() * self.spec.c_in
                + 2 * self.max_group_size() * self.spec.c_out)

    def peak_working_set_elements(self) -> int:
        """Peak resident elements excluding output buffers — what must fit
        next to a held activation when the outputs accumulate into that
        held map instead of draining through write-backs (the producer-side
        term of the network planner's reuse fit condition)."""
        return (self.spec.kernel_elements
                + self.peak_input_footprint() * self.spec.c_in)

    def first_load_duration(self, hw: HardwareModel) -> float:
        """t_l traffic of first-time input-pixel loads — the most an
        upstream on-chip activation can ever save this strategy."""
        covered = 0
        for g in self.groups:
            covered |= self.spec.group_mask(g)
        return covered.bit_count() * hw.t_l

    # -- full Def-3 accounting (network-level planning) ----------------- #
    def kernel_load_duration(self, hw: HardwareModel) -> float:
        """t_l cost of loading Λ once (K_sub of step 1, element units)."""
        return self.spec.kernel_elements * hw.t_l

    def write_back_duration(self, hw: HardwareModel) -> float:
        """t_w cost of writing every output column back (spatial units)."""
        return self.spec.num_patches * hw.t_w

    def full_duration(self, hw: HardwareModel) -> float:
        """Def-3 duration of the materialised ``to_steps()`` sequence:
        eq. 15 plus the kernel load and output write-back that the paper's
        Sec 5.4/7.1 experiments exclude.  Matches the Sec-6 simulator
        exactly (see tests/test_network_planner.py)."""
        return (self.objective(hw) + self.kernel_load_duration(hw)
                + self.write_back_duration(hw))


# ---------------------------------------------------------------------- #
# Group constructors
# ---------------------------------------------------------------------- #

def _chunks(order: Sequence[int], p: int) -> Groups:
    return [tuple(order[i:i + p]) for i in range(0, len(order), p)]


def row_by_row(spec: ConvSpec, p: int) -> GroupedStrategy:
    """Sec 7.2: group p patches sequentially, every row left->right."""
    order = list(range(spec.num_patches))           # row-major patch ids
    return GroupedStrategy("row_by_row", spec, tuple(_chunks(order, p)))


def zigzag(spec: ConvSpec, p: int) -> GroupedStrategy:
    """Sec 7.2: even rows left->right, odd rows right->left."""
    order: list[int] = []
    for i in range(spec.h_out):
        row = [spec.patch_id(i, j) for j in range(spec.w_out)]
        order.extend(row if i % 2 == 0 else row[::-1])
    return GroupedStrategy("zigzag", spec, tuple(_chunks(order, p)))


def s1_baseline(spec: ConvSpec) -> GroupedStrategy:
    """Def 12: one patch per step (order unspecified in [23]; row-major)."""
    order = list(range(spec.num_patches))
    return GroupedStrategy("s1_baseline", spec, tuple(_chunks(order, 1)))


def tiled(spec: ConvSpec, p: int,
          tile: tuple[int, int] | None = None) -> GroupedStrategy:
    """Beyond-paper: rectangular th x tw patch tiles (halo-minimizing).

    A fresh tile loads ``(th*s_h + h_k - s_h) * (tw*s_w + w_k - s_w)``
    pixels; square-ish tiles minimise the halo perimeter.  Tiles are visited
    in zigzag order over the tile grid so vertically/horizontally adjacent
    tiles share a halo.  If ``tile`` is None, all factor pairs with
    ``th*tw <= p`` are evaluated *exactly* (bitmask cost) and the best kept.
    """
    if tile is not None:
        cands = [tile]
    else:
        cands = [(th, tw) for th in range(1, p + 1)
                 for tw in range(1, p + 1) if th * tw <= p]
    best: GroupedStrategy | None = None
    for th, tw in cands:
        groups: Groups = []
        n_tile_rows = -(-spec.h_out // th)
        n_tile_cols = -(-spec.w_out // tw)
        for tr in range(n_tile_rows):
            cols = range(n_tile_cols)
            if tr % 2 == 1:
                cols = reversed(cols)
            for tc in cols:
                g = [spec.patch_id(i, j)
                     for i in range(tr * th, min((tr + 1) * th, spec.h_out))
                     for j in range(tc * tw, min((tc + 1) * tw, spec.w_out))]
                groups.append(tuple(g))
        cand = GroupedStrategy(f"tiled_{th}x{tw}", spec, tuple(groups))
        if best is None or cand.pixels_loaded() + cand.n_steps < \
                best.pixels_loaded() + best.n_steps:
            best = cand
    if best is None:
        raise ValueError(f"tiled: no tile shape admits p={p} patches")
    return best


def _hilbert_d2xy(order: int, d: int) -> tuple[int, int]:
    """Hilbert curve index -> (x, y) on a 2**order square grid."""
    rx = ry = 0
    x = y = 0
    t = d
    s = 1
    while s < (1 << order):
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        if ry == 0:
            if rx == 1:
                x, y = s - 1 - x, s - 1 - y
            x, y = y, x
        x += s * rx
        y += s * ry
        t //= 4
        s *= 2
    return x, y


def hilbert(spec: ConvSpec, p: int) -> GroupedStrategy:
    """Beyond-paper: patches ordered along a Hilbert space-filling curve."""
    side = max(spec.h_out, spec.w_out)
    order_bits = max(1, (side - 1).bit_length())
    n = 1 << order_bits
    order: list[int] = []
    for d in range(n * n):
        x, y = _hilbert_d2xy(order_bits, d)
        if y < spec.h_out and x < spec.w_out:
            order.append(spec.patch_id(y, x))
    return GroupedStrategy("hilbert", spec, tuple(_chunks(order, p)))


HEURISTICS: dict[str, Callable[[ConvSpec, int], GroupedStrategy]] = {
    "row_by_row": row_by_row,
    "zigzag": zigzag,
    "tiled": tiled,
    "hilbert": hilbert,
}


def best_heuristic(spec: ConvSpec, p: int, hw: HardwareModel,
                   names: Iterable[str] = ("row_by_row", "zigzag"),
                   ) -> GroupedStrategy:
    """Best of the named heuristics under eq. 15 (the paper's MIP start)."""
    cands = [HEURISTICS[n](spec, p) for n in names]
    return min(cands, key=lambda s: s.objective(hw))


def nb_patches_max_s1(spec: ConvSpec, hw: HardwareModel) -> int:
    return hw.nb_patches_max_s1(spec.nb_op_value, spec.c_out)


def k_min(spec: ConvSpec, p: int) -> int:
    """Def 14."""
    return -(-spec.num_patches // p)


def k_max(spec: ConvSpec) -> int:  # lint: public-api
    """Def 15."""
    return spec.num_patches


def lower_bound(spec: ConvSpec, p: int, hw: HardwareModel) -> float:
    """Analytic lower bound on eq. 15 (beyond-paper reporting):
    every needed pixel is loaded at least once and there are at least
    K_min steps."""
    return (hw.t_l * spec.all_pixels_mask.bit_count()
            + k_min(spec, p) * hw.t_acc)
