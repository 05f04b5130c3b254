"""Static kernel contract checker: the port's CUDA kernels vs their plans.

``repro_torch.analysis.verifier`` proves emitted *plans* legal; this
module proves that the **kernel** a plan is mapped onto
(``kernels.emit``) incurs exactly the traffic the plan priced, and that
its cluster of thread blocks is free of races.  Nothing is executed: the
checker walks each kernel's launches, blocks and steps symbolically with
the geometry helpers the plain versions and the CUDA sources share
(``step_fetch_box``, ``fetch_shares``, ``planned_smem_elements``,
``eff_tile``, ``grid_sequence``; ``launch_plan``, ``cluster_blocks``,
``block_steps``; ``decode_specs``), and holds the result against the
plan's Def-3 step sequence.

A CUDA grid does not run its steps in order on one core as a Pallas-TPU
grid does, so the traces here are not the JAX package's. The planned
conv kernel (K1) is a cluster of ``cs_n x cs_t`` blocks
(``conv_cluster_shape(N, t_run)``), each with eight compute warps and a
service warp: rank ``(g, u)`` writes channels group g's output columns
group u. Before the sweep every rank writes its share of Λ's group
columns into its group's ranks and its ``fetch_shares`` share of step
0's box into every rank's window, between two cluster barriers. From
step 1 on the service warp of rank r stores its share of the step's box
into its own ring slot and pushes it (a bulk copy between shared
memories) into the same slot of every peer, completing on the peer's
``full`` mbarrier, after the slot's ``empty`` mbarrier says every rank
has spliced the box the slot held before; the compute warps wait on
``full``, splice the box from their own slot into the window, arrive on
every rank's ``empty`` and run the product. The trace records, per step
and per rank, the share, where it lands, what the rank splices and which
output channels and columns it writes, and the cluster events (mbarrier
inits, arrivals, waits and pushes, the cluster barriers, exits) that
:func:`~repro_torch.analysis.access.cluster_hazard_scan` closes under
happens-before.

Rules (all ERROR severity; the rule names are the JAX package's):

    rule                what it proves
    ------------------  -------------------------------------------------
    kern/emit           the layer (or GeMM tiling) maps onto a kernel
    kern/step-islice    the union of the ranks' shares at step k is the
                        plan's I_slice_k, in every input channel
    kern/residency      every rank's replica receives the whole box, and
                        through the slot map (input row h, column w in
                        slot (h % H_K, w % t_in)) its window slots hold
                        M_k.inp where the product reads them
    kern/write-back     output blocks == the plan's groups, the ranks'
                        (channels x columns) blocks a disjoint cover of
                        each, every output written exactly once
    kern/traffic        the shares of each box are disjoint and cover it;
                        sum over ranks of shares + Λ columns == what the
                        plan charges to t_l (I_slices x C_in + Λ)
    kern/vmem           one block's shared memory (sums, ring, Λ share and
                        window) <= the budget the plan was solved under,
                        and every share fits its place in a ring slot
    kern/hazard         the cluster trace is free of unordered
                        RAW/WAR/WAW, peer reads after a peer's exit,
                        barrier misuse, hangs and leaked copies
    kern/coverage       K3/K4: tiles in bounds, each C tile accumulated
                        by one block at a time and summed over its k
                        tiles in k order; K5: the ranges a disjoint exact
                        cover of the cache, q resident within a range,
                        each partial written once and read by the combine

Run ``python -m repro_torch.analysis.kerncheck [--network N] [--json]``
(exit 1 on findings): plans every registered network with the emitable
solver at a 2x-Λ budget and proves every conv layer, then checks the
standalone GeMM and decode-attention schedules and the planner's at
TinyLlama-1.1B's shapes.  The simple conv kernel (K2) stays out: its
contract does not claim the plan's traffic.  The check functions take the
extracted traces as *data*, so tests seed mutations into a trace and
assert that the precise rule fires.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Sequence

import torch

from repro_torch.analysis import access
from repro_torch.analysis.access import Agent, Cells
from repro_torch.analysis.diagnostics import (
    Diagnostic, Severity, VerificationReport)
from repro_torch.configs.networks import NETWORKS
from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.planner import (DECODE_MAX_G, conv_cluster_shape,
                                      gemm_cluster_size, matmul_wg_stages,
                                      plan_decode_split, plan_matmul)
from repro_torch.core.strategies import GroupedStrategy
from repro_torch.kernels import KernelShapeError
from repro_torch.kernels.block_matmul import (block_steps, cluster_blocks,
                                              core_of, kernel_limits,
                                              launch_plan, matmul_grid)
from repro_torch.kernels.conv2d_offload import (
    _planned_flags, eff_tile, fetch_shares, grid_sequence, planned_layout,
    step_fetch_box, t_in_cols)
from repro_torch.kernels.emit import (
    EmittedConv, KernelEmitError, emit_layer_kernel, plan_emitable_network)
from repro_torch.kernels.flash_decode import decode_specs

# Big enough that nb_patches_max_S1 (Sec 4.2) admits 16-patch groups on
# the deepest registered layer (64ch 3x3 -> 64ch: 36864 MACs/patch); the
# memory budget, not compute, is what kerncheck stresses.
_DEFAULT_NBOP = 1 << 20
_DEFAULT_BUDGET_FACTOR = 2.0


# --------------------------------------------------------------------- #
# K1 trace extraction (symbolic walk of the cluster — no kernel run)
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class StepTrace:
    """One step of the planned conv kernel's sweep, over its cluster."""

    index: int
    case: str                           # step_case: full / row / col delta
    x_load: access.Region               # the step's box of x, all channels
    shares: tuple[tuple[int, int], ...]  # rank r's [lo, hi) of the box
    dst: str                            # "window" (step 0) or "slot<d>"
    # rank r's window: the (owner, lo, hi) shares spliced into it
    assembled: tuple[tuple[tuple[int, int, int], ...], ...]
    row_slots: tuple[int, ...]          # window slot row of each box row
    col_slots: tuple[int, ...]          # window slot col of each box col
    window: access.Region               # M_k.inp: the box the product reads
    read_rows: tuple[int, ...]          # slot row of each window row
    read_cols: tuple[int, ...]          # slot col of each window col
    out: access.Region                  # output block, all channels
    channels: tuple[tuple[int, int], ...]  # rank r's output channels
    columns: tuple[tuple[int, int], ...]   # rank r's output columns
    lam_elements: tuple[int, ...]       # Λ elements rank r fetches here


@dataclasses.dataclass
class KernelTrace:
    """Everything the checker extracts from one kernel instantiation."""

    name: str
    spec: ConvSpec
    t_run: int
    order: str
    dtype: str
    cs: int
    vmem_elements: int                  # one block's shared memory
    staging_elements: int               # a share's place in a ring slot
    steps: list[StepTrace]
    events: list
    cluster: tuple[int, int] = (1, 1)   # (cs_n, cs_t)

    @property
    def fetched_elements(self) -> int:
        """Elements the cluster fetches from device memory: every rank's
        shares and its Λ share, what K1's blocks add to
        ``fetched_counter``."""
        return sum(hi - lo for st in self.steps for lo, hi in st.shares) \
            + sum(sum(st.lam_elements) for st in self.steps)


def _segments(lo: int, hi: int, rows: int, cols: int):
    """Elements ``[lo, hi)`` of a ``(C, rows, cols)`` box flattened, as
    ``(c, r, a, b)`` runs of columns ``[a, b)`` of box row ``r`` of
    channel ``c``."""
    e = lo
    while e < hi:
        c, rem = divmod(e, rows * cols)
        r, a = divmod(rem, cols)
        b = min(cols, a + hi - e)
        yield c, r, a, b
        e += b - a


def _run_mask(start: int, length: int) -> int:
    return ((1 << length) - 1) << start


def _slot_mask(lo: int, hi: int, rows: int, cols: int,
               row_slots: Sequence[int], col_slots: Sequence[int],
               h_k: int, t_in: int) -> int:
    """Window slots (flat ``(c * H_K + slot_row) * t_in + slot_col``)
    where elements ``[lo, hi)`` of a box land; a box's columns are
    consecutive modulo t_in, so a run wraps at most once."""
    m = 0
    for c, r, a, b in _segments(lo, hi, rows, cols):
        base = (c * h_k + row_slots[r]) * t_in
        s0 = col_slots[a]
        first = min(b - a, t_in - s0)
        m |= _run_mask(base + s0, first)
        if first < b - a:
            m |= _run_mask(base, b - a - first)
    return m


def _x_mask(spec: ConvSpec, lo: int, hi: int, box: access.Region) -> int:
    """Elements of x (flat ``(c * H_in + h) * W_in + w``) that elements
    ``[lo, hi)`` of a box of x are."""
    (_, _), (h0, h1), (w0, w1) = box.box
    m = 0
    for c, r, a, b in _segments(lo, hi, h1 - h0, w1 - w0):
        m |= _run_mask((c * spec.h_in + h0 + r) * spec.w_in + w0 + a, b - a)
    return m


def build_conv_trace(emitted: EmittedConv,
                     dtype: str = "float32") -> KernelTrace:
    """Walk ``conv2d_offload_planned``'s cluster over an emitted layer.

    Mirrors the CUDA kernel: rank r's compute warps set up its mbarriers
    (``full`` of each ring slot: the service warp's arrival, expecting the
    peers' bytes; ``empty``: one arrival from each rank), the cluster
    meets, the compute warps write their share of Λ's group columns into
    the group's ranks and their share of step 0's box into every rank's
    window (into their own block first, then from there to the peers),
    the cluster meets again. For step s >= 1 (ring index j = s -
    1, slot j % depth) the service warp waits on the slot's ``empty`` for
    step s - depth, stores its share into its own slot, pushes it from
    there into every peer's slot (a bulk copy of whole 16 bytes) and
    arrives on its own ``full``; the compute warps wait on ``full``, read
    the slot, write the window, arrive on every rank's ``empty`` and run
    the product; a last cluster barrier precedes exit. The service warp's
    32 lanes arrive as one agent here (the barrier counts them as one
    arrival).
    """
    return _conv_trace(emitted.spec, emitted.t_run, emitted.order,
                       name=f"conv2d_offload_planned[L{emitted.layer_index}]",
                       vmem_elements=emitted.vmem_elements, dtype=dtype)


def _conv_trace(spec: ConvSpec, t: int, order: str, *, name: str,
                vmem_elements: int, dtype: str) -> KernelTrace:
    c, hk, wk = spec.c_in, spec.h_k, spec.w_k
    sh, sw, n = spec.s_h, spec.s_w, spec.c_out
    tiles = spec.w_out // t
    t_in = t_in_cols(t, sw, wk)
    zig = order == "zigzag"
    row_delta, _ = _planned_flags(hk, wk, sh, sw, t, tiles, order)
    lay = planned_layout(c, n, hk, wk, sh, sw, t, row_delta=row_delta)
    cs_n, cs_t, cs = lay.cs_n, lay.cs_t, lay.cs
    nr, ts, cap, depth = n // cs_n, t // cs_t, lay.share, lay.depth
    lam_shares = fetch_shares(lay.lam, cs_t)
    size = 4 if dtype == "float32" else 2     # an element's bytes
    geom = dict(t_run=t, s_h=sh, s_w=sw, h_k=hk, w_k=wk,
                w_out_tiles=tiles, order=order)
    seq = grid_sequence(spec.h_out, tiles)
    n_steps = len(seq)
    out_plane = spec.h_out * spec.w_out

    steps: list[StepTrace] = []
    for k, (i, jt_raw) in enumerate(seq):
        case, h0, h1, w0, w1 = step_fetch_box(i, jt_raw, **geom)
        elems = c * (h1 - h0) * (w1 - w0)
        shares = tuple(fetch_shares(elems, cs))
        tile = eff_tile(i, jt_raw, tiles, zig)
        wh, ww = i * sh, tile * t * sw
        steps.append(StepTrace(
            index=k, case=case,
            x_load=access.box_region("x", (0, c), (h0, h1), (w0, w1)),
            shares=shares,
            dst="window" if k == 0 else f"slot{(k - 1) % depth}",
            assembled=tuple(tuple((q, lo, hi)
                                  for q, (lo, hi) in enumerate(shares))
                            for _ in range(cs)),
            row_slots=tuple(h % hk for h in range(h0, h1)),
            col_slots=tuple(w % t_in for w in range(w0, w1)),
            window=access.box_region("x", (0, c), (wh, wh + hk),
                                     (ww, ww + t_in)),
            read_rows=tuple((wh + r) % hk for r in range(hk)),
            read_cols=tuple((ww + u) % t_in for u in range(t_in)),
            out=access.box_region("out", (0, n), (i, i + 1),
                                  (tile * t, tile * t + t)),
            channels=tuple(((r // cs_t) * nr, (r // cs_t + 1) * nr)
                           for r in range(cs)),
            columns=tuple((tile * t + (r % cs_t) * ts,
                           tile * t + (r % cs_t + 1) * ts)
                          for r in range(cs)),
            lam_elements=tuple(
                (lam_shares[r % cs_t][1] - lam_shares[r % cs_t][0])
                if k == 0 else 0 for r in range(cs))))

    # ---- cluster events ------------------------------------------------
    def box_slots(st: StepTrace, lo: int, hi: int) -> int:
        (_, _), (h0, h1), (w0, w1) = st.x_load.box
        return _slot_mask(lo, hi, h1 - h0, w1 - w0, st.row_slots,
                          st.col_slots, hk, t_in)

    def out_cells(st: StepTrace, r: int) -> Cells:
        (_, _), (i, _), _ = st.out.box
        lo, hi = st.channels[r]
        j0, j1 = st.columns[r]
        m = 0
        for ch in range(lo, hi):
            m |= _run_mask(ch * out_plane + i * spec.w_out + j0, j1 - j0)
        return Cells("out", None, m)

    def pushed(lo: int, hi: int) -> int:
        """Bytes a bulk copy of elements ``[lo, hi)`` moves: whole 16."""
        return -(-(hi - lo) * size // 16) * 16

    def share_cells(space: str, owner: int, q: int, lo: int, hi: int,
                    copied: bool) -> Cells:
        """Share q, ``[lo, hi)`` of the box, at its place in a slot (with
        ``copied``, and the rest of the 16 bytes a bulk copy writes)."""
        n = pushed(lo, hi) // size if copied else hi - lo
        return access.span_cells(space, owner, q * cap, q * cap + n)

    def full(q: int, d: int) -> access.Mbar:
        return access.Mbar(q, f"full{d}")

    def empty(q: int, d: int) -> access.Mbar:
        return access.Mbar(q, f"empty{d}")

    lam_cells = access.span_cells
    whole_win = _run_mask(0, lay.window)
    events: list = []
    for r in range(cs):                                 # before the sweep
        comp, serv = Agent(r, "compute"), Agent(r, "service")
        for d in range(depth):
            events += [access.MbarInit(comp, full(r, d), 1, 0),
                       access.MbarInit(comp, empty(r, d), cs, 0)]
        for role in (comp, serv):
            events += [access.ClusterArrive(role, 0, tag="start"),
                       access.ClusterWait(role, 0, tag="start")]
        # the rank's shares into its own block, then from there to peers
        g, u = divmod(r, cs_t)
        lo, hi = lam_shares[u]
        first = box_slots(steps[0], *steps[0].shares[r])
        events += [access.Write(comp, lam_cells("lam", r, lo, hi), 0,
                                "Λ share"),
                   access.Write(comp, Cells("win", r, first), 0,
                                "first share"),
                   access.Read(comp, lam_cells("lam", r, lo, hi), 0,
                               "Λ share"),
                   access.Read(comp, Cells("win", r, first), 0,
                               "first share")]
        events += [access.Write(comp, lam_cells("lam", q, lo, hi), 0,
                                "Λ share")
                   for q in range(g * cs_t, (g + 1) * cs_t) if q != r]
        events += [access.Write(comp, Cells("win", q, first), 0,
                                "first share") for q in range(cs) if q != r]
        for role in (comp, serv):
            events += [access.ClusterArrive(role, 0, tag="publish"),
                       access.ClusterWait(role, 0, tag="publish")]
    for r in range(cs):
        comp, serv = Agent(r, "compute"), Agent(r, "service")
        for s, st in enumerate(steps):
            if s == 0:
                events.append(access.Read(
                    comp, lam_cells("lam", r, 0, lay.lam), s,
                    "Λ rows kept in registers"))
            else:
                j = s - 1
                d, use = j % depth, j // depth
                slot = f"slot{d}"
                lo, hi = st.shares[r]
                if j >= depth:
                    events.append(access.MbarWait(serv, empty(r, d), use - 1,
                                                  s, tag="empty"))
                own = share_cells(slot, r, r, lo, hi, False)
                expect = sum(pushed(qlo, qhi)
                             for q, (qlo, qhi) in enumerate(st.shares)
                             if q != r)
                events += [access.Write(serv, own, s, "own share"),
                           access.Read(serv, own, s, "bulk copy source")]
                for q in range(cs):
                    if q != r and hi > lo:
                        events.append(access.Push(
                            serv, share_cells(slot, q, r, lo, hi, True),
                            full(q, d), use, s, pushed(lo, hi), "share"))
                events.append(access.MbarArrive(serv, full(r, d), use, s,
                                                tx=expect, tag="full"))
                events.append(access.MbarWait(comp, full(r, d), use, s,
                                              tag="full"))
                spliced = 0
                for q, qlo, qhi in st.assembled[r]:
                    events.append(access.Read(
                        comp, share_cells(slot, r, q, qlo, qhi, False), s,
                        "splice"))
                    spliced |= box_slots(st, qlo, qhi)
                events.append(access.Write(comp, Cells("win", r, spliced), s,
                                           "splice"))
                for q in range(cs):
                    events.append(access.MbarArrive(comp, empty(q, d), use,
                                                    s, tag="empty"))
            events += [
                access.Read(comp, Cells("win", r, whole_win), s, "product"),
                access.Read(comp, lam_cells("lam", r, 0, lay.lam), s,
                            "product"),
                access.Write(comp, out_cells(st, r), s, "output block")]
    for r in range(cs):                                 # before exit
        for role in ("compute", "service"):
            events += [access.ClusterArrive(Agent(r, role), n_steps,
                                            tag="exit"),
                       access.ClusterWait(Agent(r, role), n_steps,
                                          tag="exit"),
                       access.BlockExit(Agent(r, role), n_steps)]
    return KernelTrace(name=name, spec=spec, t_run=t, order=order,
                       dtype=dtype, cs=cs, vmem_elements=vmem_elements,
                       staging_elements=cap, steps=steps, events=events,
                       cluster=(cs_n, cs_t))


# --------------------------------------------------------------------- #
# K1 contract rules (pure functions of the trace — tests mutate it)
# --------------------------------------------------------------------- #

def _box_pixmask(spec: ConvSpec, region: access.Region) -> int:
    """Spatial-pixel bitmask of an input-region box (channel axis
    dropped — the plan ledger is in spatial units)."""
    (_, _), (r0, r1), (c0, c1) = region.box
    m = 0
    for h in range(r0, min(r1, spec.h_in)):
        m |= ((1 << (c1 - c0)) - 1) << (h * spec.w_in + c0)
    return m


def _out_patchmask(spec: ConvSpec, region: access.Region) -> int:
    """Patch bitmask of an output-block box."""
    (_, _), (r0, r1), (c0, c1) = region.box
    m = 0
    for i in range(r0, r1):
        for j in range(c0, c1):
            m |= 1 << spec.patch_id(i, j)
    return m


def _in_all_channels(spec: ConvSpec, pixmask: int) -> int:
    """A spatial-pixel mask repeated over every input channel of x."""
    plane = spec.h_in * spec.w_in
    m = 0
    for c in range(spec.c_in):
        m |= pixmask << (c * plane)
    return m


def _disjoint_cover(ranges, lo: int, hi: int) -> bool:
    """Whether half-open ``ranges`` are disjoint and cover ``[lo, hi)``."""
    at = lo
    for a, b in sorted(ranges):
        if a != at or b < a:
            return False
        at = b
    return at == hi


def check_conv_trace(trace: KernelTrace, strategy: GroupedStrategy,
                     budget: int | None, *,
                     layer: int | None = None) -> list[Diagnostic]:
    """All contract rules for one K1 trace vs its plan."""
    spec = trace.spec
    diags: list[Diagnostic] = []

    def err(rule: str, msg: str, *, step: int | None = None,
            **data) -> None:
        diags.append(Diagnostic.make(rule, Severity.ERROR, msg,
                                     layer=layer, step=step, **data))

    plan_steps = strategy.to_steps()[:-1]       # drop the terminal flush
    if len(trace.steps) != len(plan_steps):
        err("kern/step-islice",
            f"kernel has {len(trace.steps)} steps but the plan has "
            f"{len(plan_steps)} compute steps",
            kernel_steps=len(trace.steps), plan_steps=len(plan_steps))
        return diags

    total = 0
    write_counts: dict[int, int] = {}
    slots: dict[tuple[int, int], tuple[int, int]] = {}
    t_in = len(trace.steps[0].read_cols)
    for st, ps in zip(trace.steps, plan_steps):
        (_, _), (h0, h1), (w0, w1) = st.x_load.box
        elems = spec.c_in * (h1 - h0) * (w1 - w0)
        # kern/traffic: the shares cut the box exactly
        if len(st.shares) != trace.cs or not _disjoint_cover(
                st.shares, 0, elems):
            err("kern/traffic",
                f"the {len(st.shares)} ranks' shares {list(st.shares)} are "
                f"not a disjoint cover of the box's {elems} elements",
                step=st.index, box=elems)
        # kern/step-islice: their union is I_slice_k in every channel
        got = 0
        for lo, hi in st.shares:
            got |= _x_mask(spec, lo, hi, st.x_load)
        want = _in_all_channels(spec, ps.i_slice)
        if got != want:
            err("kern/step-islice",
                f"shares of {st.x_load.describe()} fetch "
                f"{got.bit_count()} elements, the plan's I_slice is "
                f"{want.bit_count()} ({(got ^ want).bit_count()} differ)",
                step=st.index, fetched=got.bit_count(),
                islice=want.bit_count())
        # kern/residency: every replica is whole, and the slots hold M_k
        for r, parts in enumerate(st.assembled):
            if not _disjoint_cover([(lo, hi) for _, lo, hi in parts],
                                   0, elems):
                err("kern/residency",
                    f"rank {r} splices {[tuple(p) for p in parts]}, not "
                    f"the box's {elems} elements once each",
                    step=st.index, rank=r)
        for r_i, row in enumerate(st.row_slots):
            for c_i, col in enumerate(st.col_slots):
                slots[(row, col)] = (h0 + r_i, w0 + c_i)
        need = spec.group_mask(ps.group)
        win = _box_pixmask(spec, st.window)
        if win != need:
            err("kern/residency",
                f"window {st.window.describe()} != M_k.inp (plan holds "
                f"{need.bit_count()} pixels, kernel {win.bit_count()})",
                step=st.index)
        (_, _), (wh, _), (ww, _) = st.window.box
        wrong = sum(
            slots.get((row, col)) != (wh + a, ww + b)
            for a, row in enumerate(st.read_rows)
            for b, col in enumerate(st.read_cols))
        if wrong:
            err("kern/residency",
                f"{wrong} of the window's {len(st.read_rows) * t_in} "
                f"slots the product reads do not hold the input pixel it "
                f"reads them as", step=st.index, wrong_slots=wrong)
        # kern/write-back: the block is the plan's group, the channels cut
        out_got = _out_patchmask(spec, st.out)
        if out_got != ps.out:
            err("kern/write-back",
                f"output block {st.out.describe()} != plan group (block "
                f"covers {out_got.bit_count()} patches, group has "
                f"{ps.out.bit_count()})", step=st.index)
        (_, _), _, (j0, j1) = st.out.box
        blocks = {}
        for r, (ch, col) in enumerate(zip(st.channels, st.columns)):
            blocks.setdefault(ch, []).append(col)
        if len(st.channels) != trace.cs or not _disjoint_cover(
                blocks, 0, spec.c_out) or any(
                not _disjoint_cover(cols, j0, j1) for cols in
                blocks.values()):
            err("kern/write-back",
                f"ranks' output channels {list(st.channels)} and columns "
                f"{list(st.columns)} are not a disjoint cover of the "
                f"{spec.c_out} channels x columns [{j0}, {j1})",
                step=st.index)
        for pid in spec.pixels_of_mask(out_got):
            write_counts[pid] = write_counts.get(pid, 0) + 1
        # kern/vmem: a share fits its place in a ring slot
        if st.dst != "window":
            big = max(hi - lo for lo, hi in st.shares)
            if big > trace.staging_elements:
                err("kern/vmem",
                    f"a share of {big} elements does not fit its place of "
                    f"{trace.staging_elements} in a ring slot",
                    step=st.index, share=big,
                    staging=trace.staging_elements)
        total += sum(hi - lo for lo, hi in st.shares) + sum(st.lam_elements)

    bad = {p: k for p, k in write_counts.items() if k != 1}
    missing = spec.num_patches - len(write_counts)
    if bad or missing:
        err("kern/write-back",
            f"output not covered write-once: {missing} patches never "
            f"written, {len(bad)} written more than once",
            missing=missing, multi=len(bad))

    want_traffic = (strategy.pixels_loaded() * spec.c_in
                    + spec.kernel_elements)
    if total != want_traffic:
        err("kern/traffic",
            f"the cluster fetches {total} elements but the plan charges "
            f"{want_traffic} to t_l — predicted duration would lie",
            loaded=total, charged=want_traffic)

    if budget is not None and trace.vmem_elements > budget:
        err("kern/vmem",
            f"a block occupies {trace.vmem_elements} shared-memory "
            f"elements; the plan was solved under size_mem={budget}",
            occupancy=trace.vmem_elements, budget=budget)

    for hz in access.cluster_hazard_scan(trace.events):
        err("kern/hazard", hz.describe(), step=hz.step, kind=hz.kind)
    return diags


# --------------------------------------------------------------------- #
# K3/K4: the block GeMM's launches, blocks and steps
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class GemmVisit:
    """One step of one block: its tiles of A, B and C, by index."""

    launch: int
    block: int                    # index of the block in its launch
    rank: int
    a: tuple[int, int]
    b: tuple[int, int]
    c: tuple[int, int]


@dataclasses.dataclass
class GemmTrace:
    m: int
    n: int
    k: int
    bm: int
    bn: int
    bk: int
    order: str
    cs: int
    visits: list[GemmVisit]       # each block's steps in its walk order
    clusters: list[list]          # one cluster's trace per launch
    core: str                     # block_matmul.core_of at these tiles


def gemm_walk(m: int, n: int, k: int, *, bm: int, bn: int, bk: int,
              order: str, dtype: torch.dtype = torch.bfloat16) -> GemmTrace:
    """The block GeMM's schedule as the wrapper launches it: for each
    launch of ``launch_plan`` in stream order, each block of
    ``cluster_blocks`` and its ``block_steps``, with the tile indices
    ``matmul_grid``'s maps give.  It also builds, per launch, the trace
    of the launch's first cluster (every cluster of a launch runs the
    same program) on the core ``block_matmul.core_of`` picks for these
    tiles and ``dtype``:

    * ``wgmma`` (bf16, bm 64 or 128; K3 and K4): each rank has a ring of
      ``planner.matmul_wg_stages`` slots per operand
      (:func:`_wgmma_cluster_events`), filled by a producer through TMA
      boxes that complete on the slot's ``full`` mbarrier and freed by
      the consumer warpgroups' arrivals on its ``empty`` one; in a K4
      cluster rank 0 alone fetches the resident tile, waits on ``ready``
      for every peer's slot to be free, and pushes the tile into each
      peer's slot, completing on the peer's ``full``;
    * ``mma.sync`` and ``fma`` (K4 clusters only): at every change of the
      resident index the cluster syncs, rank 0 fetches the tile, the
      cluster syncs again and the peers copy it from rank 0's shared
      memory (:func:`_k4_cluster_events`).

    Every rank syncs with the cluster before it exits."""
    grid, amap, bmap, cmap, _ = matmul_grid(m, n, k, bm=bm, bn=bn, bk=bk,
                                            order=order)
    trips = dict(zip(order, grid))
    cs = gemm_cluster_size(order, trips)
    core = core_of(bm, bn, bk, dtype)
    resident = {"n": "a", "m": "b"}[order[2]] if cs > 1 else None
    stages = matmul_wg_stages(bm, bn, bk, order[2] != "k")
    visits: list[GemmVisit] = []
    clusters: list[list] = []
    for li, (grid_dims, k_lo, k_cnt) in enumerate(launch_plan(order, trips)):
        per_rank: dict[int, list[tuple[int, int]]] = {}
        steps_of: dict[int, list[tuple[int, int, int]]] = {}
        for bi, (rank, lo, cnt, step) in enumerate(
                cluster_blocks(order, trips, grid_dims, cs)):
            lo["k"], cnt["k"] = k_lo, k_cnt
            held = None
            for mm, nn, kk in block_steps(order, lo, cnt, step):
                ids = tuple({"m": mm, "n": nn, "k": kk}[d] for d in order)
                visits.append(GemmVisit(li, bi, rank, amap(*ids),
                                        bmap(*ids), cmap(*ids)))
                if bi >= cs:
                    continue
                steps_of.setdefault(rank, []).append((mm, nn, kk))
                tile = (mm, kk) if resident == "a" else (kk, nn)
                if resident and tile != held:
                    held = tile
                    per_rank.setdefault(rank, []).append(tile)
        if core == "wgmma":
            clusters.append(_wgmma_cluster_events(
                steps_of, cs, bm=bm, bn=bn, bk=bk, stages=stages,
                resident=resident))
        elif resident:
            clusters.append(_k4_cluster_events(
                per_rank, cs, bm * bk if resident == "a" else bk * bn))
    return GemmTrace(m, n, k, bm, bn, bk, order, cs, visits, clusters, core)


def _k4_cluster_events(per_rank: dict[int, list[tuple[int, int]]], cs: int,
                       tile_elems: int) -> list:
    """The resident tile's trace of one K4 cluster on the mma.sync and
    fma cores (see :func:`gemm_walk`), each rank one agent."""
    events: list = []
    tile = access.span_cells

    def sync(agent: Agent, step: int, tag: str) -> list:
        return [access.ClusterArrive(agent, step, release=True, tag=tag),
                access.ClusterWait(agent, step, tag=tag)]

    for rank in range(cs):
        me = Agent(rank)
        space = "resident"
        for s, _ in enumerate(per_rank.get(rank, [])):
            events += sync(me, s, "swap")
            if rank == 0:
                events += [access.Copy(me, tile(space, me.rank, 0,
                                                tile_elems), s,
                                       "resident tile"),
                           access.CopyCommit(me, s)]
            events.append(access.CopyWait(me, s))
            events += sync(me, s, "visible")
            if rank:
                events += [
                    access.Read(me, tile(space, 0, 0, tile_elems), s,
                                "rank 0's tile"),
                    access.Write(me, tile(space, me.rank, 0, tile_elems),
                                 s, "own copy")]
            events.append(access.Read(me, tile(space, me.rank, 0,
                                               tile_elems), s, "product"))
        events += sync(me, len(per_rank.get(rank, [])), "exit")
        events.append(access.BlockExit(me, len(per_rank.get(rank, []))))
    return events


def _atom_width(extent: int) -> int:
    """Elements of one swizzled row of a wgmma tile, the widest of 64, 32
    and 16 bf16 that divides the tile's contiguous extent (``atom_width``
    of ``csrc/block_matmul.cu``): a TMA box is that wide."""
    return 64 if extent % 64 == 0 else 32 if extent % 32 == 0 else 16


def _wgmma_cluster_events(steps_of: dict[int, list[tuple[int, int, int]]],
                          cs: int, *, bm: int, bn: int, bk: int,
                          stages: int, resident: str | None) -> list:
    """The trace of one cluster of the wgmma core (``wg_walk`` of
    ``csrc/block_matmul.cu``), from each rank's ``(m, n, k)`` steps.

    Each rank is a producer (one thread of the last warp) and ``bm / 64``
    consumer warpgroups.  Consumer 0 initialises, per operand and slot, a
    ``full`` barrier (one arrival, the producer's, expecting the slot's
    bytes), an ``empty`` one (an arrival per warpgroup, plus one per peer
    on rank 0 for the resident operand) and a ``ready`` one (the peers'
    arrivals on rank 0); the cluster syncs.  Tile i of an operand (a new
    tile each time its index changes) takes slot ``i % stages`` in use
    ``i // stages``.  The producer waits on the slot's ``empty`` for the
    use before, arrives on ``full`` expecting ``slot_bytes`` and starts
    the TMA boxes, which complete on ``full``.  For the resident operand
    of a K4 cluster a peer's producer only arms its own ``full`` and
    arrives on rank 0's ``ready``; rank 0's waits ``ready`` (every peer's
    slot free), fetches, waits its own ``full`` and pushes the slot into
    each peer's, completing on that peer's ``full``.  The consumers wait
    on ``full``; a peer's consumer 0 then arrives on rank 0's ``empty``
    (the push has read rank 0's slot, traced as that consumer's read of
    it); every consumer reads both slots for the product and arrives on
    a slot's ``empty`` once the next step holds another tile.  The
    cluster syncs before exit.  Cells are the slots' 16-byte units."""
    nwg = bm // 64
    wa, wb = _atom_width(bk), _atom_width(bn)
    rows = min(bk, 256)
    slot_bytes = {"a": bm * bk * 2, "b": bk * bn * 2}
    boxes = {"a": [(j * bm * wa * 2, bm * wa * 2) for j in range(bk // wa)],
             "b": [((jn * bk + jk * rows) * wb * 2, rows * wb * 2)
                   for jn in range(bn // wb) for jk in range(bk // rows)]}

    def bar(kind: str, op: str, owner: int, i: int) -> access.Mbar:
        return access.Mbar(owner, f"{op.upper()} {kind}{i % stages}")

    def slot(op: str, owner: int, i: int, lo: int = 0,
             size: int | None = None) -> Cells:
        size = slot_bytes[op] if size is None else size
        return access.span_cells(f"{op.upper()} slot{i % stages}", owner,
                                 lo // 16, (lo + size) // 16)

    def tiles(steps: list[tuple[int, int, int]], op: str) -> list[bool]:
        """Whether each step holds a new tile of ``op``."""
        key = (lambda t: (t[0], t[2])) if op == "a" else (
            lambda t: (t[2], t[1]))
        return [s == 0 or key(steps[s]) != key(steps[s - 1])
                for s in range(len(steps))]

    events: list = []
    for r in range(cs):
        prod = Agent(r, "producer")
        cons = [Agent(r, f"consumer{g}") for g in range(nwg)]
        for op in "ab":
            extra = cs - 1 if op == resident and r == 0 else 0
            for d in range(stages):
                events += [
                    access.MbarInit(cons[0], bar("full", op, r, d), 1, 0),
                    access.MbarInit(cons[0], bar("empty", op, r, d),
                                    nwg + extra, 0),
                    access.MbarInit(cons[0], bar("ready", op, r, d),
                                    cs - 1 if cs > 1 else 1, 0)]
        for ag in (prod, *cons):
            events += [access.ClusterArrive(ag, 0, tag="start"),
                       access.ClusterWait(ag, 0, tag="start")]

    for r in range(cs):
        prod = Agent(r, "producer")
        cons = [Agent(r, f"consumer{g}") for g in range(nwg)]
        steps = steps_of.get(r, [])
        new = {op: tiles(steps, op) for op in "ab"}
        count = {"a": -1, "b": -1}
        for s in range(len(steps)):                     # the producer
            for op in "ab":
                if not new[op][s]:
                    continue
                count[op] += 1
                i = count[op]
                use = i // stages
                full = bar("full", op, r, i)
                if use:
                    events.append(access.MbarWait(
                        prod, bar("empty", op, r, i), use - 1, s,
                        tag="empty"))
                if op == resident and r:
                    events += [
                        access.MbarArrive(prod, full, use, s,
                                          tx=slot_bytes[op], tag="expect"),
                        access.MbarArrive(prod, bar("ready", op, 0, i),
                                          use, s, tag="ready")]
                    continue
                if op == resident:
                    events.append(access.MbarWait(
                        prod, bar("ready", op, 0, i), use, s, tag="ready"))
                events.append(access.MbarArrive(
                    prod, full, use, s, tx=slot_bytes[op], tag="expect"))
                events += [access.Push(prod, slot(op, r, i, lo, size), full,
                                       use, s, size, "TMA box")
                           for lo, size in boxes[op]]
                if op == resident:
                    events.append(access.MbarWait(prod, full, use, s,
                                                  tag="full"))
                    events += [access.Push(
                        prod, slot(op, q, i), bar("full", op, q, i), use, s,
                        slot_bytes[op], f"push to rank {q}")
                        for q in range(1, cs)]
        for g, con in enumerate(cons):                  # the consumers
            held = {"a": -1, "b": -1}
            for s in range(len(steps)):
                for op in "ab":
                    if not new[op][s]:
                        continue
                    held[op] += 1
                    i = held[op]
                    use = i // stages
                    events.append(access.MbarWait(
                        con, bar("full", op, r, i), use, s, tag="full"))
                    if op == resident and r and g == 0:
                        events += [
                            access.Read(con, slot(op, 0, i), s,
                                        "push source"),
                            access.MbarArrive(con, bar("empty", op, 0, i),
                                              use, s, tag="landed")]
                events += [access.Read(con, slot(op, r, held[op]), s,
                                       "product") for op in "ab"]
                for op in "ab":
                    if s + 1 == len(steps) or new[op][s + 1]:
                        events.append(access.MbarArrive(
                            con, bar("empty", op, r, held[op]),
                            held[op] // stages, s, tag="empty"))
    for r in range(cs):                                 # before exit
        n_steps = len(steps_of.get(r, []))
        for ag in (Agent(r, "producer"),
                   *(Agent(r, f"consumer{g}") for g in range(nwg))):
            events += [access.ClusterArrive(ag, n_steps, tag="exit"),
                       access.ClusterWait(ag, n_steps, tag="exit"),
                       access.BlockExit(ag, n_steps)]
    return events


def check_gemm_trace(trace: GemmTrace) -> list[Diagnostic]:
    """Coverage and ordering rules of one block GeMM schedule."""
    diags: list[Diagnostic] = []

    def err(rule: str, msg: str, *, step: int | None = None,
            **data) -> None:
        diags.append(Diagnostic.make(rule, Severity.ERROR, msg,
                                     step=step, **data))

    m_t, n_t, k_t = (trace.m // trace.bm, trace.n // trace.bn,
                     trace.k // trace.bk)
    owner: dict[tuple[int, tuple[int, int]], int] = {}
    ks: dict[tuple[int, int], list[int]] = {}
    runs: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
    for step, v in enumerate(trace.visits):
        (ai, ak), (bkk, bj), ct = v.a, v.b, v.c
        if not (0 <= ai < m_t and 0 <= ak < k_t):
            err("kern/coverage", f"A tile {v.a} out of bounds", step=step)
        if not (0 <= bkk < k_t and 0 <= bj < n_t):
            err("kern/coverage", f"B tile {v.b} out of bounds", step=step)
        if ak != bkk:
            err("kern/coverage",
                f"A reads k tile {ak} but B reads {bkk} — the product "
                f"contracts mismatched tiles", step=step)
        if ct != (ai, bj):
            err("kern/coverage",
                f"C tile {ct} is not the product of A row {ai} and B "
                f"column {bj}", step=step)
        first = owner.setdefault((v.launch, ct), v.block)
        if first != v.block:
            err("kern/coverage",
                f"C tile {ct} accumulated by blocks {first} and {v.block} "
                f"of launch {v.launch} at once", step=step,
                launch=v.launch)
        ks.setdefault(ct, []).append(ak)
        runs.setdefault(ct, []).append((v.launch, v.block, step))

    want_tiles = m_t * n_t
    if len(ks) != want_tiles:
        err("kern/coverage",
            f"C coverage: {len(ks)} tiles accumulated, the product has "
            f"{want_tiles}", visited=len(ks), tiles=want_tiles)
    for ct, seq in ks.items():
        if seq != list(range(k_t)):
            err("kern/coverage",
                f"C tile {ct} sums k tiles {seq[:8]}{'...' * (len(seq) > 8)}"
                f", not 0..{k_t - 1} once each in k order")
        if trace.order[2] == "k":
            who = {(li, bi) for li, bi, _ in runs[ct]}
            at = [s for _, _, s in runs[ct]]
            if len(who) != 1 or at != list(range(at[0], at[0] + len(at))):
                err("kern/coverage",
                    f"C tile {ct} leaves the output-stationary block and "
                    f"returns (visits {at[:8]}) — it would be written back "
                    f"twice")
    return diags


def check_block_matmul(m: int, n: int, k: int, *, bm: int, bn: int,
                       bk: int, order: str,
                       dtype: torch.dtype = torch.bfloat16
                       ) -> list[Diagnostic]:
    """Static checks of ``block_matmul``'s schedule (K3, K4) in ``dtype``.

    Proves: the kernel takes the tiles (``kernel_limits``); A/B tiles in
    bounds and contracting the same k tile; every C tile accumulated, by
    one block at a time (K4's cluster splits the inner loop over ranks,
    never a C tile), over its k tiles 0..k_t-1 once each and in k order
    across launches — what makes all six orders give the same bits; for
    K3 (k innermost) each C tile's visits one run of one block; and the
    cluster protocol of the core ``block_matmul.core_of`` picks free of
    hazards (:func:`gemm_walk`): on wgmma each rank's TMA/``mbarrier``
    rings of A and B tiles, and in a K4 cluster rank 0's pushes of the
    resident tile into the peers' slots after their ``ready`` arrivals,
    their arrivals on rank 0's ``empty`` once it has landed, and the
    exit sync; on mma.sync and fma K4's copies of the resident tile from
    rank 0 between cluster barriers."""
    try:
        kernel_limits(bm, bn, bk, dtype.itemsize, rmw=order[2] != "k")
    except KernelShapeError as e:
        return [Diagnostic.make("kern/emit", Severity.ERROR, str(e))]
    trace = gemm_walk(m, n, k, bm=bm, bn=bn, bk=bk, order=order,
                      dtype=dtype)
    diags = check_gemm_trace(trace)
    for hz in (h for events in trace.clusters
               for h in access.cluster_hazard_scan(events)):
        diags.append(Diagnostic.make("kern/hazard", Severity.ERROR,
                                     hz.describe(), step=hz.step,
                                     kind=hz.kind))
    return diags


# --------------------------------------------------------------------- #
# K5: the split decode kernel and its combine
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class DecodeTrace:
    """One (batch, KV head)'s blocks of the split kernel and the combine's
    reads: ``blocks`` holds ``(split, group, step, row0, row1, q_lo,
    q_hi)`` per step of each block (rows of the cache, rows of q);
    ``writes`` the partials (or, with one split, the outputs) as
    ``(split, group)``; ``reads`` what the combine reads."""

    g: int
    d: int
    s: int
    bkv: int
    splits: int
    groups: int
    blocks: list[tuple[int, int, int, int, int, int, int]]
    writes: list[tuple[int, int]]
    reads: list[tuple[int, int]]


def kv_rows(split: int, step: int, steps: int, bkv: int) -> tuple[int, int]:
    """Cache rows of a split block's step: its range starts at
    ``split * steps * bkv`` (``row0`` of ``csrc/flash_decode.cu``)."""
    row0 = (split * steps + step) * bkv
    return row0, row0 + bkv


def decode_walk(g: int, d: int, s: int, *, bkv: int,
                splits: int = 1) -> DecodeTrace:
    """Walk the split grid of one (batch, KV head): ``splits`` ranges
    (``decode_specs``) x ``ceil(G / 8)`` row groups, each block walking
    its range in ``bkv`` blocks with its query rows resident, writing one
    partial; with more than one split the combine reads every partial of
    the head."""
    splits_, steps = decode_specs(g, d, s, bkv, splits)
    groups = -(-g // DECODE_MAX_G)
    blocks, writes = [], []
    for split in range(splits_):
        for grp in range(groups):
            q_lo, q_hi = grp * DECODE_MAX_G, min(g, (grp + 1) * DECODE_MAX_G)
            for st in range(steps):
                blocks.append((split, grp, st,
                               *kv_rows(split, st, steps, bkv), q_lo, q_hi))
            writes.append((split, grp))
    reads = [(sp, grp) for sp in range(splits_) for grp in range(groups)] \
        if splits_ > 1 else []
    return DecodeTrace(g, d, s, bkv, splits_, groups, blocks, writes, reads)


def check_decode_trace(trace: DecodeTrace) -> list[Diagnostic]:
    diags: list[Diagnostic] = []

    def err(msg: str, *, step: int | None = None, **data) -> None:
        diags.append(Diagnostic.make("kern/coverage", Severity.ERROR, msg,
                                     step=step, **data))

    rows: dict[int, list[tuple[int, int]]] = {}
    q_of: dict[tuple[int, int], set[tuple[int, int]]] = {}
    for i, (split, grp, _, r0, r1, q_lo, q_hi) in enumerate(trace.blocks):
        if not 0 <= r0 < r1 <= trace.s:
            err(f"KV block [{r0}, {r1}) of range {split} lies outside the "
                f"cache of {trace.s} rows", step=i)
        rows.setdefault(grp, []).append((r0, r1))
        q_of.setdefault((split, grp), set()).add((q_lo, q_hi))
    for grp, spans in rows.items():
        if not _disjoint_cover(spans, 0, trace.s):
            err(f"row group {grp}: the ranges' KV blocks are not a "
                f"disjoint exact cover of the {trace.s} cache rows",
                group=grp)
    for (split, grp), qs in q_of.items():
        if len(qs) != 1:
            err(f"range {split}, row group {grp}: q rows change within the "
                f"range ({sorted(qs)}) — q is not resident")
    groups_q = {grp: next(iter(qs)) for (_, grp), qs in q_of.items()}
    if not _disjoint_cover(groups_q.values(), 0, trace.g):
        err(f"row groups' q rows {sorted(groups_q.values())} are not a "
            f"disjoint cover of the {trace.g} query rows")
    want = {(sp, grp) for sp in range(trace.splits)
            for grp in range(trace.groups)}
    counts: dict[tuple[int, int], int] = {}
    for w in trace.writes:
        counts[w] = counts.get(w, 0) + 1
    if set(counts) != want or any(c != 1 for c in counts.values()):
        err(f"partials written {sorted(counts.items())[:8]}, want each of "
            f"{len(want)} (range, row group) once")
    if trace.splits > 1 and sorted(trace.reads) != sorted(want):
        err(f"the combine reads {len(trace.reads)} partials, "
            f"{len(set(trace.reads) ^ want)} differ from those written")
    if trace.splits == 1 and trace.reads:
        err("one split writes the output itself, yet a combine reads it")
    return diags


def check_decode(g: int, d: int, s: int, *, bkv: int,
                 splits: int = 1) -> list[Diagnostic]:
    """Static checks of ``decode_attention``'s split schedule: the ranges
    a disjoint exact cover of the (padded) cache, q resident within a
    range, each (range, row group) partial written once and the combine
    reading exactly those."""
    return check_decode_trace(decode_walk(g, d, s, bkv=bkv, splits=splits))


# --------------------------------------------------------------------- #
# Whole-repo entry points (tests + CI)
# --------------------------------------------------------------------- #

def network_budget(specs: Sequence[ConvSpec],
                   factor: float = _DEFAULT_BUDGET_FACTOR) -> HardwareModel:
    """The budget kerncheck plans under: ``factor`` x the largest Λ."""
    lam = max(s.kernel_elements for s in specs)
    return HardwareModel(nbop_pe=_DEFAULT_NBOP,
                         size_mem=int(factor * lam))


def check_network(name: str, specs: Sequence[ConvSpec] | None = None, *,
                  hw: HardwareModel | None = None) -> VerificationReport:
    """Plan one network with the emitable solver and prove every conv
    layer's emitted kernel contract-equivalent to its LayerPlan, in both
    of the kernel's types (they differ in the bytes a share's pushes
    complete: whole 16 bytes of 2- or 4-byte elements)."""
    specs = list(NETWORKS[name] if specs is None else specs)
    hw = hw or network_budget(specs)
    report = VerificationReport(subject=f"kerncheck {name}")
    plan = plan_emitable_network(specs, hw, name=name)
    for lp in plan.layers:
        try:
            emitted = emit_layer_kernel(lp)
        except KernelEmitError as e:
            report.add(Diagnostic.make(
                "kern/emit", Severity.ERROR, str(e), layer=lp.index))
            continue
        for dtype in ("float32", "bfloat16"):
            trace = build_conv_trace(emitted, dtype)
            report.extend(check_conv_trace(trace, lp.strategy, hw.size_mem,
                                           layer=lp.index))
        report.checked_layers += 1
        report.checked_steps += len(trace.steps)
    return report


_STANDALONE_GEMM = [
    dict(m=256, n=384, k=512, bm=128, bn=128, bk=128, order="mnk"),
    dict(m=256, n=256, k=256, bm=128, bn=128, bk=128, order="nmk"),
    dict(m=256, n=256, k=512, bm=128, bn=128, bk=128, order="kmn"),
    dict(m=384, n=256, k=256, bm=128, bn=128, bk=128, order="mkn"),
]
_STANDALONE_DECODE = [
    dict(g=8, d=64, s=2048, bkv=512, splits=1),
    dict(g=4, d=128, s=4096, bkv=1024, splits=1),
]
# TinyLlama-1.1B: its prefill projections (m = 4 prompts x 480 tokens,
# (k, n)) and its decode attention (B=4, H_q=32, H_kv=4, D=64) over caches
# of 512 and 4096 rows, at the planner's tiles and splits.
_LLAMA_PREFILL_M = 4 * 480
_LLAMA_PREFILL_KN = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]
_LLAMA_DECODE = dict(batch=4, h_q=32, h_kv=4, d=64, s=(512, 4096))


def standalone_cases() -> tuple[list[dict], list[dict]]:
    """The GeMM and decode schedules :func:`run_all` checks: the JAX
    package's standalone cases and the planner's at TinyLlama-1.1B's
    shapes (bfloat16)."""
    gemm = list(_STANDALONE_GEMM)
    for k, n in _LLAMA_PREFILL_KN:
        plan = plan_matmul(_LLAMA_PREFILL_M, n, k, 2)
        bm, bn, bk = (plan.tiles[t] for t in ("bm", "bn", "bk"))
        m_p, n_p, k_p = (-(-_LLAMA_PREFILL_M // bm) * bm, -(-n // bn) * bn,
                         -(-k // bk) * bk)
        gemm.append(dict(m=m_p, n=n_p, k=k_p, bm=bm, bn=bn, bk=bk,
                         order=plan.order))
    decode = list(_STANDALONE_DECODE)
    cfg = _LLAMA_DECODE
    g = cfg["h_q"] // cfg["h_kv"]
    for s in cfg["s"]:
        plan = plan_decode_split(s, cfg["d"], g, cfg["batch"] * cfg["h_kv"],
                                 2)
        splits, bkv = plan.tiles["splits"], plan.tiles["bkv"]
        decode.append(dict(g=g, d=cfg["d"],
                           s=-(-s // (splits * bkv)) * splits * bkv,
                           bkv=bkv, splits=splits))
    return gemm, decode


def run_all(networks: Sequence[str] | None = None) -> VerificationReport:
    """The CI entry: every registered network + the standalone kernels."""
    merged = VerificationReport(subject="kerncheck")
    for name in (networks or sorted(NETWORKS)):
        rep = check_network(name)
        merged.extend(rep.diagnostics)
        merged.checked_layers += rep.checked_layers
        merged.checked_steps += rep.checked_steps
    gemm, decode = standalone_cases()
    for cfg in gemm:
        merged.extend(check_block_matmul(**cfg))
    for cfg in decode:
        merged.extend(check_decode(cfg["g"], cfg["d"], cfg["s"],
                                   bkv=cfg["bkv"], splits=cfg["splits"]))
    return merged


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.kerncheck",
        description="Prove the port's CUDA kernels implement their plans "
                    "(static access-set + cluster hazard analysis).")
    ap.add_argument("--network", action="append", dest="networks",
                    choices=sorted(NETWORKS),
                    help="check only this network (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    args = ap.parse_args(argv)
    report = run_all(args.networks)
    if args.json:
        print(report.to_json_str())
    else:
        print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":                      # pragma: no cover
    sys.exit(main())
