"""Symbolic region algebra + happens-before hazard analysis for kernels.

The kernel contract checker (:mod:`repro_torch.analysis.kerncheck`) walks a
Pallas kernel's grid *symbolically* — evaluating BlockSpec index_maps and
``make_async_copy`` source slices on concrete grid indices, never
executing the kernel — and needs two pieces of machinery:

* **regions** — rectangular boxes over named tensors/buffers
  (:class:`Region`): the HBM window a DMA reads, the VMEM slice it
  writes, the output block a step writes back.  Boxes support exact
  element counts and overlap tests, which is all the hazard and
  contract rules need (conv windows, GeMM tiles and KV pages are all
  boxes; scattered sets are handled by the bitmask ledger in
  :mod:`repro_torch.analysis.verifier`).

* **events** — a linear happens-before trace of the kernel's manual
  DMA pipeline (:class:`DmaStart`/:class:`DmaWait` on named semaphores,
  :class:`BufRead`/:class:`BufWrite` for compute-side accesses).  Grid
  steps execute sequentially on a TPU core, so program order *is* the
  happens-before order for issued operations; a DMA's effect (writing
  its destination, reading its source) is only ordered by the
  ``DmaWait`` that retires it.  :func:`hazard_scan` replays the trace
  under semaphore FIFO semantics and reports every access that races an
  in-flight DMA (RAW/WAR/WAW), every wait with no outstanding transfer
  (a lost-wait deadlock) and every transfer never retired (a leaked
  signal that desynchronises later waits).

* **cluster events** — the port's kernels run on a thread-block cluster,
  where program order is no longer the happens-before order: several
  *agents* (:class:`Agent`: a rank of the cluster, and a role within the
  block, such as eight compute warps beside one service warp) run at
  once, ordered only by barriers.  A cluster trace gives every event its
  agent: :class:`ClusterArrive` / :class:`ClusterWait` (the split cluster
  barrier, release/acquire as in the CUDA source), :class:`Fence`,
  :class:`BlockSync` (``__syncthreads``), :class:`Copy` /
  :class:`CopyCommit` / :class:`CopyWait` (``cp.async`` groups, per
  agent), :class:`Read` / :class:`Write` of :class:`Cells` (element sets
  of one rank's shared memory or of device memory; a read of another
  rank's cells is a distributed-shared-memory read) and
  :class:`BlockExit`.  :func:`cluster_hazard_scan` closes the trace under
  happens-before with vector clocks and reports unordered conflicting
  accesses, copies read or overwritten in flight, reads of a peer's shared
  memory that may come after the peer exited, barriers that can never
  complete and copies never waited on.  Point-to-point barriers are
  ``mbarrier``s (:class:`Mbar`): :class:`MbarInit`, :class:`MbarArrive`
  (release, optionally expecting bytes), :class:`MbarWait` (acquire of
  one phase) and :class:`Push` (a bulk copy between shared memories, or
  ``st.async``: a write into a rank's shared memory that lands when the
  phase it completes bytes on completes).

:func:`timed_delivery_violations` is the *timed* variant used for
``overlap=True`` multi-chip halo schedules: there the consumer never
waits (that is the point of overlapping), so soundness is a timing
proof — every read of an in-flight transfer's destination must start
after the transfer completes.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Iterable, Sequence, Union

_ABS = 1e-6


# --------------------------------------------------------------------- #
# Regions
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Region:
    """A rectangular box over a named tensor or buffer.

    ``box`` is a tuple of half-open ``(lo, hi)`` intervals, one per axis.
    Two regions can only overlap when they name the same tensor.
    """

    tensor: str
    box: tuple[tuple[int, int], ...]

    def __post_init__(self) -> None:
        for lo, hi in self.box:
            if hi < lo:
                raise ValueError(f"empty axis interval ({lo}, {hi}) in "
                                 f"region of {self.tensor!r}")

    @property
    def elements(self) -> int:
        n = 1
        for lo, hi in self.box:
            n *= hi - lo
        return n

    def overlaps(self, other: "Region") -> bool:
        if self.tensor != other.tensor or len(self.box) != len(other.box):
            return False
        return all(lo < ohi and olo < hi
                   for (lo, hi), (olo, ohi) in zip(self.box, other.box))

    def contains(self, other: "Region") -> bool:
        if self.tensor != other.tensor or len(self.box) != len(other.box):
            return False
        return all(lo <= olo and ohi <= hi
                   for (lo, hi), (olo, ohi) in zip(self.box, other.box))

    def describe(self) -> str:
        spans = ",".join(f"{lo}:{hi}" for lo, hi in self.box)
        return f"{self.tensor}[{spans}]"


def box_region(tensor: str, *spans: tuple[int, int]) -> Region:
    """Convenience constructor: ``box_region("x", (0, 4), (2, 8))``."""
    return Region(tensor, tuple(spans))


# --------------------------------------------------------------------- #
# Happens-before events
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class DmaStart:
    """``make_async_copy(src, dst, sem).start()`` at grid step ``step``."""

    sem: str
    src: Region
    dst: Region
    step: int
    tag: str = ""               # human label ("win full", "col prefetch")


@dataclasses.dataclass(frozen=True)
class DmaWait:
    """``.wait()`` on ``sem`` — retires the oldest outstanding start."""

    sem: str
    step: int


@dataclasses.dataclass(frozen=True)
class BufRead:
    """Compute-side read of a buffer region (im2col, dot operand)."""

    region: Region
    step: int


@dataclasses.dataclass(frozen=True)
class BufWrite:
    """Compute-side write of a buffer region (shift, output store)."""

    region: Region
    step: int


Event = Union[DmaStart, DmaWait, BufRead, BufWrite]


@dataclasses.dataclass(frozen=True)
class Hazard:
    """One happens-before violation found by :func:`hazard_scan`."""

    kind: str                   # "raw" | "war" | "waw" | "lost-wait" | "leak"
    step: int                   # grid step of the violating event
    detail: str

    def describe(self) -> str:
        return f"[step {self.step}] {self.kind}: {self.detail}"


def hazard_scan(events: Iterable[Event]) -> list[Hazard]:
    """Replay a kernel's event trace under semaphore FIFO semantics.

    A started DMA is *in flight* (asynchronously writing ``dst`` and
    reading ``src``) until a ``DmaWait`` on its semaphore retires it —
    waits retire starts oldest-first, matching the hardware's counting
    semantics for the one-transfer-per-wait idiom the kernels use.
    Any program-ordered access that touches an in-flight transfer's
    destination (or overwrites its source) is unordered with the DMA
    engine and reported as a hazard.
    """
    hazards: list[Hazard] = []
    outstanding: dict[str, deque[DmaStart]] = {}
    in_flight: list[DmaStart] = []

    def _conflicts(region: Region, write: bool, step: int,
                   what: str) -> None:
        for d in in_flight:
            if region.overlaps(d.dst):
                kind = "waw" if write else "raw"
                hazards.append(Hazard(
                    kind, step,
                    f"{what} {region.describe()} while DMA "
                    f"{d.tag or d.sem} (started step {d.step}) is still "
                    f"writing {d.dst.describe()} — missing wait"))
            elif write and region.overlaps(d.src):
                hazards.append(Hazard(
                    "war", step,
                    f"{what} {region.describe()} while DMA "
                    f"{d.tag or d.sem} (started step {d.step}) still "
                    f"reads {d.src.describe()}"))

    for ev in events:
        if isinstance(ev, DmaStart):
            _conflicts(ev.dst, write=True, step=ev.step,
                       what=f"DMA {ev.tag or ev.sem} writes")
            # a start whose *source* is being written by an in-flight DMA
            for d in in_flight:
                if ev.src.overlaps(d.dst):
                    hazards.append(Hazard(
                        "raw", ev.step,
                        f"DMA {ev.tag or ev.sem} reads "
                        f"{ev.src.describe()} while DMA {d.tag or d.sem} "
                        f"is still writing {d.dst.describe()}"))
            outstanding.setdefault(ev.sem, deque()).append(ev)
            in_flight.append(ev)
        elif isinstance(ev, DmaWait):
            queue = outstanding.get(ev.sem)
            if not queue:
                hazards.append(Hazard(
                    "lost-wait", ev.step,
                    f"wait on semaphore {ev.sem!r} with no outstanding "
                    f"transfer — the kernel deadlocks here"))
                continue
            done = queue.popleft()
            in_flight.remove(done)
        elif isinstance(ev, BufRead):
            _conflicts(ev.region, write=False, step=ev.step, what="read of")
        elif isinstance(ev, BufWrite):
            _conflicts(ev.region, write=True, step=ev.step, what="write of")
        else:                                        # pragma: no cover
            raise TypeError(f"unknown event {ev!r}")

    for d in in_flight:
        hazards.append(Hazard(
            "leak", d.step,
            f"DMA {d.tag or d.sem} (started step {d.step}) is never "
            f"waited on — its completion signal desynchronises any later "
            f"wait on {d.sem!r}"))
    return hazards


# --------------------------------------------------------------------- #
# Cluster kernels: agents, barriers, copies, DSMEM reads, exits
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Agent:
    """Threads of one block that run one program: ``rank`` in the
    cluster, ``role`` within the block ("compute", "service", or "block"
    where the whole block runs one program)."""

    rank: int
    role: str = "block"

    def describe(self) -> str:
        return f"rank {self.rank} {self.role}"


@dataclasses.dataclass(frozen=True)
class Cells:
    """A set of elements of one buffer, as a bitmask over its flat index.
    ``owner`` is the rank whose shared memory holds the buffer, ``None``
    for device memory.  Two sets overlap only within one buffer of one
    owner."""

    space: str
    owner: int | None
    mask: int

    @property
    def elements(self) -> int:
        return self.mask.bit_count()

    def overlaps(self, other: "Cells") -> bool:
        return (self.space == other.space and self.owner == other.owner
                and bool(self.mask & other.mask))

    def describe(self) -> str:
        where = "device" if self.owner is None else f"rank {self.owner}"
        if not self.mask:
            return f"{self.space}@{where}[empty]"
        lo = (self.mask & -self.mask).bit_length() - 1
        return (f"{self.space}@{where}[{self.elements} cells in "
                f"{lo}:{self.mask.bit_length()}]")


def span_cells(space: str, owner: int | None, lo: int, hi: int) -> Cells:
    """The cells ``[lo, hi)`` of a buffer's flat index."""
    return Cells(space, owner, ((1 << (hi - lo)) - 1) << lo if hi > lo
                 else 0)


@dataclasses.dataclass(frozen=True)
class Copy:
    """An asynchronous copy (``cp.async``) into ``dst``, issued by
    ``agent`` into its open group; it lands at the agent's
    :class:`CopyWait` that retires the group."""

    agent: Agent
    dst: Cells
    step: int
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class CopyCommit:
    """``cp.async.commit_group``: closes the agent's open group."""

    agent: Agent
    step: int


@dataclasses.dataclass(frozen=True)
class CopyWait:
    """``cp.async.wait_group keep`` (all but the ``keep`` newest committed
    groups land), or ``cp.async.wait_all`` with ``keep=None`` (every copy
    of the agent, committed or not)."""

    agent: Agent
    step: int
    keep: int | None = None


@dataclasses.dataclass(frozen=True)
class Read:
    """A synchronous read; of a peer's shared memory when ``cells.owner``
    is another rank (distributed shared memory)."""

    agent: Agent
    cells: Cells
    step: int
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class Write:
    """A synchronous write (a store, or a plain load into shared memory)."""

    agent: Agent
    cells: Cells
    step: int
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class ClusterArrive:
    """``barrier.cluster.arrive``: with ``release``, everything the agent
    did before is visible to whoever waits on this phase; relaxed, only
    what preceded the agent's last :class:`Fence`."""

    agent: Agent
    step: int
    release: bool = True
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class ClusterWait:
    """``barrier.cluster.wait`` (acquire): the agent's n-th wait returns
    once every agent that has not exited has arrived n times."""

    agent: Agent
    step: int
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class Fence:
    """``fence.acq_rel.cluster``: a later relaxed arrive releases what
    the agent did, or acquired, before the fence."""

    agent: Agent
    step: int


@dataclasses.dataclass(frozen=True)
class BlockSync:
    """``__syncthreads``: every agent of the rank meets, each acquiring
    what the others did before."""

    agent: Agent
    step: int


@dataclasses.dataclass(frozen=True)
class BlockExit:
    """The agent's threads exit; a rank's shared memory is gone once all
    of its agents have exited."""

    agent: Agent
    step: int


@dataclasses.dataclass(frozen=True)
class Mbar:
    """An ``mbarrier`` in the shared memory of rank ``owner``."""

    owner: int
    name: str

    def describe(self) -> str:
        return f"mbarrier {self.name}@rank {self.owner}"


@dataclasses.dataclass(frozen=True)
class MbarInit:
    """``mbarrier.init``: a phase completes after ``count`` arrivals (and
    the bytes they expect); issued by an agent of the owner."""

    agent: Agent
    bar: Mbar
    count: int
    step: int


@dataclasses.dataclass(frozen=True)
class MbarArrive:
    """``mbarrier.arrive`` (release) on phase ``phase`` of ``bar``,
    expecting ``tx`` bytes of pushes in that phase; on a peer's barrier
    when ``bar.owner`` is another rank."""

    agent: Agent
    bar: Mbar
    phase: int
    step: int
    tx: int = 0
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class MbarWait:
    """``mbarrier.try_wait.parity`` (acquire) until phase ``phase`` of
    ``bar`` has completed."""

    agent: Agent
    bar: Mbar
    phase: int
    step: int
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class Push:
    """A bulk copy (or ``st.async``) into ``dst`` (a rank's shared
    memory), completing ``tx`` bytes on phase ``phase`` of ``bar``: the
    write lands when that phase completes, and only an agent that
    acquired the completion is ordered after it."""

    agent: Agent
    dst: Cells
    bar: Mbar
    phase: int
    step: int
    tx: int
    tag: str = ""


ClusterEvent = Union[Copy, CopyCommit, CopyWait, Read, Write, ClusterArrive,
                     ClusterWait, Fence, BlockSync, BlockExit, MbarInit,
                     MbarArrive, MbarWait, Push]


@dataclasses.dataclass
class _Access:
    agent: int
    clock: int
    mask: int
    write: bool
    step: int
    what: str
    rank: int = -1          # the accessing rank (a push's issuer)
    sync: bool = False      # a barrier's word: checked against exits only


@dataclasses.dataclass
class _InFlight:
    ev: Copy
    agent: int


def _join(a: list[int], b: Sequence[int]) -> None:
    for j, v in enumerate(b):
        if v > a[j]:
            a[j] = v


def cluster_hazard_scan(events: Iterable[ClusterEvent]) -> list[Hazard]:
    """Happens-before analysis of a cluster kernel's trace.

    Each agent's events run in their trace order; agents are ordered only
    by barriers.  The scan runs the agents as far as their barriers let
    them, keeping a vector clock per agent: a release arrive (or a relaxed
    one after a fence) adds the agent's clock to its phase, a wait joins
    the phase's clock into the agent's, a block barrier joins the clocks
    of the rank's agents.  A copy's write is unordered with everything
    from its issue until the wait that retires it.  Reported, as
    :class:`Hazard` kinds:

    * ``raw`` / ``war`` / ``waw``: two accesses of overlapping cells, one
      a write, by agents that no barrier orders, or an access of a copy's
      cells while the copy is in flight;
    * ``exit``: an access of a rank's shared memory by a peer that is not
      ordered before that rank's last agent exits;
    * ``barrier``: an arrive before the agent waited on its previous
      arrive's phase (undefined for ``barrier.cluster``);
    * ``lost-wait``: a barrier that can never complete (the kernel hangs);
    * ``leak``: a copy never retired by a wait, or a push whose phase
      never completes.

    An mbarrier is one more component of the vector clocks: the
    completion of its phase p stamps it p + 1, so an agent is ordered
    after that completion (and after the pushes it landed) exactly when
    it acquired the phase, directly or through others.  An arrive or a
    push meant for phase p must be ordered after the completion of phase
    p - 1 and after the barrier's init (``barrier`` otherwise); a phase
    that receives more bytes than its arrivals expect never completes.
    """
    events = list(events)
    agents = sorted({ev.agent for ev in events},
                    key=lambda a: (a.rank, a.role))
    idx = {a: i for i, a in enumerate(agents)}
    bars = sorted({ev.bar for ev in events
                   if isinstance(ev, (MbarInit, MbarArrive, MbarWait, Push))},
                  key=lambda b: (b.owner, b.name))
    n_agents = len(agents)
    bar_ix = {b: n_agents + j for j, b in enumerate(bars)}
    n = n_agents + len(bars)
    prog: list[list] = [[] for _ in agents]
    for ev in events:
        prog[idx[ev.agent]].append(ev)
    members: dict[int, list[int]] = {}
    for a, i in idx.items():
        members.setdefault(a.rank, []).append(i)
    # per mbarrier: its count and the clock of its init, the phases
    # completed, and per open phase its arrivals, expected and completed
    # bytes, released clock and pushes in flight
    count: dict[Mbar, int] = {}
    init_at: dict[Mbar, tuple[int, int]] = {}
    done: dict[Mbar, int] = {b: 0 for b in bars}
    done_vc: dict[tuple[Mbar, int], list[int]] = {}
    open_ph: dict[tuple[Mbar, int], dict] = {}
    pushes: list[tuple[Push, int, int]] = []     # (push, issuer, clock)

    hazards: list[Hazard] = []
    vc = [[0] * n for _ in range(n)]
    pos = [0] * n
    arrived = [0] * n
    waited = [0] * n
    fenced: list[list[int] | None] = [None] * n
    phase_vc: dict[int, list[int]] = {}
    syncs = [0] * n
    sync_at: dict[tuple[int, int], dict[int, list[int]]] = {}
    exited = [False] * n
    exit_vc: dict[int, list[int]] = {}
    freed: dict[int, list[int]] = {}
    open_group: list[list[_InFlight]] = [[] for _ in range(n)]
    groups: list[deque[list[_InFlight]]] = [deque() for _ in range(n)]
    in_flight: list[_InFlight] = []
    history: dict[tuple[str, int | None], list[_Access]] = {}
    since_prune = 0

    def who(i: int) -> str:
        if i >= n_agents:
            return f"a push completing on {bars[i - n_agents].describe()}"
        return agents[i].describe()

    def access(i: int, cells: Cells, write: bool, step: int,
               what: str) -> None:
        if (cells.owner is not None and cells.owner in freed
                and cells.owner != agents[i].rank):
            hazards.append(Hazard(
                "exit", step,
                f"{who(i)} {what} {cells.describe()} after rank "
                f"{cells.owner} exited"))
        for c in in_flight:
            if c.ev.dst.overlaps(cells):
                hazards.append(Hazard(
                    "waw" if write else "raw", step,
                    f"{who(i)} {what} {cells.describe()} while copy "
                    f"{c.ev.tag or 'cp.async'} of {who(c.agent)} (issued "
                    f"step {c.ev.step}) is in flight into "
                    f"{c.ev.dst.describe()}"))
        for p, j, _ in pushes:
            if p.dst.overlaps(cells):
                hazards.append(Hazard(
                    "waw" if write else "raw", step,
                    f"{who(i)} {what} {cells.describe()} while a push of "
                    f"{who(j)} (step {p.step}) into {p.dst.describe()} "
                    f"waits for phase {p.phase} of {p.bar.describe()}"))
        for h in history.get((cells.space, cells.owner), ()):
            if h.sync or h.agent == i or not (h.write or write) \
                    or not h.mask & cells.mask or vc[i][h.agent] >= h.clock:
                continue
            kind = "waw" if h.write and write else ("raw" if h.write
                                                    else "war")
            hazards.append(Hazard(
                kind, step,
                f"{who(i)} {what} {cells.describe()}, unordered with "
                f"{who(h.agent)}'s {h.what} at step {h.step}"))

    def record(i: int, cells: Cells, write: bool, step: int,
               what: str) -> None:
        history.setdefault((cells.space, cells.owner), []).append(
            _Access(i, vc[i][i], cells.mask, write, step, what,
                    rank=agents[i].rank))

    def ordered_on(i: int, bar: Mbar, phase: int, step: int,
                   what: str) -> None:
        """An arrive or push of agent i meant for ``phase``: after the
        init and after the completion of the phase before."""
        if bar not in init_at or vc[i][init_at[bar][0]] < init_at[bar][1]:
            hazards.append(Hazard(
                "barrier", step,
                f"{who(i)} {what} {bar.describe()} not ordered after its "
                f"init"))
        elif phase < done[bar] or (phase > 0
                                   and vc[i][bar_ix[bar]] < phase):
            hazards.append(Hazard(
                "barrier", step,
                f"{who(i)} {what} phase {phase} of {bar.describe()}, not "
                f"ordered after phase {phase - 1} completed"))

    def phase_of(bar: Mbar, phase: int) -> dict:
        return open_ph.setdefault((bar, phase), dict(
            arrived=0, expect=0, landed=0, vc=[0] * n))

    def complete() -> None:
        """Complete every phase whose arrivals and bytes are in."""
        for bar in bars:
            while True:
                ph = open_ph.get((bar, done[bar]))
                if ph is None or bar not in count \
                        or ph["arrived"] < count[bar] \
                        or ph["landed"] != ph["expect"]:
                    break
                p = done[bar]
                out = list(ph["vc"])
                out[bar_ix[bar]] = p + 1
                done_vc[(bar, p)] = out
                done[bar] = p + 1
                del open_ph[(bar, p)]
                for k in [k for k, (ev, _, _) in enumerate(pushes)
                          if ev.bar == bar and ev.phase == p][::-1]:
                    ev, j, _ = pushes.pop(k)
                    history.setdefault((ev.dst.space, ev.dst.owner),
                                       []).append(_Access(
                                           bar_ix[bar], p + 1, ev.dst.mask,
                                           True, ev.step,
                                           f"push {ev.tag}".strip(),
                                           rank=agents[j].rank))

    def retire(i: int, copies: list[_InFlight]) -> None:
        for c in copies:
            in_flight.remove(c)
            record(i, c.ev.dst, True, c.ev.step,
                   f"copy {c.ev.tag or 'cp.async'}")

    def prune() -> None:
        live = [k for k in range(n_agents) if not exited[k]]
        if not live:
            return
        floor = [min(vc[k][j] for k in live) for j in range(n)]
        for key, recs in history.items():
            history[key] = [h for h in recs if h.clock > floor[h.agent]]

    def phase_done(p: int) -> bool:
        return all(arrived[k] > p or exited[k] for k in range(n_agents))

    def run(i: int, ev) -> bool:
        """Process one event of agent i; False while it is blocked."""
        if isinstance(ev, ClusterWait):
            p = waited[i]
            if not phase_done(p):
                return False
            _join(vc[i], phase_vc.get(p, [0] * n))
            waited[i] += 1
        elif isinstance(ev, MbarWait):
            if done[ev.bar] <= ev.phase:
                return False
            _join(vc[i], done_vc[(ev.bar, ev.phase)])
        elif isinstance(ev, BlockSync):
            k = syncs[i]
            met = sync_at.setdefault((agents[i].rank, k), {})
            met[i] = list(vc[i])
            if any(j not in met and not exited[j]
                   for j in members[agents[i].rank]):
                return False
            for v in met.values():
                _join(vc[i], v)
            syncs[i] += 1
        vc[i][i] += 1
        step = ev.step
        if isinstance(ev, (ClusterWait, BlockSync, MbarWait)):
            pass
        elif isinstance(ev, MbarInit):
            count[ev.bar] = ev.count
            init_at[ev.bar] = (i, vc[i][i])
            complete()
        elif isinstance(ev, MbarArrive):
            ordered_on(i, ev.bar, ev.phase, step, "arrives on")
            if ev.bar.owner != agents[i].rank:
                touch = Cells(f"mbarrier {ev.bar.name}", ev.bar.owner, 1)
                access(i, touch, True, step, "arrives on")
                history.setdefault((touch.space, touch.owner), []).append(
                    _Access(i, vc[i][i], 1, True, step,
                            f"arrive on {ev.bar.name}",
                            rank=agents[i].rank, sync=True))
            ph = phase_of(ev.bar, ev.phase)
            ph["arrived"] += 1
            ph["expect"] += ev.tx
            _join(ph["vc"], vc[i])
            if ev.bar in count and ph["arrived"] > count[ev.bar]:
                hazards.append(Hazard(
                    "barrier", step,
                    f"{who(i)} is arrival {ph['arrived']} on phase "
                    f"{ev.phase} of {ev.bar.describe()}, which counts "
                    f"{count[ev.bar]}"))
            complete()
        elif isinstance(ev, Push):
            ordered_on(i, ev.bar, ev.phase, step, "pushes for")
            access(i, ev.dst, True, step,
                   f"pushes ({ev.tag or 'bulk copy'}) into")
            ph = phase_of(ev.bar, ev.phase)
            ph["landed"] += ev.tx
            _join(ph["vc"], vc[i])
            pushes.append((ev, i, vc[i][i]))
            complete()
        elif isinstance(ev, ClusterArrive):
            if arrived[i] > waited[i]:
                hazards.append(Hazard(
                    "barrier", step,
                    f"{who(i)} arrives at cluster barrier phase "
                    f"{arrived[i]} before waiting on phase "
                    f"{arrived[i] - 1}"))
            out = list(vc[i]) if ev.release else fenced[i]
            if out is not None:
                _join(phase_vc.setdefault(arrived[i], [0] * n), out)
            arrived[i] += 1
        elif isinstance(ev, Fence):
            fenced[i] = list(vc[i])
        elif isinstance(ev, (Read, Write)):
            write = isinstance(ev, Write)
            verb = "write" if write else "read"
            access(i, ev.cells, write, step, f"{verb}s {ev.tag}".strip())
            record(i, ev.cells, write, step, f"{verb} {ev.tag}".strip())
        elif isinstance(ev, Copy):
            access(i, ev.dst, True, step,
                   f"copies ({ev.tag or 'cp.async'}) into")
            c = _InFlight(ev, i)
            in_flight.append(c)
            open_group[i].append(c)
        elif isinstance(ev, CopyCommit):
            if open_group[i]:
                groups[i].append(open_group[i])
                open_group[i] = []
        elif isinstance(ev, CopyWait):
            if ev.keep is None:
                while groups[i]:
                    retire(i, groups[i].popleft())
                retire(i, open_group[i])
                open_group[i] = []
            else:
                while len(groups[i]) > ev.keep:
                    retire(i, groups[i].popleft())
        elif isinstance(ev, BlockExit):
            exited[i] = True
            exit_vc[i] = list(vc[i])
            rank = agents[i].rank
            if all(exited[j] for j in members[rank]):
                gone = [0] * n
                for j in members[rank]:
                    _join(gone, exit_vc[j])
                freed[rank] = gone
                for p, j, _ in pushes:
                    if p.dst.owner == rank:
                        hazards.append(Hazard(
                            "exit", p.step,
                            f"a push of {who(j)} into {p.dst.describe()} "
                            f"is in flight when rank {rank} exits"))
                for (space, owner), recs in history.items():
                    if owner != rank:
                        continue
                    for h in recs:
                        if h.rank != rank and gone[h.agent] < h.clock:
                            hazards.append(Hazard(
                                "exit", h.step,
                                f"{who(h.agent)}'s {h.what} of {space}@rank "
                                f"{rank} is not ordered before rank {rank} "
                                f"exits (step {step})"))
        else:                                        # pragma: no cover
            raise TypeError(f"unknown event {ev!r}")
        return True

    progress = True
    while progress:
        progress = False
        for i in range(n_agents):
            while pos[i] < len(prog[i]):
                if not run(i, prog[i][pos[i]]):
                    break
                pos[i] += 1
                progress = True
                since_prune += 1
                if since_prune >= 512:
                    prune()
                    since_prune = 0
    for i in range(n_agents):
        if pos[i] < len(prog[i]):
            ev = prog[i][pos[i]]
            what = ("cluster barrier phase " + str(waited[i])
                    if isinstance(ev, ClusterWait) else
                    f"phase {ev.phase} of {ev.bar.describe()}"
                    if isinstance(ev, MbarWait) else "block barrier")
            hazards.append(Hazard(
                "lost-wait", ev.step,
                f"{who(i)} waits on {what}, which never completes — the "
                f"kernel hangs here"))
    for c in in_flight:
        hazards.append(Hazard(
            "leak", c.ev.step,
            f"copy {c.ev.tag or 'cp.async'} of {who(c.agent)} into "
            f"{c.ev.dst.describe()} (issued step {c.ev.step}) is never "
            f"waited on"))
    for p, j, _ in pushes:
        hazards.append(Hazard(
            "leak", p.step,
            f"a push of {who(j)} into {p.dst.describe()} (step {p.step}) "
            f"never lands: phase {p.phase} of {p.bar.describe()} never "
            f"completes"))
    return hazards


# --------------------------------------------------------------------- #
# Timed delivery (overlapped transfers that are never waited on)
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class TimedViolation:
    """A read that starts before the transfer feeding it completes."""

    read_time: float
    complete_time: float
    region: Region


def timed_delivery_violations(
        transfers: Sequence[tuple[float, Region]],
        reads: Sequence[tuple[float, Region]],
) -> list[TimedViolation]:
    """Soundness of *overlapped* (wait-free) transfers, by timing.

    ``transfers`` are ``(complete_time, dst_region)`` pairs — e.g. the
    inbound halo exchange of an ``overlap=True`` multi-chip stage, which
    completes at ``ici_duration`` after stage start.  ``reads`` are
    ``(start_time, region)`` pairs from the consumer's step walk.  A read
    overlapping a transfer's destination must start at or after the
    transfer's completion; everything earlier is returned, earliest
    first.  An empty result is a proof that the overlap claim is sound
    under the plan's own step timing.
    """
    found: list[TimedViolation] = []
    for t_read, region in reads:
        for t_done, dst in transfers:
            if region.overlaps(dst) and t_read + _ABS < t_done:
                found.append(TimedViolation(t_read, t_done, region))
                break
    found.sort(key=lambda v: v.read_time)
    return found


def first_violation_or_none(
        transfers: Sequence[tuple[float, Region]],
        reads: Sequence[tuple[float, Region]],
) -> "TimedViolation | None":
    vs = timed_delivery_violations(transfers, reads)
    return vs[0] if vs else None


def total_order_ok(times: Sequence[float]) -> bool:
    """True when a step-time sequence is sane (monotone, finite)."""
    prev = -math.inf
    for t in times:
        if not math.isfinite(t) or t + _ABS < prev:
            return False
        prev = t
    return True
