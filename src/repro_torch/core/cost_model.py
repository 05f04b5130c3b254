"""Platform model (paper Sec 2.1) and duration model (Def 3).

The accelerator is capable of ``nbop_pe`` MAC operations per ``t_acc`` cycles.
The on-chip memory has size ``size_mem``.  Loading one element from DRAM to
on-chip memory costs ``t_l``; writing one element back costs ``t_w``.  All
durations are in accelerator cycles; all sizes are unit-less integers, as in
the paper.

Unit convention (see DESIGN.md §6): the paper's Example 2 counts *spatial*
pixels for duration (an I_slice listing 12 tensor elements over C_in=2
channels contributes ``6 * t_l``), while memory-footprint statements count
tensor *elements* (``M_2^inp = 32``).  We therefore keep sets of spatial
locations and expose both countings; duration uses spatial counts, footprint
uses element counts.
"""
from __future__ import annotations

import dataclasses
import math
import re


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Generic accelerator of paper Fig. 1."""

    nbop_pe: int            # MAC ops available per t_acc window
    size_mem: int | None = None   # on-chip memory capacity (elements); None = unconstrained (paper Sec 7.1)
    t_l: float = 1.0        # cycles to load one (spatial) element DRAM -> on-chip
    t_w: float = 1.0        # cycles to write one (spatial) element on-chip -> DRAM
    t_acc: float = 1.0      # cycles per compute step

    def nb_patches_max_s1(self, nb_op_value: int, c_out: int) -> int:
        """Paper Sec 4.2: max patches the PE can consume in one S1 step."""
        cap = self.nbop_pe // (nb_op_value * c_out)
        if cap < 1:
            raise ValueError(
                f"accelerator too small: nbop_pe={self.nbop_pe} < one patch "
                f"({nb_op_value}*{c_out} MACs)")
        return cap


# ---------------------------------------------------------------------------
# Multi-chip cluster (beyond-paper: core.multichip).  Same unit system as
# HardwareModel — ``t_ici`` is the Def-3-style element-transfer cost of the
# inter-chip interconnect, sitting next to ``t_l``/``t_w``.
# ---------------------------------------------------------------------------

_TORUS_RE = re.compile(r"^torus(\d+)x(\d+)$")


@dataclasses.dataclass(frozen=True)
class Topology:
    """ICI wiring of a cluster, with per-topology collective pricing.

    ``kind`` is ``'ring'`` (1-D) or ``'torus'`` (2-D, ``dims=(rows,
    cols)`` rings along each axis — axis 0 is the *row-band* axis, axis 1
    the *kernel-channel* axis of ``core.multichip``'s hybrid sharding).
    ``bidirectional`` links carry traffic both ways, halving the
    bottleneck-link load of every split-table collective (the standard
    bidirectional-ring algorithm); a halo *shift* moves one boundary's
    rows one hop, so it costs the same either way.

    Every collective method returns the **bottleneck-link element
    count** of the phase — multiply by ``ClusterModel.t_ici`` for cycles.
    Links transfer in parallel; chips do not overlap ICI with compute
    unless the planner's ``overlap`` discipline says so.  2-D collectives
    run their two axis phases serially (axis 1 first, rows in parallel;
    then axis 0) — the conservative, predictable schedule in the spirit
    of the paper's Def 3.  A ``1xN`` (or ``Nx1``) torus therefore prices
    every collective exactly like the ``N``-ring with the same link
    direction — property-tested in ``tests/test_topology*.py``.

    The formulas follow the communication-lower-bound accounting of Chen
    et al. (arXiv:1911.05662): an all-gather / gather / scatter /
    reduce-scatter of ``A`` elements over a ``k``-ring keeps one link
    busy with ``ceil(A*(k-1)/k)`` elements; a pipelined broadcast pushes
    the full ``A`` through the source's link.
    """

    kind: str = "ring"                  # 'ring' | 'torus'
    dims: tuple[int, int] | None = None  # torus only: (rows, cols)
    bidirectional: bool = False

    def __post_init__(self):
        if self.kind not in ("ring", "torus"):
            raise ValueError(f"unknown topology kind {self.kind!r}")
        if self.kind == "torus":
            if (self.dims is None or len(self.dims) != 2
                    or min(self.dims) < 1):
                raise ValueError(
                    f"torus needs dims=(rows, cols) >= (1, 1), "
                    f"got {self.dims!r}")
            object.__setattr__(self, "dims", tuple(self.dims))
        elif self.dims is not None:
            raise ValueError("ring topology takes no dims")

    # ---- construction ------------------------------------------------ #

    @classmethod
    def parse(cls, s: "str | Topology") -> "Topology":
        """``'ring'`` | ``'biring'`` | ``'torusRxC'`` (bidirectional,
        v5e-style) — or an already-built :class:`Topology`."""
        if isinstance(s, Topology):
            return s
        if s == "ring":
            return cls("ring")
        if s == "biring":
            return cls("ring", bidirectional=True)
        m = _TORUS_RE.match(s)
        if m:
            return cls("torus", (int(m.group(1)), int(m.group(2))),
                       bidirectional=True)
        raise ValueError(
            f"unknown topology {s!r} (want 'ring', 'biring', 'torusRxC' "
            f"or a Topology instance)")

    def describe(self) -> str:
        if self.kind == "torus":
            ny, nx = self.dims
            link = "bidirectional" if self.bidirectional else \
                "unidirectional"
            return f"{ny}x{nx} torus, {link} links"
        return ("bidirectional ring" if self.bidirectional else
                "unidirectional ring")

    # ---- geometry ---------------------------------------------------- #

    def n_links_ok(self, n_chips: int) -> bool:
        """Does this wiring exist for ``n_chips`` chips?"""
        if self.kind == "torus":
            ny, nx = self.dims
            return ny * nx == n_chips
        return True

    def grid(self, n_chips: int) -> tuple[int, int]:
        """(rows, cols) — a ring is an ``n x 1`` grid (one band axis)."""
        if self.kind == "torus":
            return self.dims
        return (n_chips, 1)

    # ---- ring primitives --------------------------------------------- #

    def _dir(self, x: int) -> int:
        """Bidirectional links split a collective's bottleneck load."""
        return (x + 1) // 2 if self.bidirectional else x

    @staticmethod
    def _ring_split(k: int, a: int) -> int:
        """Uni-ring gather/scatter/all-gather/reduce-scatter bottleneck
        over ``k`` chips of an ``a``-element tensor."""
        if k <= 1:
            return 0
        return math.ceil(a * (k - 1) / k)

    # ---- whole-cluster collectives (bottleneck-link elements) --------- #

    def gather(self, n_chips: int, a: int) -> int:
        """Sharded-over-all-chips tensor collected onto one chip: axis-1
        rings funnel each band row (in parallel), then the axis-0 ring
        funnels the full tensor."""
        ny, nx = self.grid(n_chips)
        return (self._dir(self._ring_split(nx, math.ceil(a / ny)))
                + self._dir(self._ring_split(ny, a)))

    def scatter(self, n_chips: int, a: int) -> int:
        """One chip's tensor distributed into per-chip shards (reverse
        gather — same bottleneck)."""
        return self.gather(n_chips, a)

    def allgather(self, n_chips: int, a: int) -> int:
        """Every chip ends with the full ``a``-element tensor."""
        return self.gather(n_chips, a)

    def reduce_scatter(self, n_chips: int, a: int) -> int:  # lint: experimental-api
        """Per-chip partial sums combined and left sharded (the hybrid
        input-channel follow-up's collective; same ring bottleneck as
        the all-gather, per the standard ring algorithm).

        .. note:: **Experimental.**  No planner mode emits this collective
           yet — input-channel sharding is future work (see ROADMAP).  The
           pricing is pinned by ``tests/test_topology.py`` so the formula
           cannot drift before it is wired in.
        """
        return self.gather(n_chips, a)

    def all_to_all(self, n_chips: int, a: int) -> int:
        """Resharding bound (e.g. channel -> row): priced at the
        all-gather bottleneck, as in the PR-3 ring model."""
        return self.allgather(n_chips, a)

    def bcast(self, n_chips: int, a: int) -> int:
        """One chip's full tensor pipelined to every chip, axis by axis."""
        ny, nx = self.grid(n_chips)
        out = 0
        if ny > 1:
            out += self._dir(a)
        if nx > 1:
            out += self._dir(a)
        return out

    # ---- single-axis collectives (hybrid row x channel sharding) ------ #

    def allgather_axis1(self, n_chips: int, a: int) -> int:
        """Each band row all-gathers its own ``a/rows`` slice along the
        kernel-channel axis; rows run in parallel."""
        ny, nx = self.grid(n_chips)
        return self._dir(self._ring_split(nx, math.ceil(a / ny)))

    def scatter_axis0(self, n_chips: int, a: int) -> int:
        """Chip 0's tensor split into band rows along the row axis."""
        ny, _ = self.grid(n_chips)
        return self._dir(self._ring_split(ny, a))

    def bcast_axis1(self, n_chips: int, a: int) -> int:
        """Each band-row head broadcasts its ``a/rows`` band along the
        kernel-channel axis; rows run in parallel."""
        ny, nx = self.grid(n_chips)
        if nx <= 1:
            return 0
        return self._dir(math.ceil(a / ny))


RING = Topology("ring")
BIRING = Topology("ring", bidirectional=True)


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """``n_chips`` identical accelerators joined by ICI links.

    Units (matching the :class:`HardwareModel` docstring above): all
    durations are accelerator cycles and all sizes are unit-less element
    counts.  ``chip`` is the per-chip platform model (its ``t_l``/``t_w``
    price HBM traffic); ``t_ici`` is the cycles to move ONE tensor element
    across one ICI link — the inter-chip counterpart of ``t_l``.  The
    duration of an ICI phase is ``bottleneck_link_elements * t_ici``
    with the bottleneck count priced by :class:`Topology` (links transfer
    in parallel — a ring halo exchange costs one boundary's elements, not
    the sum; chips do NOT overlap ICI with compute unless the planner's
    ``overlap`` discipline says so — the same conservative sequential
    accounting as the paper's Def 3).
    ``topology`` accepts ``'ring'`` (the PR-3 unidirectional default,
    bit-exact), ``'biring'``, ``'torusRxC'`` (bidirectional, v5e-style),
    or a :class:`Topology` instance; torus dims must tile ``n_chips``.
    On real hardware ``t_ici = dtype_bytes / ici_bw_per_link`` while
    ``t_l = dtype_bytes / hbm_bw``, so ``t_ici / t_l = hbm_bw /
    ici_bw_per_link`` (~16 on TPU v5e); see
    :meth:`TpuChipModel.as_cluster`.
    """

    chip: HardwareModel
    n_chips: int = 1
    t_ici: float = 0.0      # cycles to move one element across one ICI link
    topology: "Topology | str" = "ring"

    def __post_init__(self):
        if self.n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {self.n_chips}")
        if self.t_ici < 0:
            raise ValueError(f"t_ici must be >= 0, got {self.t_ici}")
        topo = Topology.parse(self.topology)
        if not topo.n_links_ok(self.n_chips):
            raise ValueError(
                f"topology {topo.describe()} does not tile "
                f"n_chips={self.n_chips}")
        object.__setattr__(self, "topology", topo)

    @property
    def topo(self) -> Topology:
        return self.topology  # normalised to a Topology in __post_init__

    def degraded(self, *, n_chips: "int | None" = None,
                 topology: "Topology | str | None" = None,
                 t_ici_factor: float = 1.0,
                 size_mem_factor: float = 1.0) -> "ClusterModel":
        """A degraded copy of this cluster (``repro_torch.resil``): fewer
        chips on a new wiring, ``t_ici_factor``x slower links, and/or a
        per-chip budget shrunk to ``floor(size_mem * size_mem_factor)``.
        Revalidates through ``__post_init__`` — the topology must tile
        the surviving chip count."""
        if t_ici_factor < 1.0:
            raise ValueError(
                f"t_ici_factor must be >= 1 (links only degrade), "
                f"got {t_ici_factor}")
        if not 0.0 < size_mem_factor <= 1.0:
            raise ValueError(
                f"size_mem_factor must be in (0, 1], got {size_mem_factor}")
        chip = self.chip
        if size_mem_factor != 1.0:
            if chip.size_mem is None:
                raise ValueError(
                    "cannot shrink an unconstrained size_mem budget")
            new_mem = int(chip.size_mem * size_mem_factor)
            if new_mem < 1:
                raise ValueError(
                    f"size_mem_factor {size_mem_factor} leaves no memory "
                    f"(size_mem={chip.size_mem})")
            chip = dataclasses.replace(chip, size_mem=new_mem)
        return ClusterModel(
            chip=chip,
            n_chips=self.n_chips if n_chips is None else n_chips,
            t_ici=self.t_ici * t_ici_factor,
            topology=self.topology if topology is None else topology)


# ---------------------------------------------------------------------------
# TPU v5e preset of the JAX package, copied unchanged so that a plan made
# here can be compared with one the reference made under the same model.
# Nothing in this package plans for it: the card's model is GpuChipModel
# below.  The paper's abstract units become bytes/seconds here.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TpuChipModel:
    """Roofline constants for the target chip (TPU v5e, per the brief)."""

    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # bytes/s
    ici_bw_per_link: float = 50e9     # bytes/s per ICI link
    vmem_bytes: int = 128 * 1024 * 1024
    mxu_dim: int = 128                # systolic array edge; align matmul dims

    def as_hardware_model(self, dtype_bytes: int = 2) -> HardwareModel:
        """Express the chip in the paper's (t_l, t_w, t_acc, nbop) terms.

        Time unit = seconds.  ``t_acc = 1s`` window gives ``nbop_pe =
        peak_flops/2`` MACs (1 MAC = 2 FLOP); loading one element costs
        ``dtype_bytes / hbm_bw`` seconds; size_mem is VMEM in elements.
        """
        t_l = dtype_bytes / self.hbm_bw
        return HardwareModel(
            nbop_pe=int(self.peak_flops / 2.0),
            size_mem=self.vmem_bytes // dtype_bytes,
            t_l=t_l, t_w=t_l, t_acc=1.0)

    def as_cluster(self, n_chips: int, dtype_bytes: int = 2) -> ClusterModel:
        """A ring of ``n_chips`` of this chip: ``t_ici`` prices one element
        over one ICI link in the same seconds unit as ``t_l``."""
        return ClusterModel(
            chip=self.as_hardware_model(dtype_bytes),
            n_chips=n_chips,
            t_ici=dtype_bytes / self.ici_bw_per_link)


TPU_V5E = TpuChipModel()


# ---------------------------------------------------------------------------
# NVIDIA H100 preset — what core.planner and kernels.emit plan against.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GpuChipModel:
    """Roofline constants of one NVIDIA GPU, in bytes and seconds.

    The on-chip memory the paper's ``size_mem`` budgets is the shared
    memory ONE thread block can use: the port's planned conv kernel keeps
    the kernel set Λ and the input window of a whole ordered sweep in one
    block's shared memory, so that, and not the card's total, is the
    budget a plan must fit.

    Every default below is a **data-sheet constant** of the H100 SXM
    (NVIDIA's H100 data sheet and the Hopper architecture white paper),
    not a measurement: 232 448 bytes of shared memory per block, 132
    streaming multiprocessors, 3.35 TB/s of device-memory bandwidth,
    989 TFLOP/s dense bf16 on the tensor cores, 450 GB/s of NVLink each
    way.  A card set below its full power limit runs below these rates.
    """

    peak_flops: float = 989e12            # dense bf16 FLOP/s, tensor cores
    hbm_bw: float = 3.35e12               # device memory, bytes/s
    nvlink_bw_per_dir: float = 450e9      # bytes/s to the other cards, one way
    smem_bytes_per_block: int = 232_448   # dynamic shared memory a block gets
    n_sms: int = 132

    def as_hardware_model(self, dtype_bytes: int = 2) -> HardwareModel:
        """The card in the paper's (t_l, t_w, t_acc, nbop, size_mem) terms.

        Time unit = seconds, as for :class:`TpuChipModel`: a ``t_acc`` of
        one second gives ``nbop_pe = peak_flops / 2`` MACs; one element
        costs ``dtype_bytes / hbm_bw`` to load or write; ``size_mem`` is
        one block's shared memory in elements of ``dtype_bytes``.
        """
        t_l = dtype_bytes / self.hbm_bw
        return HardwareModel(
            nbop_pe=int(self.peak_flops / 2.0),
            size_mem=self.smem_bytes_per_block // dtype_bytes,
            t_l=t_l, t_w=t_l, t_acc=1.0)

    def as_cluster(self, n_chips: int, dtype_bytes: int = 2) -> ClusterModel:
        """``n_chips`` cards of one host: ``t_ici`` prices one element over
        NVLink in one direction, in the same seconds unit as ``t_l``.  The
        cards are joined all to all; the default ring topology of
        :class:`ClusterModel` prices collectives conservatively for that
        wiring."""
        return ClusterModel(
            chip=self.as_hardware_model(dtype_bytes),
            n_chips=n_chips,
            t_ici=dtype_bytes / self.nvlink_bw_per_dir)


H100_SXM = GpuChipModel()
