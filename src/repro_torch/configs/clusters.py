"""Cluster presets for the multi-chip planner: ICI rings (uni- and
bidirectional) and 2-D tori.

Abstract-unit clusters (``t_l = t_w = t_acc = 1`` cycle per element, the
paper's Sec-7 setting) with ``t_ici = ICI_FACTOR * t_l``.  On TPU v5e one
ICI link moves bytes ~16x slower than HBM (819 GB/s vs 50 GB/s per link,
see ``TpuChipModel``), but a chip drives 4 ICI ports, so collectives that
spread traffic across links see an *effective* per-element cost of ~4x an
HBM load — ``ICI_FACTOR = 4`` models that aggregate; pass
``ici_factor=16`` for the pessimistic single-link bound (the planner then
correctly refuses to shard small activations).  ``topology`` accepts
``'ring'`` (unidirectional, the default), ``'biring'``, ``'torusRxC'``
(bidirectional links, v5e-style) or a ``Topology`` instance;
:func:`torus_dims` picks the squarest grid for a chip count (the shape
that minimises the longer axis ring, hence the bottleneck hop count).
``TPU_V5E_RING*`` are rings in the TPU v5e's seconds/bytes units via
:meth:`TpuChipModel.as_cluster` (per-link pricing), kept as the JAX
package names them so the two cost models can be compared; nothing on
the card plans for them.
"""
from repro_torch.core.cost_model import (TPU_V5E, ClusterModel,
                                         HardwareModel, Topology)

# effective t_ici / t_l across a v5e chip's 4 ICI ports (per-link: ~16)
ICI_FACTOR = 4.0


def make_cluster(n_chips: int, *, nbop_pe: int = 10 ** 9,
                 size_mem: int | None = None, t_l: float = 1.0,
                 t_w: float = 1.0, t_acc: float = 1.0,
                 ici_factor: float = ICI_FACTOR,
                 topology: "Topology | str" = "ring") -> ClusterModel:
    """An abstract-unit ICI cluster of ``n_chips`` identical chips."""
    chip = HardwareModel(nbop_pe=nbop_pe, size_mem=size_mem,
                         t_l=t_l, t_w=t_w, t_acc=t_acc)
    return ClusterModel(chip=chip, n_chips=n_chips, t_ici=t_l * ici_factor,
                        topology=topology)


def torus_dims(n_chips: int) -> tuple[int, int] | None:
    """Squarest (rows, cols) grid for ``n_chips``; None when no 2-D grid
    exists (primes and n < 4 only offer the degenerate 1xN ring)."""
    best = None
    for ny in range(2, int(n_chips ** 0.5) + 1):
        if n_chips % ny == 0:
            best = (ny, n_chips // ny)
    return best


RING1 = make_cluster(1)
RING2 = make_cluster(2)
RING4 = make_cluster(4)
RING8 = make_cluster(8)
RINGS = {1: RING1, 2: RING2, 4: RING4, 8: RING8}

BIRING4 = make_cluster(4, topology="biring")
BIRING8 = make_cluster(8, topology="biring")
TORUS2X2 = make_cluster(4, topology="torus2x2")
TORUS2X4 = make_cluster(8, topology="torus2x4")

# the topology matrix exercised by tests and the --topology bench axis
TOPOLOGY_PRESETS = {
    "ring": RING4,
    "biring": BIRING4,
    "torus2x2": TORUS2X2,
    "torus2x4": TORUS2X4,
}

TPU_V5E_RING4 = TPU_V5E.as_cluster(4)
TPU_V5E_RING8 = TPU_V5E.as_cluster(8)
