"""Surviving-topology selection and cluster repricing.

On a chip death the fabric the planner priced no longer exists: a
``torus2x2`` with a dead corner is not a torus.  The degradation rules
pick the best *feasible* wiring for the survivors, conservatively — the
degraded cluster must never be priced better-connected than the physical
links that actually remain:

* a torus keeps a (smaller) torus only when the survivor count tiles a
  2-D grid with both axes >= 2 (``configs.clusters.torus_dims``);
  otherwise it falls back to a ring over the surviving chips, keeping
  the link direction (a bidirectional torus degrades to a bidirectional
  ring — its links were bidirectional to begin with);
* a ring stays a ring (one fewer chip; the fleet reroutes around the
  dead hop), keeping its direction;
* one survivor is a valid 1-ring (every collective prices to zero).

Link degradation and VMEM shrink reprice without rewiring:
``ClusterModel.degraded`` scales ``t_ici`` / ``size_mem`` and
revalidates the result.
"""
from __future__ import annotations

from repro_torch.configs.clusters import torus_dims
from repro_torch.core.cost_model import ClusterModel, Topology
from repro_torch.resil.faults import ClusterExhaustedError


def surviving_topology(topo: Topology, n_survivors: int) -> Topology:
    """The best feasible wiring for ``n_survivors`` chips of a cluster
    that was wired as ``topo`` (see the module note for the rules)."""
    if n_survivors < 1:
        raise ClusterExhaustedError("no surviving chips to wire")
    bidir = topo.bidirectional
    if topo.kind == "torus" and n_survivors >= 4:
        dims = torus_dims(n_survivors)
        if dims is not None:
            return Topology("torus", dims, bidirectional=bidir)
    return Topology("ring", bidirectional=bidir)


def surviving_cluster(cluster: ClusterModel, n_dead: int = 1,
                      ) -> ClusterModel:
    """The cluster after ``n_dead`` chips died: fewer chips on the best
    feasible surviving wiring, same chips and link speed otherwise."""
    n_surv = cluster.n_chips - n_dead
    if n_surv < 1:
        raise ClusterExhaustedError(
            f"{n_dead} dead of {cluster.n_chips} chips — nothing left "
            f"to re-plan on")
    return cluster.degraded(
        n_chips=n_surv,
        topology=surviving_topology(cluster.topo, n_surv))


def repriced_cluster(cluster: ClusterModel, ici_factor: float,
                     ) -> ClusterModel:
    """Every ICI link ``ici_factor``x slower, wiring unchanged."""
    return cluster.degraded(t_ici_factor=ici_factor)


def shrunk_cluster(cluster: ClusterModel, mem_factor: float,
                   ) -> ClusterModel:
    """Per-chip budget shrunk to ``floor(size_mem * mem_factor)``."""
    return cluster.degraded(size_mem_factor=mem_factor)
