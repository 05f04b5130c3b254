"""Fault injection and layer-granular recovery (``repro_torch.resil``).

The planner/simulator stack assumes a perfect machine.  This
package extends the Def-3 predictability discipline to the failure
cases a real fleet hits: a seeded deterministic :class:`FaultSchedule`
(chip death, ICI link degradation, VMEM budget shrink, transient DMA
failures) is injected into the functional cluster simulation, the
surviving topology is re-planned mid-network (warm-started from the
shared ``solve_cached`` LRU, verified by ``repro_torch.analysis.verifier``),
and recovery is layer-granular: committed write-backs are the recovery
points, only in-flight work is recomputed, and the stitched outputs are
proved exactly-once and equal to the fault-free reference convolution.

Entry points: :func:`repro_torch.resil.engine.run_faulted` and the CLI
``python -m repro_torch.resil.faultsim``.
"""
from repro_torch.resil.faults import (ChipDeath, ClusterExhaustedError,
                                      DegradedInfeasibleError, DmaTransient,
                                      FaultError, FaultEvent, FaultSchedule,
                                      LinkDegrade, RecoveryCorruptionError,
                                      VmemShrink)

__all__ = [
    "ChipDeath",
    "ClusterExhaustedError",
    "DegradedInfeasibleError",
    "DmaTransient",
    "FaultError",
    "FaultEvent",
    "FaultSchedule",
    "LinkDegrade",
    "RecoveryCorruptionError",
    "VmemShrink",
]
