"""Observability of the port: the shared timeline-event model
(:mod:`repro_torch.obs.events`: spans on per-chip lanes, counters, the
Def-3 step decomposition), which ``sim.trace`` builds on, and the planner
metrics registry (:mod:`repro_torch.obs.metrics`), which
``core.network_planner`` and ``core.multichip`` import lazily.  The
package root imports only these two leaves, neither of which imports
``core``'s dependents."""
from repro_torch.obs.events import (CounterSample, LANES, Span, StepLanes,
                                    Timeline, decompose_step)
from repro_torch.obs.metrics import MetricsRegistry, REGISTRY

__all__ = [
    "CounterSample", "LANES", "MetricsRegistry", "REGISTRY", "Span",
    "StepLanes", "Timeline", "decompose_step",
]
