"""Unified offload timeline: structured trace events, Perfetto export,
and predicted-vs-simulated-vs-kernel drift attribution.

Every producer of durations in the port — the planner's Def-3 step
ledgers (``core.network_planner`` / ``core.multichip``), the functional
simulators (``sim.system`` / ``sim.s2`` / ``sim.multichip``), and the
statically traced planned conv kernel (``analysis.kerncheck``) — is
adapted onto ONE shared event model (:mod:`repro_torch.obs.events`):
spans on per-chip lanes (``dma_in`` / ``compute`` / ``write_back`` /
``ici``, plus ``fault`` / ``recovery`` for fault-injected runs),
counters, and attributes keyed to Def-3 steps.  From there:

* :mod:`repro_torch.obs.chrome`  — Chrome-trace / Perfetto JSON export
  with a pinned schema and validator;
* :mod:`repro_torch.obs.adapters` — plan / simulator / kernel-trace
  builders;
* :mod:`repro_torch.obs.metrics` — the planner metrics registry;
* :mod:`repro_torch.obs.spans`   — host spans on the real clock inside
  ``EmittedConv.run`` and a decode step's replay, recorded only while a
  ``torch.profiler`` session is on;
* :mod:`repro_torch.obs.report`  — ``python -m repro_torch.obs.report``:
  walks the predicted, simulated and kernel-traced timelines of one
  network and attributes any divergence to a specific (layer, chip,
  lane, step).

Only the dependency-light leaves are imported eagerly here; adapters and
the report pull in ``sim``/``analysis`` and must be imported explicitly
(``core`` imports :mod:`repro_torch.obs.metrics` lazily, so the package
root must never import anything that imports ``core``'s dependents).
"""
from repro_torch.obs.events import (CounterSample, LANES, Span, StepLanes,
                                    Timeline, decompose_step)
from repro_torch.obs.metrics import MetricsRegistry, REGISTRY
from repro_torch.obs.spans import HostSpan, SpanRecorder, SpanSnapshot

__all__ = [
    "CounterSample", "HostSpan", "LANES", "MetricsRegistry", "REGISTRY",
    "Span", "SpanRecorder", "SpanSnapshot", "StepLanes", "Timeline",
    "decompose_step",
]
