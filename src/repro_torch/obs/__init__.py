"""Observability of the port: for now the planner metrics registry only
(:mod:`repro_torch.obs.metrics`), which ``core.network_planner`` and
``core.multichip`` import lazily."""
from repro_torch.obs.metrics import MetricsRegistry, REGISTRY

__all__ = ["MetricsRegistry", "REGISTRY"]
