"""Planner metrics registry.

Absorbs the ad-hoc ``time.perf_counter()`` bookkeeping that used to live
inline in ``benchmarks.network_plan`` (stage wall-clocks) and gives
``core.network_planner`` structured instrumentation hooks (imported
*lazily* there — ``core`` must never depend on ``obs`` at module level).

Keys are ``/``-separated paths; :meth:`MetricsRegistry.snapshot` nests
them into plain dicts for JSON emission.  Timers *accumulate* across
``with`` blocks, so per-call instrumentation (every ``plan_network``
invocation) rolls up into per-stage totals for free.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator


class MetricsRegistry:
    """Accumulating counters/gauges/timers keyed by ``a/b/c`` paths."""

    def __init__(self) -> None:
        self._values: dict[str, float] = {}

    def clear(self) -> None:
        self._values.clear()

    def set(self, key: str, value: float) -> None:
        self._values[key] = value

    def incr(self, key: str, by: float = 1) -> None:
        self._values[key] = self._values.get(key, 0) + by

    def get(self, key: str, default: float = 0.0) -> float:
        return self._values.get(key, default)

    @contextlib.contextmanager
    def timer(self, key: str) -> Iterator[None]:
        """Accumulate wall-clock seconds under ``key``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.incr(key, time.perf_counter() - t0)

    def keys(self) -> list[str]:
        return sorted(self._values)

    def snapshot(self, prefix: str = "", round_to: int | None = 4) -> dict:
        """Nested-dict view of every key under ``prefix``."""
        out: dict = {}
        for key in self.keys():
            if prefix and not key.startswith(prefix + "/") \
                    and key != prefix:
                continue
            rel = key[len(prefix) + 1:] if prefix else key
            parts = rel.split("/") if rel else [key.rsplit("/", 1)[-1]]
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            v = self._values[key]
            if round_to is not None and isinstance(v, float):
                v = round(v, round_to)
            node[parts[-1]] = v
        return out


#: The process-wide default registry — what the planner hooks and the
#: benchmark's ``--profile`` emission share.
REGISTRY = MetricsRegistry()
