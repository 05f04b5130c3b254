"""Chrome-trace / Perfetto JSON export with a pinned schema.

``to_chrome_trace`` maps timelines onto the Trace Event Format that both
``chrome://tracing`` and https://ui.perfetto.dev load directly:

* process (``pid``)  = one (timeline label, chip) pair, named via ``M``
  (metadata) events — e.g. ``predicted · chip0``;
* thread  (``tid``)  = one lane per process, in ``LANES`` order;
* ``X`` (complete) events = spans, with Def-3 step attribution in
  ``args`` (layer, step, elements);
* ``C`` (counter) events = counters (VMEM occupancy, cumulative traffic).

Timestamps are emitted in microseconds-as-cycles: one Def-3 cycle is one
``ts`` unit, so Perfetto's time axis reads directly in model cycles.

``TRACE_SCHEMA`` is the *pinned* contract for the exported document —
tests validate every export against it, and ``validate_chrome_trace``
additionally enforces the per-phase requirements a generic JSON-schema
walk cannot express (``X`` needs ``ts``/``dur``/``tid``, ``C`` needs
``args``, ``M`` names must be known metadata keys).  The validator is
hand-rolled (subset of JSON Schema: ``type`` / ``required`` /
``properties`` / ``items`` / ``enum`` / ``minimum``) because the repo
deliberately carries no jsonschema dependency.
"""
from __future__ import annotations

import json
from typing import Any, Sequence

from repro_torch.obs.events import LANES, Timeline

#: Pinned JSON-schema subset for the exported trace document.
TRACE_SCHEMA: dict = {
    "type": "object",
    "required": ["traceEvents", "displayTimeUnit", "otherData"],
    "properties": {
        "displayTimeUnit": {"type": "string", "enum": ["ms", "ns"]},
        "otherData": {
            "type": "object",
            "required": ["generator", "cycle_unit"],
            "properties": {
                "generator": {"type": "string"},
                "cycle_unit": {"type": "string"},
            },
        },
        "traceEvents": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["ph", "pid", "name"],
                "properties": {
                    "ph": {"type": "string", "enum": ["X", "C", "M"]},
                    "name": {"type": "string"},
                    "cat": {"type": "string"},
                    "pid": {"type": "integer", "minimum": 0},
                    "tid": {"type": "integer", "minimum": 0},
                    "ts": {"type": "number", "minimum": 0},
                    "dur": {"type": "number", "minimum": 0},
                    "args": {"type": "object"},
                },
            },
        },
    },
}

_METADATA_NAMES = ("process_name", "process_sort_index", "thread_name",
                   "thread_sort_index")
_COUNTER_TID = len(LANES)


def _jsonable(value: Any) -> Any:
    """Span attrs may carry bitmask ints, tuples, etc. — keep JSON tame
    (huge masks become bit counts; tuples become lists)."""
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, int):
        return value if value.bit_length() <= 53 else \
            {"bit_count": value.bit_count()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, float):
        return value
    return str(value)


def to_chrome_trace(timelines: Sequence[Timeline]) -> dict:
    """Export timelines to one Chrome-trace document (see module note)."""
    events: list[dict] = []
    pids: dict[tuple[str, int], int] = {}
    for tl in timelines:
        for chip in tl.chips():
            pid = pids.setdefault((tl.label, chip), len(pids) + 1)
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "args": {"name": f"{tl.label} · chip{chip}"}})
            events.append({"ph": "M", "name": "process_sort_index",
                           "pid": pid, "args": {"sort_index": pid}})
            for tid, lane in enumerate(LANES):
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": lane}})
                events.append({"ph": "M", "name": "thread_sort_index",
                               "pid": pid, "tid": tid,
                               "args": {"sort_index": tid}})
    for tl in timelines:
        for s in tl.spans:
            pid = pids[(tl.label, s.chip)]
            args: dict[str, Any] = {}
            if s.layer is not None:
                args["layer"] = s.layer
            if s.step is not None:
                args["step"] = s.step
            if s.elements:
                args["elements"] = s.elements
            for k, v in s.attrs.items():
                args[k] = _jsonable(v)
            events.append({"ph": "X", "name": s.name, "cat": s.lane,
                           "pid": pid, "tid": LANES.index(s.lane),
                           "ts": s.t0, "dur": s.dur, "args": args})
        for c in tl.counters:
            pid = pids[(tl.label, c.chip)]
            events.append({"ph": "C", "name": c.name, "pid": pid,
                           "tid": _COUNTER_TID, "ts": c.t,
                           "args": {c.name: c.value}})
    return {
        "displayTimeUnit": "ms",
        "otherData": {"generator": "repro.obs",
                      "cycle_unit": "1 ts == 1 Def-3 cycle"},
        "traceEvents": events,
    }


# --------------------------------------------------------------------- #
# Validation
# --------------------------------------------------------------------- #

def _check(value: Any, schema: dict, path: str, errors: list[str]) -> None:
    t = schema.get("type")
    if t == "object":
        if not isinstance(value, dict):
            errors.append(f"{path}: expected object, got "
                          f"{type(value).__name__}")
            return
        for req in schema.get("required", ()):
            if req not in value:
                errors.append(f"{path}: missing required key {req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in value:
                _check(value[key], sub, f"{path}.{key}", errors)
    elif t == "array":
        if not isinstance(value, list):
            errors.append(f"{path}: expected array, got "
                          f"{type(value).__name__}")
            return
        sub = schema.get("items")
        if sub:
            for i, item in enumerate(value):
                _check(item, sub, f"{path}[{i}]", errors)
    elif t == "string":
        if not isinstance(value, str):
            errors.append(f"{path}: expected string, got "
                          f"{type(value).__name__}")
            return
        enum = schema.get("enum")
        if enum is not None and value not in enum:
            errors.append(f"{path}: {value!r} not in {enum}")
    elif t in ("integer", "number"):
        ok = isinstance(value, int) and not isinstance(value, bool) \
            if t == "integer" else (isinstance(value, (int, float))
                                    and not isinstance(value, bool))
        if not ok:
            errors.append(f"{path}: expected {t}, got "
                          f"{type(value).__name__}")
            return
        lo = schema.get("minimum")
        if lo is not None and value < lo:
            errors.append(f"{path}: {value} < minimum {lo}")


def validate_chrome_trace(trace: Any) -> list[str]:
    """All schema violations in ``trace`` (empty list == valid).

    Beyond the :data:`TRACE_SCHEMA` walk, the per-phase requirements:
    ``X`` events need ``ts``/``dur``/``tid``; ``C`` events need ``ts``
    and a non-empty ``args``; ``M`` names must be known metadata keys.
    """
    errors: list[str] = []
    _check(trace, TRACE_SCHEMA, "$", errors)
    if errors:
        return errors
    for i, ev in enumerate(trace["traceEvents"]):
        path = f"$.traceEvents[{i}]"
        ph = ev.get("ph")
        if ph == "X":
            for key in ("ts", "dur", "tid"):
                if key not in ev:
                    errors.append(f"{path}: X event missing {key!r}")
            if ev.get("cat") not in LANES:
                errors.append(f"{path}: X event cat {ev.get('cat')!r} "
                              f"is not a lane {LANES}")
        elif ph == "C":
            if "ts" not in ev:
                errors.append(f"{path}: C event missing 'ts'")
            if not ev.get("args"):
                errors.append(f"{path}: C event needs a non-empty args")
        elif ph == "M":
            if ev["name"] not in _METADATA_NAMES:
                errors.append(f"{path}: unknown metadata event "
                              f"{ev['name']!r}")
    return errors


def write_chrome_trace(trace: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
        f.write("\n")
