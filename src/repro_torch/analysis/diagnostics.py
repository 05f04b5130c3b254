"""Structured diagnostics for the static plan verifier.

A ``Diagnostic`` pins one rule violation to a locus (layer / chip / step)
with a machine-readable payload; a ``VerificationReport`` aggregates them
for one verified subject.  ``report.ok`` is the contract the planners and
tests assert on: no error-severity diagnostics.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any


class Severity(enum.Enum):
    ERROR = "error"      # plan is illegal or the cost model lied
    WARNING = "warning"  # accounting is optimistic but self-consistent
    INFO = "info"        # documented approximation worth surfacing

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One rule violation at one locus.

    ``rule`` is a stable ``family/name`` identifier (e.g.
    ``mem/step-budget``); ``data`` carries the numbers behind the message
    as a sorted tuple of ``(key, value)`` pairs so diagnostics stay
    hashable and deterministic.
    """
    rule: str
    severity: Severity
    message: str
    layer: int | None = None
    chip: int | None = None
    step: int | None = None

    data: tuple[tuple[str, Any], ...] = ()

    @staticmethod
    def make(rule: str, severity: Severity, message: str, *,
             layer: int | None = None, chip: int | None = None,
             step: int | None = None, **data: Any) -> "Diagnostic":
        return Diagnostic(rule=rule, severity=severity, message=message,
                          layer=layer, chip=chip, step=step,
                          data=tuple(sorted(data.items())))

    @property
    def locus(self) -> str:
        parts = []
        if self.layer is not None:
            parts.append(f"layer {self.layer}")
        if self.chip is not None:
            parts.append(f"chip {self.chip}")
        if self.step is not None:
            parts.append(f"step {self.step}")
        return ", ".join(parts) if parts else "plan"

    def render(self) -> str:
        extra = ""
        if self.data:
            extra = " [" + ", ".join(f"{k}={v!r}" for k, v in self.data) + "]"
        return (f"{self.severity.value.upper():7s} {self.rule}: "
                f"{self.locus}: {self.message}{extra}")

    def to_json(self) -> dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": self.severity.value,
            "message": self.message,
            "layer": self.layer,
            "chip": self.chip,
            "step": self.step,
            "data": dict(self.data),
        }


@dataclasses.dataclass
class VerificationReport:
    """All diagnostics for one verified subject (a plan or a step walk)."""
    subject: str
    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)
    checked_layers: int = 0
    checked_steps: int = 0

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags: list[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.WARNING]

    @property
    def ok(self) -> bool:
        """True when no error-severity diagnostic was emitted."""
        return not self.errors

    def rules_fired(self) -> set[str]:
        return {d.rule for d in self.diagnostics}

    def render(self) -> str:
        head = (f"verify {self.subject}: "
                f"{'OK' if self.ok else 'FAIL'} "
                f"({self.checked_layers} layers, {self.checked_steps} steps, "
                f"{len(self.errors)} errors, {len(self.warnings)} warnings)")
        lines = [head] + [d.render() for d in self.diagnostics]
        return "\n".join(lines)

    def to_json(self) -> dict[str, Any]:
        return {
            "subject": self.subject,
            "ok": self.ok,
            "checked_layers": self.checked_layers,
            "checked_steps": self.checked_steps,
            "diagnostics": [d.to_json() for d in self.diagnostics],
        }

    def to_json_str(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)


class PlanVerificationError(ValueError):
    """Raised by the planners when ``verify=True`` and the emitted plan
    fails static verification — always a planner or cost-model bug."""

    def __init__(self, report: VerificationReport):
        self.report = report
        super().__init__(report.render())
