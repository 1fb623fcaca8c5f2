"""Audit result records (reference: ``repro.analysis.violations``).

The port's own copy of the reference's plain-data records: ``Severity``,
``CheckResult`` and ``AuditReport``, each with ``to_dict``, so the
``--json`` output and the tests read one machine-readable shape.  (The
reference's lint records are not copied: its AST lint already covers
``src/repro_torch/``.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List


class Severity:
    """Severity levels (plain strings, ordered ERROR > WARNING)."""

    ERROR = "error"
    WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """One auditor assertion over an audited call."""

    check_id: str
    ok: bool
    expected: Any
    actual: Any
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready mapping."""
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        """Single-line pass/fail summary."""
        mark = "ok" if self.ok else "FAIL"
        return (f"[{mark}] {self.check_id}: expected {self.expected!r}, "
                f"actual {self.actual!r}"
                + (f" ({self.detail})" if self.detail else ""))


@dataclasses.dataclass
class AuditReport:
    """All checks run against one audited entry point."""

    target: str
    checks: List[CheckResult] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        """True iff every check passed."""
        return all(c.ok for c in self.checks)

    def failures(self) -> List[CheckResult]:
        """The failing checks only."""
        return [c for c in self.checks if not c.ok]

    def check(self, check_id: str) -> CheckResult:
        """The check named ``check_id``."""
        return {c.check_id: c for c in self.checks}[check_id]

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready mapping."""
        return {"target": self.target, "ok": self.ok,
                "checks": [c.to_dict() for c in self.checks]}
