# Port of repro/analysis/records.py: the jaxpr-only fields (axes, avals, bytes) are dropped.
"""Typed records of the static-analysis subsystem.

The communication audit (:mod:`repro_torch.analysis.comm_audit`) produces
:class:`CommAudit` records — one per audited apply or program call, listing
every collective step its log holds as a :class:`CollectiveRecord` — and
collects an :class:`AuditViolation` for every mismatch against the
structure the selected strategies predict.  The lint
(:mod:`repro_torch.analysis.lint`) produces :class:`LintViolation` rows.
Everything is JSON-serializable via ``to_dict`` for the report
``python -m repro_torch.analysis --json`` writes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective step of a collective log.

    ``primitive`` is the canonical name the step logged (``psum`` /
    ``psum_scatter`` / ``all_gather`` / ``all_to_all``); ``index`` is its
    position in the log; ``level``/``op`` pin the hierarchy operator when
    the log is one apply's.
    """

    primitive: str
    index: int
    level: int | None = None
    op: str | None = None

    def to_dict(self) -> dict:
        return {"primitive": self.primitive, "index": self.index,
                "level": self.level, "op": self.op}


class AuditViolation(Exception):
    """A mismatch between a program's logged collectives and the structure
    the selected strategies predict.

    Typed (``kind``) and attributed: ``program`` names the audited program
    or apply, ``level``/``op`` pin the hierarchy operator when the audit
    runs per operator, and ``eqn`` carries the offending
    :class:`CollectiveRecord` (or its repr) when one step is identifiable.
    """

    def __init__(self, kind: str, message: str, *, program: str | None = None,
                 level: int | None = None, op: str | None = None,
                 eqn: object | None = None):
        where = program or ""
        if level is not None:
            where += f" L{level}"
        if op is not None:
            where += f".{op}"
        super().__init__(f"[{kind}] {where.strip()}: {message}"
                         if where.strip() else f"[{kind}] {message}")
        self.kind = kind
        self.message = message
        self.program = program
        self.level = level
        self.op = op
        self.eqn = eqn

    def to_dict(self) -> dict:
        eqn = self.eqn
        if isinstance(eqn, CollectiveRecord):
            eqn = eqn.to_dict()
        elif eqn is not None:
            eqn = str(eqn)
        return {"kind": self.kind, "message": self.message,
                "program": self.program, "level": self.level,
                "op": self.op, "eqn": eqn}


@dataclasses.dataclass
class CommAudit:
    """The audit record of one collective log: every step found, the
    per-primitive counts, the expected counts (when an expectation applies)
    and any violations raised while checking them."""

    program: str
    records: list[CollectiveRecord]
    counts: dict[str, int]
    expected: dict[str, int] | None = None
    level: int | None = None
    op: str | None = None
    violations: list[AuditViolation] = dataclasses.field(default_factory=list)

    @property
    def n_collectives(self) -> int:
        return len(self.records)

    @property
    def ok(self) -> bool:
        return not self.violations

    def signature(self) -> tuple[str, ...]:
        """Ordered canonical primitive names, as logged."""
        return tuple(r.primitive for r in self.records)

    def to_dict(self) -> dict:
        return {"program": self.program, "level": self.level, "op": self.op,
                "counts": dict(self.counts),
                "expected": None if self.expected is None
                else dict(self.expected),
                "n_collectives": self.n_collectives,
                "ok": self.ok,
                "violations": [v.to_dict() for v in self.violations],
                "records": [r.to_dict() for r in self.records]}


@dataclasses.dataclass(frozen=True)
class LintViolation:
    """One rule violation in one source file."""

    rule: str
    path: str
    line: int
    message: str

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"
