"""Static analysis of the port (counterpart of :mod:`repro.analysis`): the
communication audit over the solve programs' collective logs
(:mod:`~repro_torch.analysis.comm_audit`; on the card the logs the captured
CUDA graphs replay), the setup-phase audit of the partitioned setup's
measured SpGEMM exchange counters, and the ``ast``-based repo-invariant lint
(:mod:`~repro_torch.analysis.lint`).

Run both with ``python -m repro_torch.analysis [--json report.json]
[--device cpu]``.
"""
from .comm_audit import (PORTED_SMOOTHERS, PROGRAM_NAMES, audit_apply,
                         audit_captured, audit_cycle_stats, audit_hierarchy,
                         audit_log, audit_program, audit_setup, audit_solve)
from .lint import lint_paths, lint_source
from .log_walk import (OverlapCheck, check_overlap_independence,
                       collect_collectives, collective_signature)
from .records import AuditViolation, CollectiveRecord, CommAudit, LintViolation
from .report import build_report, format_summary, write_report

__all__ = [
    "PORTED_SMOOTHERS", "PROGRAM_NAMES", "AuditViolation", "CollectiveRecord",
    "CommAudit", "LintViolation", "OverlapCheck", "audit_apply",
    "audit_captured", "audit_cycle_stats", "audit_hierarchy", "audit_log",
    "audit_program", "audit_setup", "audit_solve", "build_report",
    "check_overlap_independence", "collect_collectives",
    "collective_signature", "format_summary", "lint_paths", "lint_source",
    "write_report",
]
