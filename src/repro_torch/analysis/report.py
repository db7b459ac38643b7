# Port of repro/analysis/report.py: no byte column (the port's logs carry no payload bytes).
"""Machine-readable report assembly for ``python -m repro_torch.analysis``.

One JSON document per run: the comm-audit records (per-program collective
counts vs the model's predicted counts), the setup-phase static-vs-measured
rows, every violation from both passes, and a pass/fail verdict.
"""
from __future__ import annotations

import json
from pathlib import Path


def build_report(*, audits=(), audit_violations=(), lint_violations=(),
                 setup_rows=(), meta: dict | None = None) -> dict:
    audits = list(audits)
    audit_violations = list(audit_violations)
    lint_violations = list(lint_violations)
    return {
        "meta": dict(meta or {}),
        "summary": {
            "programs_audited": len(audits),
            "collectives_seen": sum(a.n_collectives for a in audits),
            "audit_violations": len(audit_violations),
            "lint_violations": len(lint_violations),
            "ok": not audit_violations and not lint_violations,
        },
        "comm_audit": [a.to_dict() for a in audits],
        "setup_audit": list(setup_rows),
        "audit_violations": [v.to_dict() for v in audit_violations],
        "lint": [v.to_dict() for v in lint_violations],
    }


def write_report(report: dict, path: str | Path) -> None:
    Path(path).write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")


def format_summary(report: dict) -> str:
    """Human-readable tail: the per-program collective-count table (logged
    vs model-predicted) plus every violation, one per line."""
    out = []
    rows = report["comm_audit"]
    if rows:
        out.append(f"{'program':<36s} {'where':<8s} {'collectives':>11s}  "
                   f"counts (logged | expected)")
        for a in rows:
            where = ""
            if a["level"] is not None:
                where = f"L{a['level']}.{a['op']}"
            counts = " ".join(f"{p}={c}" for p, c in sorted(a["counts"].items()))
            exp = ("(unchecked)" if a["expected"] is None else " ".join(
                f"{p}={c}" for p, c in sorted(a["expected"].items())) or "none")
            mark = "" if a["ok"] else "  <-- VIOLATION"
            out.append(f"{a['program']:<36s} {where:<8s} "
                       f"{a['n_collectives']:>11d}  "
                       f"{counts or 'none'} | {exp}{mark}")
    for r in report["setup_audit"]:
        out.append(f"setup L{r['level']} {r['op']:<12s} {r['strategy']:<9s} "
                   f"inter {r['runtime_inter_msgs']}/{r['static_inter_msgs']} "
                   f"intra {r['runtime_intra_msgs']}/{r['static_intra_msgs']} "
                   f"msgs (measured/static)")
    for v in report["audit_violations"]:
        out.append(f"AUDIT  [{v['kind']}] {v['program']}: {v['message']}")
    for v in report["lint"]:
        out.append(f"LINT   {v['path']}:{v['line']}: [{v['rule']}] "
                   f"{v['message']}")
    s = report["summary"]
    out.append(f"analysis: {s['programs_audited']} programs, "
               f"{s['collectives_seen']} collectives, "
               f"{s['audit_violations']} audit + {s['lint_violations']} lint "
               f"violations -> {'OK' if s['ok'] else 'FAIL'}")
    return "\n".join(out)
