# Port of repro/analysis/__main__.py: the audited hierarchy lives on the card (or the CPU when asked).
"""``python -m repro_torch.analysis`` — run the communication audit and the
lint, and exit 1 on any violation.

The audit lowers a small Laplace hierarchy onto a (pods × lanes) rank grid
on the card and audits every solve program — V/W/F × the five smoothers, the
single-RHS programs and their ``*_m`` twins, each captured as a CUDA graph
and read from its replay — plus every per-level operator apply with the
poisoned-halo overlap check, and the setup-phase SpGEMM exchanges of two
partitioned setups (a plain one and an aggressive-coarsening one, the
latter exercising the distance-2 ``S²`` exchange; host numpy).
``--device cpu`` runs the same audit on the CPU, where each program call
runs its body.  The lint covers ``src/repro_torch``.

``--json report.json`` writes the machine-readable report; ``--lint-only``
skips the audit.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def run_comm_audit(n: int, pods: int, lanes: int, device: str):
    """Build + audit; returns (audits, violations, setup_rows, meta)."""
    import torch

    from ..amg.dist_setup import dist_setup_partitioned
    from ..amg.dist_solve import DistHierarchy
    from ..amg.hierarchy import setup
    from ..amg.problems import laplace_3d
    from .comm_audit import audit_hierarchy, audit_setup
    from .records import AuditViolation

    A = laplace_3d(n)
    h = setup(A, solver="rs", max_coarse=30)   # >= 3 levels: W/F revisit
    dh = DistHierarchy.build(h, pods, lanes, dtype=torch.float64,
                             device=device)
    audits, violations = audit_hierarchy(dh)

    setup_rows = []
    for plv, recs in (dist_setup_partitioned(A, pods, lanes, max_coarse=30),
                      dist_setup_partitioned(laplace_3d(6), pods, lanes,
                                             aggressive=True)):
        rows, svio = audit_setup(plv, recs)
        setup_rows += rows
        violations += svio
    if not any(r["op"] == "spgemm_S2" for r in setup_rows):
        violations.append(AuditViolation(
            "missing-record", "aggressive setup ran but no spgemm_S2 "
            "exchange was audited", program="dist_setup"))
    meta = {"n": n, "pods": pods, "lanes": lanes, "levels": len(dh.levels),
            "torch": torch.__version__, "device": str(dh.device),
            "device_name": (torch.cuda.get_device_name(dh.device)
                            if dh.device.type == "cuda" else "cpu"),
            "graphs_captured": sum(dh.programs.captures.values()),
            "overlap": dh.overlap, "reduce_strategy": dh.reduce_strategy,
            "setup_exchanges_audited": len(setup_rows)}
    return audits, violations, setup_rows, meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="communication audit + repo-invariant lint of the port")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable JSON report here")
    ap.add_argument("--lint-only", action="store_true",
                    help="skip the communication audit")
    ap.add_argument("--n", type=int, default=8,
                    help="Laplace grid edge for the audited hierarchy")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the captured graphs) or cpu")
    args = ap.parse_args(argv)

    from .lint import lint_paths
    from .report import build_report, format_summary, write_report

    lint_violations = lint_paths(Path(__file__).resolve().parents[1])
    audits, violations, setup_rows, meta = [], [], [], {}
    if not args.lint_only:
        audits, violations, setup_rows, meta = run_comm_audit(
            args.n, args.pods, args.lanes, args.device)
    report = build_report(audits=audits, audit_violations=violations,
                          lint_violations=lint_violations,
                          setup_rows=setup_rows, meta=meta)
    if args.json:
        write_report(report, args.json)
    print(format_summary(report))
    return 0 if report["summary"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
