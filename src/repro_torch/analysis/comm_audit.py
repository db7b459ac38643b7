# Port of repro/analysis/comm_audit.py: it audits collective logs; audit_setup is a numpy copy.
"""The communication audit.

Reads the collective log of every program a
:class:`~repro_torch.amg.dist_solve.DistHierarchy` runs — the ten programs
(``resid_norm``, ``cycle``, ``vcycle``, ``pcg_init``, ``pcg_step`` and their
``*_m`` multi-RHS twins) for every ported (cycle, smoother) pair — plus
every per-level operator apply, and cross-checks them against:

* the selected strategy's predicted structure (the signature tables of
  :mod:`repro_torch.core.nap_collectives`): one apply must log exactly its
  operator's ordered halo signature, an empty-halo level none, and one
  program call the counts of
  :meth:`~repro_torch.amg.dist_solve.DistHierarchy.expected_collectives`;
* the overlap property — with ``overlap=True`` the ``A_on`` product must not
  depend on the halo exchange (a poisoned-halo run,
  :func:`~repro_torch.analysis.log_walk.check_overlap_independence`);
* :func:`~repro_torch.amg.dist_solve.cycle_comm_stats`' modeled counters — a
  level/op the model says communicates must have a non-empty plan, and vice
  versa;
* the setup-phase SpGEMM exchanges (:func:`audit_setup`) — the *measured*
  message/byte counters each
  :class:`~repro_torch.amg.dist_setup.SetupCommRecord` carries must equal
  the static :class:`~repro_torch.core.schedules.ScheduleStats` of the
  schedule that was selected and cached for replay.

On the CPU a program call runs its body and logs each step.  On the card it
is a replay of the program's captured CUDA graph, which logs what the
capture recorded, so the audit reads exactly what every replay adds.  The
setup exchanges run on the host, so their audit reads the counters the
exchange measured.  With one process per rank (``ranks="process"``) each
process audits its own log against the same counts, and
:func:`rank_traffic` reports the elements it sent over its slow and fast
groups beside :func:`~repro_torch.amg.dist_solve.cycle_comm_stats`' modeled
messages (reported, not compared: a padded all-to-all chunk is not one of
the model's messages).

Any mismatch is a typed :class:`~repro_torch.analysis.records.AuditViolation`
with the offending step and level/op attribution.
"""
from __future__ import annotations

import math
from collections import Counter

import torch

from ..amg.programs import PROGRAMS
from ..amg.solve import CYCLES, SMOOTHERS, SolveOptions
from .log_walk import check_overlap_independence, collect_collectives
from .records import AuditViolation, CommAudit

#: the ten programs of one hierarchy (single-RHS + ``*_m``)
PROGRAM_NAMES = PROGRAMS
#: the smoothers the port runs: all five of the reference's
PORTED_SMOOTHERS = SMOOTHERS


def _counts(records) -> dict[str, int]:
    return dict(Counter(r.primitive for r in records))


def audit_log(log, program: str, *,
              expected_signature: tuple[str, ...] | None = None,
              expected_counts: dict[str, int] | None = None,
              overlap=None,
              level: int | None = None, op: str | None = None) -> CommAudit:
    """Audit one collective log against an expected structure.

    ``expected_signature`` checks the *ordered* sequence (one apply: the
    exact strategy lowering); ``expected_counts`` checks per-primitive
    totals (one program call, where many applies interleave).  ``overlap``
    (an :class:`~repro_torch.analysis.log_walk.OverlapCheck`) adds its
    verdict.
    """
    records = collect_collectives(log, level=level, op=op)
    audit = CommAudit(program=program, records=records,
                      counts=_counts(records), level=level, op=op)
    sig = audit.signature()
    if expected_signature is not None:
        audit.expected = dict(Counter(expected_signature))
        if sig != tuple(expected_signature):
            eqn = next((r for r in records
                        if r.primitive not in expected_signature),
                       records[0] if records else None)
            kind = ("empty-halo-collective" if not expected_signature
                    else "signature-mismatch")
            audit.violations.append(AuditViolation(
                kind,
                f"logged collectives {list(sig)} != expected "
                f"{list(expected_signature)}",
                program=program, level=level, op=op, eqn=eqn))
    if expected_counts is not None:
        audit.expected = {k: v for k, v in expected_counts.items() if v}
        actual = audit.counts
        if audit.expected != {k: v for k, v in actual.items() if v}:
            prims = sorted(set(audit.expected) | set(actual))
            diff = "; ".join(
                f"{p}: expected {audit.expected.get(p, 0)}, "
                f"got {actual.get(p, 0)}"
                for p in prims
                if audit.expected.get(p, 0) != actual.get(p, 0))
            surplus = next(
                (r for r in records
                 if actual.get(r.primitive, 0)
                 > audit.expected.get(r.primitive, 0)), None)
            audit.violations.append(AuditViolation(
                "count-mismatch", diff, program=program, level=level, op=op,
                eqn=surplus))
    if overlap is not None and not overlap.ok:
        audit.violations.append(AuditViolation(
            "overlap-serialized",
            f"no local contraction is independent of the halo exchange "
            f"(per contraction unchanged {list(overlap.unchanged)}, "
            f"poisoned {list(overlap.poisoned)}) — the overlapped apply has "
            f"been serialized",
            program=program, level=level, op=op))
    return audit


def audit_apply(dh, level: int, op: str = "A",
                overlap: bool | None = None) -> CommAudit:
    """Per-operator audit: one apply of ``levels[level].<op>`` must log
    exactly the selected strategy's ordered halo signature (empty for an
    empty-halo plan) and — when overlapped — keep the on-process product
    independent of the exchange (poisoned-halo run on a ones vector)."""
    overlap = dh.overlap if overlap is None else overlap
    log = dh.trace_apply(level, op, overlap=overlap)
    check = None
    if overlap:
        dop = getattr(dh.levels[level], op)
        x = torch.ones((dh.local_ranks, dop.plan.local_n),
                       dtype=dh.dtype, device=dh.device)
        with dh.lock:
            check = check_overlap_independence(
                dop, dh._arrs[level][op], x, use_kernel=dh.use_kernel,
                side=dh._side, ranks=dh.ranks)
    return audit_log(log, f"apply_{op}",
                     expected_signature=dh.expected_apply_signature(level, op),
                     overlap=check, level=level, op=op)


def audit_program(dh, name: str, opts=None, k: int = 2,
                  label: str | None = None) -> CommAudit:
    """Program audit: the per-primitive counts of one call of ``name``
    (:meth:`~repro_torch.amg.dist_solve.DistHierarchy.trace_program`: a replay
    on the card) must equal the counts the cycle structure and the selected
    strategies predict.  ``label`` overrides the record's program name
    (e.g. ``vcycle[W+chebyshev]``)."""
    log = dh.trace_program(name, opts, k=k)
    return audit_log(log, label or name,
                     expected_counts=dh.expected_collectives(opts, name))


def audit_captured(dh) -> list[CommAudit]:
    """Audit every program of ``dh.programs`` as it stands: on the card the
    log its capture recorded, which every replay adds to ``comm_log``; on
    the CPU (no capture) one call's log."""
    audits = []
    for prog in dh.programs.values():
        key = prog.key
        label = f"{key.name}[{key.cycle}+{key.smoother}, k={key.k}]"
        if prog.graph is None:
            log = dh.trace_program(key.name, prog.opts, k=key.k)
        else:
            log = prog.comm
        audits.append(audit_log(
            log, label,
            expected_counts=dh.expected_collectives(prog.opts, key.name)))
    return audits


def audit_solve(dh, log, calls: dict[str, int], opts=None,
                label: str = "solve") -> CommAudit:
    """A whole solve's ``comm_log``: it must be the sum of its program
    calls, ``calls`` mapping each program name to how often the solve ran
    it (PCG: ``pcg_init`` once, ``pcg_step`` once per iteration)."""
    expected: Counter = Counter()
    for name, n in calls.items():
        for p, c in dh.expected_collectives(opts, name).items():
            expected[p] += c * n
    return audit_log(log, label, expected_counts=dict(expected))


def rank_traffic(dh, opts=None) -> dict:
    """What one PCG iteration (one ``pcg_step``) of ``opts`` makes this
    process send, on a hierarchy with one process per rank:
    elements (and bytes at the type sent, and the collectives' host
    seconds) by group
    (``slow`` / ``fast`` / ``world``), and elements by the
    strategy of the step that sent them (an operator's selected halo
    strategy, ``reduce:<strategy>`` for the dots, ``coarse`` for the
    coarsest gather), beside the model's messages and bytes for one cycle
    of ``opts`` over all ranks (:func:`cycle_comm_stats`).  Every rank
    must call it at the same point."""
    from ..amg.dist_solve import cycle_comm_stats
    if dh.ranks is None:
        raise ValueError("rank_traffic reads the tally of one process per "
                         "rank; this hierarchy stacks its ranks")
    opts = opts or SolveOptions()
    op_key = {"A": "spmv_A", "P": "interp", "R": "restrict"}
    dh.ranks.reset_tally()
    dh.trace_program("pcg_step", opts)
    by_group: Counter = Counter()
    nbytes: Counter = Counter()
    seconds: Counter = Counter()
    for (group, _), t in dh.ranks.seconds.items():
        seconds[group] += t
    for (group, _), b in dh.ranks.sent_bytes.items():
        nbytes[group] += b
    by_strategy: dict[str, Counter] = {}
    for (group, tag), n in dh.ranks.sent.items():
        if tag == ("dot",):
            strat = f"reduce:{dh.reduce_strategy}"
        elif tag[1] == "coarse":
            strat = "coarse"
        else:
            strat = dh.levels[tag[0]].strategies[op_key[tag[1]]]
        by_group[group] += n
        by_strategy.setdefault(strat, Counter())[group] += n
    model = cycle_comm_stats(dh, opts)
    return {"rank": dh.ranks.rank,
            "elements": dict(by_group),
            "bytes": dict(nbytes),
            "seconds": dict(seconds),
            "by_strategy": {s: dict(c) for s, c in by_strategy.items()},
            "modeled_cycle": {key: model[key] for key in (
                "inter_msgs", "intra_msgs", "inter_bytes", "intra_bytes")}}


def audit_cycle_stats(dh, opts=None) -> list[AuditViolation]:
    """Model-vs-static agreement: a (level, op) whose modeled per-cycle
    counters (:func:`cycle_comm_stats`' per-level rows, from the selected
    schedule's statistics) say it communicates must have a non-empty halo
    plan, and vice versa — plus finiteness of the totals."""
    from ..amg.dist_solve import cycle_comm_stats
    out: list[AuditViolation] = []
    stats = cycle_comm_stats(dh, opts)
    for key in ("inter_msgs", "intra_msgs", "inter_bytes", "intra_bytes"):
        if not math.isfinite(stats[key]) or stats[key] < 0:
            out.append(AuditViolation(
                "stats-nonfinite", f"cycle_comm_stats[{key}]={stats[key]}",
                program="cycle_comm_stats"))
    for l, dl in enumerate(dh.levels):
        for stat_key, attr in (("spmv_A", "A"), ("interp", "P"),
                               ("restrict", "R")):
            if stat_key not in dl.comm_stats:
                continue
            dop = getattr(dl, attr)
            if dop is None:
                continue
            row = dl.comm_stats[stat_key]
            modeled_msgs = row["inter_msgs"] + row["intra_msgs"]
            static_empty = dop.plan.total_halo == 0
            if static_empty and modeled_msgs > 0:
                out.append(AuditViolation(
                    "model-static-disagreement",
                    f"model prices {modeled_msgs} msgs/apply but the halo "
                    f"plan is empty", program="cycle_comm_stats",
                    level=l, op=attr))
            if not static_empty and modeled_msgs == 0:
                out.append(AuditViolation(
                    "model-static-disagreement",
                    f"halo plan moves {dop.plan.total_halo} entries but the "
                    f"model prices zero messages",
                    program="cycle_comm_stats", level=l, op=attr))
    return out


def audit_setup(plevels, records) -> tuple[list[dict], list[AuditViolation]]:
    """Setup-phase SpGEMM audit: for every exchange whose schedule was
    cached for replay (:attr:`PartitionedLevel.plans`), the *measured*
    message/byte counters of the executed
    :func:`~repro_torch.core.nap_collectives.matrix_halo_exchange` must equal the
    counts statically derivable from the selected schedule.  Inter-node
    counts come from :class:`~repro_torch.core.schedules.ScheduleStats`; the
    intra count is re-derived with the exchange's own semantics (EVERY
    same-node message — ``ScheduleStats`` deliberately excludes the
    direct on-node messages common to all strategies, paper §3.3).
    Returns (summary rows, violations)."""
    from ..core.schedules import ScheduleStats

    def static_intra(schedule):
        g, topo = schedule.graph, schedule.graph.topo
        cnt = 0
        for _kind, msg in schedule.all_messages():
            if topo.on_same_node(msg.src, msg.dst):
                cnt += 1
        return cnt

    rows: list[dict] = []
    violations: list[AuditViolation] = []
    by_key = {}
    for rec in records:                     # refresh replays: last one wins
        by_key[(rec.level, rec.op)] = rec
    for l, plv in enumerate(plevels):
        for op, (strat, plan) in sorted(plv.plans.items()):
            rec = by_key.get((l, op))
            if rec is None:
                violations.append(AuditViolation(
                    "missing-record",
                    f"schedule cached for {op} but no SetupCommRecord was "
                    f"measured", program="dist_setup", level=l, op=op))
                continue
            st = ScheduleStats.of(plan.schedule)
            row = {"level": l, "op": op, "strategy": strat,
                   "static_inter_msgs": st.inter_msg_count,
                   "runtime_inter_msgs": rec.inter_msgs,
                   "static_intra_msgs": static_intra(plan.schedule),
                   "runtime_intra_msgs": rec.intra_msgs,
                   "static_inter_bytes": st.inter_bytes_total,
                   "runtime_inter_bytes": rec.inter_bytes}
            rows.append(row)
            if rec.strategy != strat:
                violations.append(AuditViolation(
                    "strategy-mismatch",
                    f"record ran {rec.strategy!r} but the cached schedule "
                    f"is {strat!r}", program="dist_setup", level=l, op=op))
            for static, runtime in (("static_inter_msgs",
                                     "runtime_inter_msgs"),
                                    ("static_intra_msgs",
                                     "runtime_intra_msgs")):
                if row[static] != row[runtime]:
                    violations.append(AuditViolation(
                        "setup-count-mismatch",
                        f"{runtime}={row[runtime]} != {static}={row[static]}"
                        f" for the selected {strat} schedule",
                        program="dist_setup", level=l, op=op))
            if not math.isclose(row["static_inter_bytes"],
                                row["runtime_inter_bytes"],
                                rel_tol=1e-9, abs_tol=1e-6):
                violations.append(AuditViolation(
                    "setup-bytes-mismatch",
                    f"measured inter bytes {row['runtime_inter_bytes']} != "
                    f"modeled {row['static_inter_bytes']}",
                    program="dist_setup", level=l, op=op))
    return rows, violations


def audit_hierarchy(dh, *, pairs=None, programs=PROGRAM_NAMES, k: int = 2,
                    ) -> tuple[list[CommAudit], list[AuditViolation]]:
    """The whole sweep over one lowered hierarchy.

    * every program in ``programs`` for every (cycle, smoother) pair in
      ``pairs`` (default: V/W/F × the five smoothers, the reference's 15
      pairs), ``*_m`` twins at width
      ``k`` — on the card each a captured graph's replay,
    * every per-level operator apply (exact ordered strategy signature +
      overlap independence),
    * the modeled-counter agreement of :func:`cycle_comm_stats` per pair.

    Returns ``(audits, violations)`` — ``violations`` aggregates every
    audit's findings plus the stats-agreement findings.
    """
    if pairs is None:
        pairs = [(c, s) for c in CYCLES for s in PORTED_SMOOTHERS]
    audits: list[CommAudit] = []
    violations: list[AuditViolation] = []
    for cycle, smoother in pairs:
        opts = SolveOptions(cycle=cycle, smoother=smoother)
        for name in programs:
            audits.append(audit_program(
                dh, name, opts, k=k, label=f"{name}[{cycle}+{smoother}]"))
        violations.extend(audit_cycle_stats(dh, opts))
    for l, dl in enumerate(dh.levels):
        for op in ("A", "P", "R"):
            if getattr(dl, op) is not None:
                audits.append(audit_apply(dh, l, op))
    for a in audits:
        violations.extend(a.violations)
    return audits, violations
