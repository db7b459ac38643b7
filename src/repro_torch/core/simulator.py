# Verbatim copy of repro/core/simulator.py (numpy only); only the imports may differ.
"""Rank-faithful execution of communication schedules on one host.

Used by tests (exactly-once delivery, value correctness, stats cross-checks)
and by benchmarks (measured message counts/bytes + modeled times).  Payloads
are entries of a global value array; intermediate ranks (NAP gather/redist
hops) forward values they do not themselves need.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from .comm_graph import CommGraph
from .schedules import Schedule


@dataclasses.dataclass
class SimResult:
    received: list[dict[int, float]]       # per-rank {global index: value}
    delivery_count: dict[tuple[int, int], int]  # (rank, index) -> #final deliveries
    inter_msgs: int
    inter_bytes: float
    intra_msgs: int
    intra_bytes: float


def execute(schedule: Schedule, x: np.ndarray) -> SimResult:
    g: CommGraph = schedule.graph
    topo = g.topo
    part = g.partition
    # store[p]: values rank p can currently serve (owned + received so far)
    store: list[dict[int, float]] = []
    for p in range(topo.n_procs):
        lo, hi = part.local_range(p)
        store.append({int(i): float(x[i]) for i in range(lo, hi)})
    received: list[dict[int, float]] = [dict() for _ in range(topo.n_procs)]
    need_sets = [set(map(int, g.need[q])) for q in range(topo.n_procs)]
    deliveries: dict[tuple[int, int], int] = defaultdict(int)
    inter_msgs = intra_msgs = 0
    inter_bytes = intra_bytes = 0.0

    for phase in schedule.phases:
        # messages within a phase are concurrent: read from pre-phase stores
        staged: list[tuple[int, dict[int, float]]] = []
        for m in phase.messages:
            src_store = store[m.src]
            payload = {}
            for i in m.indices:
                i = int(i)
                if i not in src_store:
                    raise AssertionError(
                        f"rank {m.src} asked to send index {i} it does not hold "
                        f"(phase {phase.kind}, strategy {schedule.strategy})")
                payload[i] = src_store[i]
            staged.append((m.dst, payload))
            b = g.bytes_of(m.indices)
            if topo.on_same_node(m.src, m.dst):
                intra_msgs += 1
                intra_bytes += b
            else:
                inter_msgs += 1
                inter_bytes += b
        for dst, payload in staged:
            store[dst].update(payload)
            if phase.kind == "gather":
                # pure forwarding hop: the aggregation process receives its
                # own needs via the concurrent "local" phase, not here.
                continue
            for i, v in payload.items():
                if i in need_sets[dst]:
                    received[dst][i] = v
                    deliveries[(dst, i)] += 1
    return SimResult(
        received=received,
        delivery_count=dict(deliveries),
        inter_msgs=inter_msgs,
        inter_bytes=inter_bytes,
        intra_msgs=intra_msgs,
        intra_bytes=intra_bytes,
    )


def verify(schedule: Schedule, x: np.ndarray) -> SimResult:
    """Execute and assert the schedule is complete, correct, exactly-once."""
    g = schedule.graph
    res = execute(schedule, x)
    for q in range(g.topo.n_procs):
        for i in map(int, g.need[q]):
            cnt = res.delivery_count.get((q, i), 0)
            if cnt != 1:
                raise AssertionError(
                    f"{schedule.strategy}: rank {q} index {i} delivered {cnt}x")
            if res.received[q][i] != float(x[i]):
                raise AssertionError(
                    f"{schedule.strategy}: rank {q} index {i} wrong value")
    return res
