# Verbatim copy of repro/core/schedules.py (numpy only); only the imports may differ.
"""Standard, NAP-2 and NAP-3 communication schedules (paper §3).

A schedule is an ordered list of *phases*; each phase is a list of messages
``(src, dst, indices)`` that may proceed concurrently.  Phases:

* standard: one phase of direct messages (Fig. 10/11).
* NAP-2 (§3.2, Fig. 13):  ``local`` (on-node direct) → ``inter`` (one
  de-duplicated message from each sender to its lane-peer on every needed
  node) → ``redist`` (on-node redistribution at the receiver).
* NAP-3 (§3.1, Fig. 12):  ``local`` → ``gather`` (collect everything node n
  sends node m onto one process of n) → ``inter`` (single message per node
  pair) → ``redist``.

On-node requirements always use direct messages ("all on-node messages are
communicated with the standard approach").  Destination-node → local-process
assignment is round-robin over lanes so several processes per node stay
active (paper §3.1 last paragraph).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from .comm_graph import CommGraph

STRATEGIES = ("standard", "nap2", "nap3")


@dataclasses.dataclass(frozen=True)
class Message:
    src: int
    dst: int
    indices: np.ndarray          # global indices carried
    final_dst: tuple | None = None  # for gather phases: ultimate destination node

    def __post_init__(self):
        object.__setattr__(self, "indices", np.asarray(self.indices, dtype=np.int64))


@dataclasses.dataclass
class Phase:
    kind: str                    # "direct" | "local" | "gather" | "inter" | "redist"
    messages: list[Message]


@dataclasses.dataclass
class Schedule:
    strategy: str
    graph: CommGraph
    phases: list[Phase]

    def all_messages(self):
        for ph in self.phases:
            for m in ph.messages:
                yield ph.kind, m


# --------------------------------------------------------------------------- helpers
def _lane_for_peer_node(topo, my_node: int, peer_node: int) -> int:
    """Round-robin lane on ``my_node`` responsible for traffic with ``peer_node``.

    Deterministic and symmetric-free: distributes distinct peer nodes across
    the ppn lanes so several processes per node participate (NAP-3 balance).
    """
    return peer_node % topo.ppn


def _group_by_node(topo, ranks: np.ndarray) -> dict[int, np.ndarray]:
    nodes = ranks // topo.ppn
    return {int(n): ranks[nodes == n] for n in np.unique(nodes)}


# --------------------------------------------------------------------------- builders
def build_standard(graph: CommGraph) -> Schedule:
    msgs = [Message(p, q, idx) for p, q, idx in graph.recv_pairs()]
    return Schedule("standard", graph, [Phase("direct", msgs)])


def _split_onnode(graph: CommGraph):
    """(on-node direct messages, off-node requirements per (p, dst_node))."""
    topo = graph.topo
    local_msgs: list[Message] = []
    # (src_rank p, dst_node m) -> {dst_rank q -> indices}
    offnode: dict[tuple[int, int], dict[int, np.ndarray]] = defaultdict(dict)
    for p, q, idx in graph.recv_pairs():
        if topo.on_same_node(p, q):
            local_msgs.append(Message(p, q, idx))
        else:
            offnode[(p, topo.node_of(q))][q] = idx
    return local_msgs, offnode


def build_nap2(graph: CommGraph) -> Schedule:
    topo = graph.topo
    local_msgs, offnode = _split_onnode(graph)
    inter_msgs: list[Message] = []
    redist: dict[tuple[int, int], dict[int, list[np.ndarray]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for (p, m), per_q in sorted(offnode.items()):
        union = np.unique(np.concatenate(list(per_q.values())))
        # lane-matched corresponding process on node m
        recv = m * topo.ppn + topo.local_rank(p)
        inter_msgs.append(Message(p, recv, union))
        for q, idx in per_q.items():
            if q != recv:
                redist[(m, recv)][q].append(idx)
    redist_msgs = [
        Message(recv, q, np.unique(np.concatenate(chunks)))
        for (m, recv), per_q in sorted(redist.items())
        for q, chunks in sorted(per_q.items())
    ]
    return Schedule(
        "nap2",
        graph,
        [Phase("local", local_msgs), Phase("inter", inter_msgs), Phase("redist", redist_msgs)],
    )


def build_nap3(graph: CommGraph) -> Schedule:
    topo = graph.topo
    local_msgs, offnode = _split_onnode(graph)

    # node pair (n, m) -> {src_rank p -> union of indices for node m}
    pair_src: dict[tuple[int, int], dict[int, np.ndarray]] = defaultdict(dict)
    # node pair (n, m) -> {dst_rank q -> indices}  (for redistribution)
    pair_dst: dict[tuple[int, int], dict[int, list[np.ndarray]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for (p, m), per_q in sorted(offnode.items()):
        n = topo.node_of(p)
        union = np.unique(np.concatenate(list(per_q.values())))
        pair_src[(n, m)][p] = union
        for q, idx in per_q.items():
            pair_dst[(n, m)][q].append(idx)

    gather_msgs: list[Message] = []
    inter_msgs: list[Message] = []
    redist_msgs: list[Message] = []
    for (n, m), per_p in sorted(pair_src.items()):
        agg_src = n * topo.ppn + _lane_for_peer_node(topo, n, m)   # process R on n
        agg_dst = m * topo.ppn + _lane_for_peer_node(topo, m, n)   # process q on m
        union = np.unique(np.concatenate(list(per_p.values())))
        for p, idx in sorted(per_p.items()):
            if p != agg_src:
                gather_msgs.append(Message(p, agg_src, idx, final_dst=(m,)))
        inter_msgs.append(Message(agg_src, agg_dst, union))
        for q, chunks in sorted(pair_dst[(n, m)].items()):
            if q != agg_dst:
                redist_msgs.append(Message(agg_dst, q, np.unique(np.concatenate(chunks))))
    return Schedule(
        "nap3",
        graph,
        [
            Phase("local", local_msgs),
            Phase("gather", gather_msgs),
            Phase("inter", inter_msgs),
            Phase("redist", redist_msgs),
        ],
    )


_BUILDERS = {"standard": build_standard, "nap2": build_nap2, "nap3": build_nap3}


def build(strategy: str, graph: CommGraph) -> Schedule:
    return _BUILDERS[strategy](graph)


# --------------------------------------------------------------------------- stats
@dataclasses.dataclass
class ScheduleStats:
    """Aggregate quantities the max-rate models (Eqs. 4–6) consume.

    Inter-node messages feed Eq. (2)'s terms; intra-node extras feed Eq. (3).
    """

    strategy: str
    # inter-node (network-crossing) messages
    n_proc: int          # max #inter-node messages sent by any process
    n_proc2node: int     # max #distinct destination nodes of any process
    n_node2node: int     # max #inter-node messages sent by any node
    s_proc: float        # max inter-node bytes sent by any process
    s_node: float        # max inter-node bytes injected by any node
    s_node2node: float   # max bytes between any node pair
    inter_msg_count: int
    inter_bytes_total: float
    # additional intra-node traffic introduced by the strategy (gather+redist)
    intra_msg_count: int
    intra_bytes_total: float
    s_proc_intra: float  # max intra bytes handled (sent) by any process
    n_proc_intra: int

    # duplicate-byte diagnostic: bytes saved vs standard by de-duplication
    @staticmethod
    def of(schedule: Schedule) -> "ScheduleStats":
        g = schedule.graph
        topo = g.topo
        P, N = topo.n_procs, topo.n_nodes
        proc_msgs = np.zeros(P, dtype=np.int64)
        proc_bytes = np.zeros(P)
        proc_nodes: list[set] = [set() for _ in range(P)]
        node_msgs = np.zeros(N, dtype=np.int64)
        node_bytes = np.zeros(N)
        pair_bytes: dict[tuple[int, int], float] = defaultdict(float)
        intra_msgs = np.zeros(P, dtype=np.int64)
        intra_bytes = np.zeros(P)
        inter_cnt = 0
        inter_tot = 0.0
        intra_cnt = 0
        intra_tot = 0.0
        for kind, msg in schedule.all_messages():
            b = g.bytes_of(msg.indices)
            sn, dn = topo.node_of(msg.src), topo.node_of(msg.dst)
            if sn != dn:
                proc_msgs[msg.src] += 1
                proc_bytes[msg.src] += b
                proc_nodes[msg.src].add(dn)
                node_msgs[sn] += 1
                node_bytes[sn] += b
                pair_bytes[(sn, dn)] += b
                inter_cnt += 1
                inter_tot += b
            elif kind in ("gather", "redist"):  # strategy-added intra traffic
                intra_msgs[msg.src] += 1
                intra_bytes[msg.src] += b
                intra_cnt += 1
                intra_tot += b
            # kind "local"/"direct" on-node messages are common to all
            # strategies and excluded from the models (paper §3.3).
        return ScheduleStats(
            strategy=schedule.strategy,
            n_proc=int(proc_msgs.max(initial=0)),
            n_proc2node=int(max((len(s) for s in proc_nodes), default=0)),
            n_node2node=int(node_msgs.max(initial=0)),
            s_proc=float(proc_bytes.max(initial=0.0)),
            s_node=float(node_bytes.max(initial=0.0)),
            s_node2node=float(max(pair_bytes.values(), default=0.0)),
            inter_msg_count=inter_cnt,
            inter_bytes_total=inter_tot,
            intra_msg_count=intra_cnt,
            intra_bytes_total=intra_tot,
            s_proc_intra=float(intra_bytes.max(initial=0.0)),
            n_proc_intra=int(intra_msgs.max(initial=0)),
        )
