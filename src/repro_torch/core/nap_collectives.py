"""Node-aware collectives on rank-stacked tensors (PyTorch port of
:mod:`repro.core.nap_collectives`).

The reference runs D = ``n_pods × lanes`` ranks under ``shard_map`` and
lowers every exchange to named-axis XLA collectives.  The port runs all D
ranks in one process: every per-rank array carries a leading rank dim in
pod-major order (``d = pod * lanes + lane``, the reference's device order),
and a collective becomes a reshape/transpose/expand over that dim.  Each
exchange keeps the reference's pack → exchange → select structure, and each
primitive step appends its canonical name (``all_to_all``, ``all_gather``,
``psum_scatter``, ``psum``) to an optional per-call ``log`` list, so the NAP
message structure stays checkable against :data:`HALO_SIGNATURES` and
friends.

* :func:`halo_exchange`   — the paper's SpMV vector communication
  (standard / nap2 / nap3), trailing RHS dims riding along.
* :func:`hier_psum`       — flat or NAP-3 all-reduce (RS(fast) → AR(slow) →
  AG(fast)).
* :func:`hier_all_gather` — flat or pod-then-global all-gather.
* :class:`MatrixHaloPlan` / :func:`matrix_halo_exchange` — the setup
  phase's matrix communication: whole CSR rows of B move under the same §3
  schedules, executed on the host rank-faithfully (phase by phase, message
  by message), with measured message and byte counters.

The plan builders (:class:`HaloPlan` / :func:`build_halo_plan`,
:class:`MatrixHaloPlan` / :func:`build_matrix_halo_plan`), the matrix-row
exchange and the signature tables are verbatim numpy copies of the
reference.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .comm_graph import CommGraph
from .schedules import Schedule, build as build_schedule

# --------------------------------------------------------------------------
# Expected-primitive signatures (copied from repro.core.nap_collectives)
# --------------------------------------------------------------------------

# halo_exchange: per executed exchange (a plan with total_halo == 0 skips
# the exchange entirely — see halo_signature)
HALO_SIGNATURES: dict[str, tuple[str, ...]] = {
    "standard": ("all_to_all", "all_to_all"),
    "nap2": ("all_to_all", "all_gather"),
    "nap3": ("all_gather", "all_to_all", "all_gather"),
}
# hier_psum: per all-reduce (the solver's dots and norms)
REDUCE_SIGNATURES: dict[str, tuple[str, ...]] = {
    "flat": ("psum",),
    "nap3": ("psum_scatter", "psum", "all_gather"),
}
# hier_all_gather: per gather (the coarsest-level direct solve)
GATHER_SIGNATURES: dict[str, tuple[str, ...]] = {
    "flat": ("all_gather",),
    "nap3": ("all_gather", "all_gather"),
}


def halo_signature(plan: "HaloPlan") -> tuple[str, ...]:
    """Collectives ONE :func:`halo_exchange` under ``plan`` must lower to —
    empty when the plan moves nothing (``total_halo == 0``: the apply skips
    the exchange and the program must contain no collective for it)."""
    if plan.total_halo == 0:
        return ()
    return HALO_SIGNATURES[plan.strategy]


def reduce_signature(strategy: str) -> tuple[str, ...]:
    """Collectives one :func:`hier_psum` call with ``strategy`` lowers to."""
    return REDUCE_SIGNATURES[strategy]


def gather_signature(strategy: str = "nap3") -> tuple[str, ...]:
    """Collectives one :func:`hier_all_gather` call lowers to."""
    return GATHER_SIGNATURES[strategy]


# --------------------------------------------------------------------------
# Collective primitives over the stacked rank dim
# --------------------------------------------------------------------------


def _note(log: list | None, name: str) -> None:
    if log is not None:
        log.append(name)


def _all_to_all(v: torch.Tensor, rank_dim: int, chunk_dim: int,
                log: list | None) -> torch.Tensor:
    """Untiled all-to-all along one mesh axis: on a view whose ``rank_dim``
    indexes the sender's coordinate on that axis and ``chunk_dim`` the
    destination's, chunk ``c`` of rank ``r`` becomes chunk ``r`` of rank
    ``c`` — a swap of the two dims."""
    _note(log, "all_to_all")
    return v.transpose(rank_dim, chunk_dim)


def _all_gather_lanes(v: torch.Tensor, log: list | None) -> torch.Tensor:
    """All-gather over the lane axis of a ``[n_pods, lanes, ...]`` view:
    every lane of pod P receives ``[lanes, ...]`` stacked lane-first."""
    _note(log, "all_gather")
    n_pods, lanes = v.shape[:2]
    return v.unsqueeze(1).expand((n_pods, lanes) + tuple(v.shape[1:]))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-rank gather ``x[d][idx[d]]`` with ``-1`` entries yielding exact
    zeros.  ``x``: ``[D, L] + ext``; ``idx``: ``[D, ...]`` int64."""
    D = x.shape[0]
    ext = tuple(x.shape[2:])
    flat = idx.reshape(D, -1)
    bshape = (D, flat.shape[1]) + (1,) * len(ext)
    safe = flat.clamp_min(0).reshape(bshape).expand((D, flat.shape[1]) + ext)
    out = torch.gather(x, 1, safe)
    out = torch.where((flat >= 0).reshape(bshape), out, 0.0)
    return out.reshape(tuple(idx.shape) + ext)


def hier_psum(x: torch.Tensor, n_pods: int, lanes: int,
              strategy: str = "nap3", log: list | None = None) -> torch.Tensor:
    """All-reduce over all ranks of the per-rank partials ``x`` (``[D, ...]``);
    every rank gets the total.  ``nap3`` = RS(fast) → AR(slow) → AG(fast):
    the slow axis carries 1/|fast| of the bytes (paper Fig. 12)."""
    if strategy == "flat":
        _note(log, "psum")
        return x.sum(dim=0, keepdim=True).expand(x.shape)
    if strategy != "nap3":
        raise ValueError(f"hier_psum: unknown strategy {strategy!r}")
    D = x.shape[0]
    shape = tuple(x.shape[1:])
    flat = x.reshape(n_pods, lanes, -1)
    F = flat.shape[-1]
    pad = (-F) % lanes
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    # 1) reduce-scatter inside the pod: rank (P, L) keeps piece L
    _note(log, "psum_scatter")
    piece = flat.reshape(n_pods, lanes, lanes, -1).sum(dim=1)
    # 2) one aggregated inter-pod reduction per piece
    _note(log, "psum")
    piece = piece.sum(dim=0, keepdim=True).expand(n_pods, lanes, -1)
    # 3) redistribute inside the pod (tiled: pieces concatenate in lane order)
    full = _all_gather_lanes(piece, log).reshape(D, -1)
    if pad:
        full = full[:, :F]
    return full.reshape((D,) + shape)


def hier_all_gather(x: torch.Tensor, n_pods: int, lanes: int,
                    strategy: str = "nap3",
                    log: list | None = None) -> torch.Tensor:
    """All-gather of ``x`` (``[D, m] + ext``) along dim 1 over all ranks, with
    pod-major result layout: every rank gets ``[D * m] + ext``."""
    D, m = x.shape[:2]
    ext = tuple(x.shape[2:])
    if strategy == "flat":
        _note(log, "all_gather")
        return x.reshape((1, D * m) + ext).expand((D, D * m) + ext)
    # gather the pod's shard first (cheap), then one aggregated slow transfer
    pod = _all_gather_lanes(x.reshape((n_pods, lanes, m) + ext), log)
    pod = pod.reshape((n_pods, lanes, lanes * m) + ext)
    _note(log, "all_gather")
    full = pod.transpose(0, 1).reshape((1, lanes, n_pods * lanes * m) + ext)
    full = full.expand((n_pods, lanes, D * m) + ext)
    return full.reshape((D, D * m) + ext)


# --------------------------------------------------------------------------
# Matrix-row halo exchange for distributed SpGEMM (copied from the reference,
# host numpy; the paper's matrix communication: "retains the same
# communication pattern as vectors, but requires entire rows")
# --------------------------------------------------------------------------


@dataclasses.dataclass
class MatrixHaloPlan:
    """Host-side plan for exchanging off-process CSR **rows**.

    Built from a :class:`~repro.core.comm_graph.CommGraph` whose indices are
    rows of B and whose weights are per-row byte sizes (see
    :func:`repro.amg.dist.matrix_comm_graph`: header + entries).  The
    ``schedule`` is the §3 message list for the chosen strategy — the same
    object the max-rate models price, so what :func:`repro.core.selector.
    select` selects is exactly what executes.
    """

    strategy: str
    graph: CommGraph
    schedule: Schedule

    @property
    def n_ranks(self) -> int:
        return self.graph.topo.n_procs


def build_matrix_halo_plan(graph: CommGraph, strategy: str) -> MatrixHaloPlan:
    return MatrixHaloPlan(strategy, graph, build_schedule(strategy, graph))


@dataclasses.dataclass
class MatrixExchangeResult:
    """Measured outcome of one matrix-row exchange.

    ``halo[q]`` maps each global B-row index rank ``q`` needed to the payload
    the provider returned for it; the message/byte counters are the measured
    counterparts of the modeled :class:`~repro.core.schedules.ScheduleStats`.
    """

    halo: list[dict[int, object]]
    inter_msgs: int
    inter_bytes: float
    intra_msgs: int
    intra_bytes: float
    seconds: float


def matrix_halo_exchange(plan: MatrixHaloPlan, get_row) -> MatrixExchangeResult:
    """Execute the plan rank-faithfully on the host.

    ``get_row(owner_rank, global_row) -> payload`` supplies an owned row
    (payload is opaque — e.g. a ``(cols, vals)`` pair).  Intermediate ranks
    (NAP gather/redist hops) forward rows they do not themselves need, as in
    :mod:`repro.core.simulator`; messages within a phase are concurrent and
    read from pre-phase stores.
    """
    t0 = time.perf_counter()
    g = plan.graph
    topo = g.topo
    part = g.partition
    D = topo.n_procs
    owner_lo = [part.local_range(p)[0] for p in range(D)]
    owner_hi = [part.local_range(p)[1] for p in range(D)]
    store: list[dict[int, object]] = [dict() for _ in range(D)]
    inter_msgs = intra_msgs = 0
    inter_bytes = intra_bytes = 0.0

    def serve(src: int, i: int):
        if owner_lo[src] <= i < owner_hi[src]:
            return get_row(src, i)
        try:
            return store[src][i]
        except KeyError:
            raise AssertionError(
                f"rank {src} asked to send row {i} it does not hold "
                f"(strategy {plan.strategy})") from None

    for phase in plan.schedule.phases:
        staged: list[tuple[int, dict[int, object]]] = []
        for m in phase.messages:
            payload = {int(i): serve(m.src, int(i)) for i in m.indices}
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

    halo: list[dict[int, object]] = []
    for q in range(D):
        rows = {}
        for i in map(int, g.need[q]):
            if i not in store[q]:
                raise AssertionError(
                    f"{plan.strategy}: rank {q} never received row {i}")
            rows[i] = store[q][i]
        halo.append(rows)
    return MatrixExchangeResult(halo, inter_msgs, inter_bytes, intra_msgs,
                                intra_bytes, time.perf_counter() - t0)


# --------------------------------------------------------------------------
# Halo exchange for distributed SpMV (copied plan builder + stacked executor)
# --------------------------------------------------------------------------


def _pad_to(arrs: list[np.ndarray], width: int, fill: int) -> np.ndarray:
    out = np.full((len(arrs), width), fill, dtype=np.int32)
    for i, a in enumerate(arrs):
        out[i, : a.size] = a
    return out


@dataclasses.dataclass
class HaloPlan:
    """Static-shape device plan for one CommGraph + one (pods × lanes) mesh.

    Built on host at setup time (like an MPI communicator build); executed
    on rank-stacked tensors.  Rank d = pod * lanes + lane owns the row block
    of ``partition`` for rank d; the halo buffer layout is the rank's sorted
    ``need`` array.

    standard : flat all_to_all of per-peer padded buffers (direct sends).
    nap2     : per-(device → dst pod) de-duplicated buffers, a2a over the pod
               axis between lane-peers, then an intra-pod all-gather.
    nap3     : per-(pod → pod) de-duplicated union buffers, split over lanes
               (balanced), a2a over the pod axis, then intra-pod all-gather.
    """

    strategy: str
    n_pods: int
    lanes: int
    local_n: int                 # padded local row count per device
    halo_len: int                # per-device halo width (max over devices)
    # device-stacked numpy index arrays (first dim = n_devices):
    send_idx: np.ndarray         # [D, n_targets, K] local indices to pack (-1 pad)
    recv_sel: np.ndarray         # [D, halo_len] flat index into received pool (-1 pad)
    pool_len: int                # flattened receive-pool length per device
    # nap3 only: pre-a2a lane pool selection
    pool_sel: np.ndarray | None = None   # [D, n_pods, K3] into intra-gathered pool
    contrib_len: int = 0
    # TRUE total halo entries across all devices.  ``halo_len`` is floored
    # to 1 for static shapes, so emptiness must be read here: a plan with
    # ``total_halo == 0`` moves nothing and the apply skips the exchange.
    total_halo: int = 0

    @property
    def n_devices(self) -> int:
        return self.n_pods * self.lanes


def build_halo_plan(graph: CommGraph, n_pods: int, lanes: int,
                    strategy: str) -> HaloPlan:
    topo = graph.topo
    assert topo.n_nodes == n_pods and topo.ppn == lanes, "graph topo must match mesh"
    part = graph.partition
    D = n_pods * lanes
    local_n = part.max_local_size
    need_sorted = [np.sort(graph.need[d]).astype(np.int64) for d in range(D)]
    total_halo = int(sum(n.size for n in need_sorted))
    halo_len = max((n.size for n in need_sorted), default=0) or 1

    def local_of(d, gidx):
        lo, _ = part.local_range(d)
        return (gidx - lo).astype(np.int32)

    owners = [part.owner_of_rows(need_sorted[d]) if need_sorted[d].size else
              np.zeros(0, dtype=np.int64) for d in range(D)]

    if strategy == "standard":
        # per (src d, dst e) message: what e needs from d
        msgs = [[np.zeros(0, dtype=np.int64) for _ in range(D)] for _ in range(D)]
        for e in range(D):
            for d, g in zip(owners[e], need_sorted[e]):
                msgs[int(d)][e] = np.append(msgs[int(d)][e], g)
        K = max((m.size for row in msgs for m in row), default=0) or 1
        send_idx = np.stack([
            _pad_to([local_of(d, m) if m.size else np.zeros(0, np.int64)
                     for m in msgs[d]], K, -1) for d in range(D)])
        # receive pool for device e: [D, K] from each source (flat D*K)
        pool_len = D * K
        recv_sel = np.full((D, halo_len), -1, dtype=np.int32)
        for e in range(D):
            # position of each needed gidx inside msgs[d][e]
            for j, (d, g) in enumerate(zip(owners[e], need_sorted[e])):
                d = int(d)
                k = int(np.searchsorted(msgs[d][e], g))
                recv_sel[e, j] = d * K + k
        return HaloPlan(strategy, n_pods, lanes, local_n, halo_len,
                        send_idx, recv_sel, pool_len, total_halo=total_halo)

    if strategy == "nap2":
        # per (src d, dst pod m): union of what pod m needs from d
        msgs = [[np.zeros(0, dtype=np.int64) for _ in range(n_pods)] for _ in range(D)]
        for e in range(D):
            m = e // lanes
            for d, g in zip(owners[e], need_sorted[e]):
                msgs[int(d)][m] = np.append(msgs[int(d)][m], g)
        msgs = [[np.unique(m) for m in row] for row in msgs]
        K = max((m.size for row in msgs for m in row), default=0) or 1
        send_idx = np.stack([
            _pad_to([local_of(d, m) if m.size else np.zeros(0, np.int64)
                     for m in msgs[d]], K, -1) for d in range(D)])
        # after a2a(pod) lane-peer exchange + all_gather(lane):
        # pool at device e (pod m): for lane ℓ, for src pod n:
        # msgs[n*lanes + ℓ][m]  → flat [lanes, n_pods, K]
        pool_len = lanes * n_pods * K
        recv_sel = np.full((D, halo_len), -1, dtype=np.int32)
        for e in range(D):
            m = e // lanes
            for j, (d, g) in enumerate(zip(owners[e], need_sorted[e])):
                d = int(d)
                n_src, lane_src = d // lanes, d % lanes
                k = int(np.searchsorted(msgs[d][m], g))
                recv_sel[e, j] = (lane_src * n_pods + n_src) * K + k
        return HaloPlan(strategy, n_pods, lanes, local_n, halo_len,
                        send_idx, recv_sel, pool_len, total_halo=total_halo)

    if strategy == "nap3":
        # pod-pair unions, split across lanes (balanced NAP-3)
        pair = [[np.zeros(0, dtype=np.int64) for _ in range(n_pods)]
                for _ in range(n_pods)]
        for e in range(D):
            m = e // lanes
            for d, g in zip(owners[e], need_sorted[e]):
                pair[int(d) // lanes][m] = np.append(pair[int(d) // lanes][m], g)
        pair = [[np.unique(m) for m in row] for row in pair]
        # contribution step: device d provides its owned entries of every
        # union pair[n][*]; all_gather(lane) builds the pod's pool.
        contrib = [[np.zeros(0, dtype=np.int64) for _ in range(n_pods)]
                   for _ in range(D)]
        for n in range(n_pods):
            for m in range(n_pods):
                # n == m included: same-pod traffic rides the a2a self-slab
                # (local, never crosses the network) — the analogue of
                # the paper's on-node direct sends.
                own = part.owner_of_rows(pair[n][m])
                for d in range(n * lanes, (n + 1) * lanes):
                    contrib[d][m] = np.unique(np.append(
                        contrib[d][m], pair[n][m][own == d]))
        Kc = max((c.size for row in contrib for c in row), default=0) or 1
        send_idx = np.stack([
            _pad_to([local_of(d, c) if c.size else np.zeros(0, np.int64)
                     for c in contrib[d]], Kc, -1) for d in range(D)])
        contrib_len = n_pods * Kc
        # lane split of each pod-pair union
        K3 = 0
        shares: dict[tuple[int, int, int], np.ndarray] = {}
        for n in range(n_pods):
            for m in range(n_pods):
                u = pair[n][m]
                for l in range(lanes):
                    sh = u[l::lanes]
                    shares[(n, m, l)] = sh
                    K3 = max(K3, sh.size)
        K3 = K3 or 1
        # pool_sel: device d=(n,l) selects, for each dst pod m, its share out
        # of the intra-gathered pool [lanes, n_pods, Kc] (flat).
        pool_sel = np.full((D, n_pods, K3), -1, dtype=np.int32)
        for n in range(n_pods):
            for l in range(lanes):
                d = n * lanes + l
                for m in range(n_pods):
                    sh = shares[(n, m, l)]
                    own = part.owner_of_rows(sh)
                    for t, (o, g) in enumerate(zip(own, sh)):
                        o = int(o)
                        k = int(np.searchsorted(contrib[o][m], g))
                        pool_sel[d, m, t] = ((o % lanes) * n_pods + m) * Kc + k
        # receive: after a2a(pod) each device (m,l) holds shares[(n,m,l)] for
        # all n → all_gather(lane) → pool [lanes, n_pods, K3] flat.
        pool_len = lanes * n_pods * K3
        recv_sel = np.full((D, halo_len), -1, dtype=np.int32)
        for e in range(D):
            m = e // lanes
            # index of g within shares[(n, m, l)]: g is at position p in
            # pair[n][m] with lane l = p % lanes, slot p // lanes.
            for j, (d, g) in enumerate(zip(owners[e], need_sorted[e])):
                n = int(d) // lanes
                p = int(np.searchsorted(pair[n][m], g))
                l, slot = p % lanes, p // lanes
                recv_sel[e, j] = (l * n_pods + n) * K3 + slot
        return HaloPlan(strategy, n_pods, lanes, local_n, halo_len,
                        send_idx, recv_sel, pool_len,
                        pool_sel=pool_sel, contrib_len=contrib_len,
                        total_halo=total_halo)

    raise ValueError(f"unknown strategy {strategy!r}")


def halo_exchange(x: torch.Tensor, plan: HaloPlan, send_idx: torch.Tensor,
                  recv_sel: torch.Tensor, pool_sel: torch.Tensor | None,
                  log: list | None = None) -> torch.Tensor:
    """Every rank's halo values: ``[D, halo_len] + ext``.

    ``x`` is the rank-stacked local vector, ``[D, local_n]`` for one RHS or
    ``[D, local_n, k]`` for a multi-RHS batch (the trailing dims ride along
    through one exchange).  ``send_idx``/``recv_sel``/``pool_sel`` are the
    plan's index arrays as int64 tensors on ``x``'s device.
    """
    P, L, D = plan.n_pods, plan.lanes, plan.n_devices
    ext = tuple(x.shape[2:])
    if plan.strategy == "standard":
        K = send_idx.shape[-1]
        buf = _take(x, send_idx).reshape((P, L, P, L, K) + ext)  # pack per peer
        buf = _all_to_all(buf, 0, 2, log)                        # pod axis
        buf = _all_to_all(buf, 1, 3, log)                        # lane axis
        pool = buf.reshape((D, plan.pool_len) + ext)             # [src d, K]
    elif plan.strategy == "nap2":
        K = send_idx.shape[-1]
        buf = _take(x, send_idx).reshape((P, L, P, K) + ext)     # per dst pod
        buf = _all_to_all(buf, 0, 2, log)     # lane-peers: [src pod, K]
        pool = _all_gather_lanes(buf, log)    # [lanes, n_pods, K] per rank
        pool = pool.reshape((D, plan.pool_len) + ext)
    elif plan.strategy == "nap3":
        contrib = _take(x, send_idx).reshape((P, L, -1) + ext)  # [n_pods*Kc]
        pod_pool = _all_gather_lanes(contrib, log)      # [lanes, n_pods, Kc]
        pod_pool = pod_pool.reshape((D, -1) + ext)
        K3 = pool_sel.shape[-1]
        out_buf = _take(pod_pool, pool_sel).reshape((P, L, P, K3) + ext)
        out_buf = _all_to_all(out_buf, 0, 2, log)       # [src pod, K3]
        pool = _all_gather_lanes(out_buf, log)          # [lanes, n_pods, K3]
        pool = pool.reshape((D, plan.pool_len) + ext)
    else:
        raise ValueError(plan.strategy)
    return _take(pool, recv_sel)
