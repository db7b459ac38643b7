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

**One process per rank.**  :class:`RankGroups` is the port's counterpart of
the reference's ``("pod", "lane")`` mesh: this process's rank on the grid,
the world group, its pod's **fast** group (the pod's ``lanes`` ranks) and
its lane's **slow** group (the ``n_pods`` ranks that share the lane), all
``torch.distributed`` process groups (:func:`init_ranks`).  Passed as
``ranks=`` to the three exchanges above, it makes every step a real
collective between processes on tensors whose leading rank dim has size 1:
a pod-axis swap is an ``all_to_all_single`` over the slow group, a lane-axis
swap one over the fast group, an intra-pod gather an
``all_gather_into_tensor`` over the fast group, and NAP-3's all-reduce
reduce-scatter (fast) → all-reduce (slow) → all-gather (fast).  Each step is
logged under the same name at the same point as in the stacked form, and
every element a process sends is tallied by group and by the caller's tag.
On a gloo group the card's tensors are copied to the host before each
collective and back after it (gloo ranks sharing one card); on an NCCL group
they go in directly (one card per rank).  Every ``torch.distributed`` call
of the port lives in this module.

The plan builders (:class:`HaloPlan` / :func:`build_halo_plan`,
:class:`MatrixHaloPlan` / :func:`build_matrix_halo_plan`), the matrix-row
exchange and the signature tables are verbatim numpy copies of the
reference.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

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


# --------------------------------------------------------------------------
# One process per rank: the rank mesh and its process groups
# --------------------------------------------------------------------------

#: the reduce-scatter collective (``reduce_scatter_single`` from
#: torch 2.13, the older name before)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
#: the rank meshes of this process by (n_pods, lanes): every process creates
#: every subgroup once, in the same order (``torch.distributed.new_group``'s
#: rule), so a mesh is made once and shared
_MESHES: dict[tuple[int, int], "RankGroups"] = {}
DEFAULT_TIMEOUT = 120.0          # seconds a collective may wait for a peer
#: how everything one process per rank does not run yet refuses
PROCESS_TODO = ("is not ported to ranks='process' yet (ROADMAP queue 1, "
                "item 12)")


class RankGroups:
    """This process's place on the (pods × lanes) rank grid and its process
    groups: the counterpart of the reference's ``jax.make_mesh((n_pods,
    lanes), ("pod", "lane"))``.

    ``rank`` is ``d = pod * lanes + lane`` (pod-major, as in
    :class:`~repro_torch.core.topology.Topology`).  ``fast`` is this pod's
    group (its ``lanes`` ranks in lane order), ``slow`` this lane's group
    (the ``n_pods`` ranks that share it, in pod order), ``world`` the
    default group.  Made by :func:`init_ranks` / :func:`rank_groups` over
    an initialised default group of ``n_pods * lanes`` ranks.

    ``sent`` tallies the elements this process sends, by (group, tag): an
    element counts once for every other rank whose result it reaches (an
    all-to-all chunk for its one receiver, a gathered or all-reduced
    element for each peer, a reduce-scattered element for the one rank
    whose piece it is in), padding included.  ``seconds`` holds the
    collectives' host wall time likewise (on a staged group from after the
    card's queued work to the result back on the card; on NCCL the enqueue
    alone).
    """

    def __init__(self, n_pods: int, lanes: int):
        world = dist.get_world_size()
        if world != n_pods * lanes:
            raise ValueError(
                f"the default process group has {world} ranks; a {n_pods} x "
                f"{lanes} rank grid needs {n_pods * lanes}")
        self.n_pods, self.lanes = n_pods, lanes
        self.rank = dist.get_rank()
        self.pod, self.lane = divmod(self.rank, lanes)
        self.backend = str(dist.get_backend())
        # gloo moves host memory: card tensors are staged through the host
        self.staged = self.backend == "gloo"
        if self.backend == "nccl":
            # NCCL needs a card of its own for every rank, current before
            # the first collective
            local = int(os.environ.get("LOCAL_RANK", self.rank))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"NCCL needs one card per rank: local rank {local} on a "
                    f"machine with {torch.cuda.device_count()} card(s)")
            torch.cuda.set_device(local)
        fast = [dist.new_group([p * lanes + l for l in range(lanes)])
                for p in range(n_pods)]
        slow = [dist.new_group([p * lanes + l for p in range(n_pods)])
                for l in range(lanes)]
        self._groups = {"world": (dist.group.WORLD, world),
                        "fast": (fast[self.pod], lanes),
                        "slow": (slow[self.lane], n_pods)}
        self.sent: Counter = Counter()
        self.seconds: Counter = Counter()

    @property
    def size(self) -> int:
        return self.n_pods * self.lanes

    def device(self, requested: str | torch.device = "cuda") -> torch.device:
        """The device this rank computes on: the CPU when asked; on the card
        ``requested`` as it is for gloo (every rank may share one card), and
        ``cuda:<local rank>`` for NCCL (made current when the mesh was
        made)."""
        from ..device import resolve_device
        dev = resolve_device(requested)
        if dev.type != "cuda" or self.backend != "nccl":
            return dev
        return torch.device("cuda", torch.cuda.current_device())

    def reset_tally(self) -> None:
        self.sent.clear()
        self.seconds.clear()

    # -- the collectives (each logs its canonical name and tallies) --------
    def _run(self, op, v: torch.Tensor, group: str, tag, log, name: str,
             chunked: bool, out_shape) -> torch.Tensor:
        """One collective ``op(out, src, pg)`` over ``group``: log ``name``,
        tally what it sends (``chunked``: each peer receives one ``1/size``
        chunk of ``v``, else all of it), stage a card tensor through the
        host on gloo, and time it.  ``out_shape(src, size)`` is the output's
        shape."""
        _note(log, name)
        pg, size = self._groups[group]
        n = v.numel() // size if chunked else v.numel()
        self.sent[(group, tag)] += n * (size - 1)
        src = v.contiguous()
        if self.staged and src.is_cuda:
            # the copy to the host waits for the card anyway: wait first,
            # so the clock starts with the collective
            torch.cuda.current_stream(src.device).synchronize()
        t0 = time.perf_counter()
        if self.staged:
            src = src.cpu()
        out = src.new_empty(out_shape(src, size))
        op(out, src, pg)
        if out.device != v.device:
            out = out.to(v.device)
        self.seconds[(group, tag)] += time.perf_counter() - t0
        return out

    def all_to_all(self, v: torch.Tensor, group: str, tag=None,
                   log: list | None = None) -> torch.Tensor:
        """Chunk ``j`` of ``v``'s dim 0 goes to member ``j`` of ``group``;
        chunk ``i`` of the result came from member ``i``."""
        return self._run(
            lambda out, src, pg: dist.all_to_all_single(out, src, group=pg),
            v, group, tag, log, "all_to_all", True,
            lambda src, size: src.shape)

    def all_gather(self, v: torch.Tensor, group: str, tag=None,
                   log: list | None = None) -> torch.Tensor:
        """``[size] + v.shape``: member ``i``'s ``v`` at index ``i``."""
        out = self._run(
            lambda out, src, pg: dist.all_gather_into_tensor(out, src,
                                                             group=pg),
            v, group, tag, log, "all_gather", False,
            lambda src, size: (size * src.shape[0],) + tuple(src.shape[1:]))
        return out.view((-1,) + tuple(v.shape))

    def reduce_scatter(self, v: torch.Tensor, group: str, tag=None,
                       log: list | None = None) -> torch.Tensor:
        """Member ``i`` gets the sum over the group of chunk ``i`` of
        ``v``'s dim 0."""
        return self._run(
            lambda out, src, pg: _reduce_scatter(out, src, group=pg),
            v, group, tag, log, "psum_scatter", True,
            lambda src, size: (src.shape[0] // size,) + tuple(src.shape[1:]))

    def all_reduce(self, v: torch.Tensor, group: str, tag=None,
                   log: list | None = None) -> torch.Tensor:
        """The sum of ``v`` over the group, on every member."""
        def op(out, src, pg):
            out.copy_(src)
            dist.all_reduce(out, group=pg)

        return self._run(op, v, group, tag, log, "psum", False,
                         lambda src, size: src.shape)

    # -- host objects ------------------------------------------------------
    def gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def check_same(self, value, what: str) -> None:
        """Raise on every rank unless every rank passed an equal ``value``."""
        seen = self.gather_objects(value)
        if any(v != seen[0] for v in seen):
            raise ValueError(f"the ranks disagree on the {what}: {seen}")

    def all_true(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank (the same answer on all)."""
        return all(self.gather_objects(bool(flag)))

    def scatter_objects(self, objs: list | None):
        """Rank 0's ``objs[d]`` on rank ``d`` (``objs`` is ignored on the
        other ranks)."""
        out = [None]
        dist.scatter_object_list(out, objs if self.rank == 0 else None, src=0)
        return out[0]


def init_ranks(n_pods: int, lanes: int, *, rank: int | None = None,
               world_size: int | None = None, init_method: str | None = None,
               backend: str = "gloo",
               timeout: float = DEFAULT_TIMEOUT) -> RankGroups:
    """Initialise the default process group (unless it already is, as a
    launcher may leave it) and this process's :class:`RankGroups`.

    ``init_method`` defaults to ``env://`` (``MASTER_ADDR``, ``RANK``, ...
    as torchrun sets them); ``timeout`` bounds every collective's wait for
    a peer.  The world size must be ``n_pods * lanes``.
    """
    if not dist.is_initialized():
        kw = {} if rank is None else {"rank": rank}
        if world_size is not None:
            kw["world_size"] = world_size
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            timeout=datetime.timedelta(seconds=timeout), **kw)
    return rank_groups(n_pods, lanes)


def rank_groups(n_pods: int, lanes: int) -> RankGroups:
    """This process's mesh for the (n_pods, lanes) grid, made on first use
    over the initialised default group (every process must ask in the same
    order); raises when there is none."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "ranks='process' needs an initialised torch.distributed default "
            "group of n_pods * lanes ranks: call "
            "repro_torch.core.nap_collectives.init_ranks, or start the ranks "
            "with repro_torch.launch.ranks.spawn")
    mesh = _MESHES.get((n_pods, lanes))
    if mesh is None:
        mesh = _MESHES[(n_pods, lanes)] = RankGroups(n_pods, lanes)
    return mesh


def close_ranks() -> None:
    """Drop this process's meshes and destroy the default group."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def hier_psum(x: torch.Tensor, n_pods: int, lanes: int,
              strategy: str = "nap3", log: list | None = None,
              ranks: RankGroups | None = None, tag=None) -> torch.Tensor:
    """All-reduce over all ranks of the per-rank partials ``x`` (``[D, ...]``);
    every rank gets the total.  ``nap3`` = RS(fast) → AR(slow) → AG(fast):
    the slow axis carries 1/|fast| of the bytes (paper Fig. 12).  With
    ``ranks``, ``x`` is this process's ``[1, ...]`` and the steps are
    collectives between the processes (``tag`` labels their tally)."""
    if ranks is not None:
        return _psum_ranks(x, lanes, strategy, log, ranks, tag)
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
                    strategy: str = "nap3", log: list | None = None,
                    ranks: RankGroups | None = None,
                    tag=None) -> torch.Tensor:
    """All-gather of ``x`` (``[D, m] + ext``) along dim 1 over all ranks, with
    pod-major result layout: every rank gets ``[D * m] + ext``.  With
    ``ranks``, ``x`` is this process's ``[1, m] + ext``."""
    if ranks is not None:
        return _all_gather_ranks(x, strategy, log, ranks, tag)
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


def _psum_ranks(x, lanes, strategy, log, ranks: RankGroups, tag):
    """:func:`hier_psum` between processes: the same steps, the same
    pieces (rank (P, L) reduces piece L), the result bit-identical on every
    rank."""
    if strategy == "flat":
        return ranks.all_reduce(x, "world", tag, log)
    if strategy != "nap3":
        raise ValueError(f"hier_psum: unknown strategy {strategy!r}")
    flat = x.reshape(-1)
    F = flat.shape[0]
    pad = (-F) % lanes
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    piece = ranks.reduce_scatter(flat, "fast", tag, log)
    piece = ranks.all_reduce(piece, "slow", tag, log)
    full = ranks.all_gather(piece, "fast", tag, log).reshape(-1)
    return full[:F].reshape(x.shape)


def _all_gather_ranks(x, strategy, log, ranks: RankGroups, tag):
    """:func:`hier_all_gather` between processes, the result pod-major."""
    ext = tuple(x.shape[2:])
    if strategy == "flat":
        full = ranks.all_gather(x[0], "world", tag, log)
    else:
        pod = ranks.all_gather(x[0], "fast", tag, log)          # [lanes, m]
        full = ranks.all_gather(pod.reshape((-1,) + ext), "slow", tag, log)
    return full.reshape((1, -1) + ext)


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
                  log: list | None = None, ranks: RankGroups | None = None,
                  tag=None) -> torch.Tensor:
    """Every rank's halo values: ``[D, halo_len] + ext``.

    ``x`` is the rank-stacked local vector, ``[D, local_n]`` for one RHS or
    ``[D, local_n, k]`` for a multi-RHS batch (the trailing dims ride along
    through one exchange).  ``send_idx``/``recv_sel``/``pool_sel`` are the
    plan's index arrays as int64 tensors on ``x``'s device.

    With ``ranks`` (one process per rank), ``x`` and the index arrays are
    this rank's ``[1, ...]`` rows and the exchange runs between the
    processes; the pool a rank receives is element for element the stacked
    form's row, so ``recv_sel`` selects the same entries.
    """
    if ranks is not None:
        return _halo_ranks(x, plan, send_idx, recv_sel, pool_sel, log, ranks,
                           tag)
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


def _halo_ranks(x, plan: HaloPlan, send_idx, recv_sel, pool_sel, log,
                ranks: RankGroups, tag):
    """:func:`halo_exchange` between processes.  The per-process pack is
    ``[P_dst(, L_dst), K] + ext``; ``all_to_all_single`` splits dim 0, so the
    destination axis of each swap is moved to the front before it and the
    source axis back after it.  The pool comes out as the stacked form's:
    ``[src pod, src lane, K]`` (standard), ``[lanes, n_pods, K]`` (nap2 and
    nap3)."""
    P, L = plan.n_pods, plan.lanes
    ext = tuple(x.shape[2:])
    if plan.strategy == "standard":
        K = send_idx.shape[-1]
        buf = _take(x, send_idx).reshape((P, L, K) + ext)    # [P_dst, L_dst]
        buf = ranks.all_to_all(buf, "slow", tag, log)        # [P_src, L_dst]
        buf = ranks.all_to_all(buf.transpose(0, 1), "fast", tag, log)
        pool = buf.transpose(0, 1)                           # [P_src, L_src]
    elif plan.strategy == "nap2":
        K = send_idx.shape[-1]
        buf = _take(x, send_idx).reshape((P, K) + ext)       # [P_dst, K]
        buf = ranks.all_to_all(buf, "slow", tag, log)        # [P_src, K]
        pool = ranks.all_gather(buf, "fast", tag, log)       # [lanes, P_src]
    elif plan.strategy == "nap3":
        contrib = _take(x, send_idx).reshape((-1,) + ext)    # [n_pods * Kc]
        pod_pool = ranks.all_gather(contrib, "fast", tag, log)
        pod_pool = pod_pool.reshape((1, -1) + ext)           # [lanes, P, Kc]
        K3 = pool_sel.shape[-1]
        out_buf = _take(pod_pool, pool_sel).reshape((P, K3) + ext)
        out_buf = ranks.all_to_all(out_buf, "slow", tag, log)   # [P_src, K3]
        pool = ranks.all_gather(out_buf, "fast", tag, log)   # [lanes, P_src]
    else:
        raise ValueError(plan.strategy)
    return _take(pool.reshape((1, plan.pool_len) + ext), recv_sel)
