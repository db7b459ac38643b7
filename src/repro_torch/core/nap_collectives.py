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
* :func:`hier_all_to_all` — flat or two-hop all-to-all: a2a(fast) then
  a2a(slow), one aggregated message per pod pair (the MoE dispatch).
* :func:`fast_reduce_scatter`, :func:`slow_all_gather`,
  :func:`fast_all_gather` — single legs over one group, for a caller that
  changes the data between them (the int8 gradient sync of
  :mod:`repro_torch.train.grad_sync`).
* :class:`MatrixHaloPlan` / :func:`matrix_halo_exchange` — the setup
  phase's matrix communication: whole CSR rows of B move under the same §3
  schedules, executed on the host rank-faithfully (phase by phase, message
  by message), with measured message and byte counters.

**One process per rank.**  :class:`RankGroups` is the port's counterpart of
the reference's ``("pod", "lane")`` mesh: this process's rank on the grid,
the world group, its pod's **fast** group (the pod's ``lanes`` ranks) and
its lane's **slow** group (the ``n_pods`` ranks that share the lane), all
``torch.distributed`` process groups (:func:`init_ranks`).  Passed as
``ranks=`` to the four exchanges above, it makes every step a real
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
# hier_all_to_all: per shuffle (the MoE dispatch consumer)
ALL_TO_ALL_SIGNATURES: dict[str, tuple[str, ...]] = {
    "flat": ("all_to_all",),
    "nap3": ("all_to_all", "all_to_all"),
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


def all_to_all_signature(strategy: str = "nap3") -> tuple[str, ...]:
    """Collectives one :func:`hier_all_to_all` call lowers to."""
    return ALL_TO_ALL_SIGNATURES[strategy]


# --------------------------------------------------------------------------
# Collective primitives over the stacked rank dim
# --------------------------------------------------------------------------


class SizedLog(list):
    """A collective log (the names, as a plain ``list`` log holds them)
    that also records, for the stacked halo exchange's collectives, each
    one's result bytes a rank and whether it runs over the pod axis:
    ``records`` holds ``(name, bytes a rank, crosses_pod)``."""

    def __init__(self, n_devices: int):
        super().__init__()
        self.n_devices = n_devices
        self.records: list[tuple[str, float, bool]] = []


def _note(log: list | None, name: str, out: torch.Tensor | None = None,
          crosses_pod: bool = False) -> None:
    if log is not None:
        log.append(name)
        if out is not None and isinstance(log, SizedLog):
            log.records.append((name, out.numel() * out.element_size()
                                / log.n_devices, crosses_pod))


def _all_to_all(v: torch.Tensor, rank_dim: int, chunk_dim: int,
                log: list | None) -> torch.Tensor:
    """Untiled all-to-all along one mesh axis: on a view whose ``rank_dim``
    indexes the sender's coordinate on that axis and ``chunk_dim`` the
    destination's, chunk ``c`` of rank ``r`` becomes chunk ``r`` of rank
    ``c`` — a swap of the two dims (axis 0 of the views is the pod)."""
    out = v.transpose(rank_dim, chunk_dim)
    _note(log, "all_to_all", out, crosses_pod=rank_dim == 0)
    return out


def _all_gather_lanes(v: torch.Tensor, log: list | None) -> torch.Tensor:
    """All-gather over the lane axis of a ``[n_pods, lanes, ...]`` view:
    every lane of pod P receives ``[lanes, ...]`` stacked lane-first."""
    n_pods, lanes = v.shape[:2]
    out = v.unsqueeze(1).expand((n_pods, lanes) + tuple(v.shape[1:]))
    _note(log, "all_gather", out)
    return out


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


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, ranks, group, tag, log):
        ctx.args = (ranks, group, tag)
        return ranks._all_to_all(v, group, tag, log)

    @staticmethod
    def backward(ctx, g):
        ranks, group, tag = ctx.args
        return ranks._all_to_all(g, group, tag, None), None, None, None, None


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, ranks, group, tag):
        ctx.args = (ranks, group, tag)
        return v.view_as(v)

    @staticmethod
    def backward(ctx, g):
        ranks, group, tag = ctx.args
        return ranks._all_reduce(g, group, tag, None), None, None, None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, ranks, group, tag, log):
        return ranks._all_reduce(v, group, tag, log)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None


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
#: the collectives that sum (their canonical names)
_SUMS = ("psum", "psum_scatter")
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
    whose piece it is in), padding included; ``sent_bytes`` the same at
    the type sent (a bfloat16 sum travels as float32).  ``seconds`` holds the
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
        self.sent_bytes: Counter = Counter()
        self.seconds: Counter = Counter()

    @classmethod
    def from_mesh(cls, mesh, axes) -> "RankGroups":
        """This process's grid over the axes ``axes`` of a
        :class:`~torch.distributed.device_mesh.DeviceMesh` (the reference's
        ``shard_map`` axes): one axis is a ``1 x size`` grid whose ``world``
        and ``fast`` group are that axis's group; two axes are (slow, fast),
        ``n_pods x lanes``, with ``world`` their product.  Every process
        makes every group of a two-axis grid, in the same order."""
        axes = tuple(axes)
        if len(axes) not in (1, 2):
            raise ValueError(f"RankGroups.from_mesh: {len(axes)} axes {axes}")
        names = mesh.mesh_dim_names
        sizes = [mesh.size(names.index(a)) for a in axes]
        coords = [mesh.get_local_rank(a) for a in axes]
        self = cls.__new__(cls)
        if len(axes) == 1:
            (self.lanes,), (self.lane,) = sizes, coords
            self.n_pods, self.pod = 1, 0
            g = mesh.get_group(axes[0])
            self._groups = {"world": (g, self.lanes), "fast": (g, self.lanes)}
        else:
            (self.n_pods, self.lanes), (self.pod, self.lane) = sizes, coords
            dims = [names.index(a) for a in axes]
            grid = mesh.mesh.movedim(dims, list(range(len(dims))))
            grid = grid.reshape(self.n_pods * self.lanes, -1)
            world = None
            for col in range(grid.shape[1]):    # every process, same order
                members = grid[:, col].tolist()
                g = dist.new_group(members)
                if dist.get_rank() in members:
                    world = g
            self._groups = {"world": (world, self.size),
                            "fast": (mesh.get_group(axes[1]), self.lanes),
                            "slow": (mesh.get_group(axes[0]), self.n_pods)}
        self.rank = self.pod * self.lanes + self.lane
        self.backend = str(dist.get_backend(self._groups["fast"][0]))
        self.staged = self.backend == "gloo"
        self.sent, self.sent_bytes, self.seconds = Counter(), Counter(), Counter()
        return self

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
        self.sent_bytes.clear()
        self.seconds.clear()

    # -- the collectives (each logs its canonical name and tallies) --------
    def _run(self, op, v: torch.Tensor, group: str, tag, log, name: str,
             chunked: bool, out_shape) -> torch.Tensor:
        """One collective ``op(out, src, pg)`` over ``group``: log ``name``,
        tally what it sends (``chunked``: each peer receives one ``1/size``
        chunk of ``v``, else all of it), stage a card tensor through the
        host on gloo, and time it.  ``out_shape(src, size)`` is the output's
        shape.  A sum of bfloat16 runs in float32 and rounds once, as the
        stacked ranks' ``.sum`` over the rank dim does (gloo's bfloat16 sum
        rounds after each add, and NCCL's may)."""
        _note(log, name)
        pg, size = self._groups[group]
        n = v.numel() // size if chunked else v.numel()
        src = v.contiguous()
        if name in _SUMS and src.dtype == torch.bfloat16:
            src = src.float()
        self.sent[(group, tag)] += n * (size - 1)
        self.sent_bytes[(group, tag)] += n * (size - 1) * src.element_size()
        if self.staged and src.is_cuda:
            # the copy to the host waits for the card anyway: wait first,
            # so the clock starts with the collective
            torch.cuda.current_stream(src.device).synchronize()
        t0 = time.perf_counter()
        if self.staged:
            src = src.cpu()
        out = src.new_empty(out_shape(src, size))
        op(out, src, pg)
        out = out.to(device=v.device, dtype=v.dtype)
        self.seconds[(group, tag)] += time.perf_counter() - t0
        return out

    def all_to_all(self, v: torch.Tensor, group: str, tag=None,
                   log: list | None = None) -> torch.Tensor:
        """Chunk ``j`` of ``v``'s dim 0 goes to member ``j`` of ``group``;
        chunk ``i`` of the result came from member ``i``.  Differentiable:
        its gradient is the same all-to-all of the output's gradient."""
        if torch.is_grad_enabled() and v.requires_grad:
            return _AllToAll.apply(v, self, group, tag, log)
        return self._all_to_all(v, group, tag, log)

    def _all_to_all(self, v, group, tag, log):
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
        """The sum of ``v`` over the group, on every member.
        Differentiable for a sum every member then reads whole (a tensor-
        parallel partial sum): the gradient passes as it is."""
        if torch.is_grad_enabled() and v.requires_grad:
            return _SumReplicated.apply(v, self, group, tag, log)
        return self._all_reduce(v, group, tag, log)

    def grad_sum(self, v: torch.Tensor, group: str, tag=None) -> torch.Tensor:
        """``v`` as it is, its gradient summed over the group: the input of
        a tensor-parallel region that every member reads whole and that
        :meth:`all_reduce` closes (each member's gradient is then the share
        of its slice of the weights)."""
        if torch.is_grad_enabled() and v.requires_grad:
            return _GradSum.apply(v, self, group, tag)
        return v

    def _all_reduce(self, v, group, tag, log):
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


def fast_reduce_scatter(x: torch.Tensor, n_pods: int, lanes: int,
                        log: list | None = None,
                        ranks: RankGroups | None = None,
                        tag=None) -> torch.Tensor:
    """Reduce-scatter inside each pod (NAP-3's first leg on its own):
    per-rank ``x`` ``[D, F]`` with ``F % lanes == 0`` → rank (P, L) holds its
    pod's sum of piece L, ``[D, F / lanes]``.  With ``ranks``, ``x`` is this
    process's ``[1, F]``."""
    if ranks is not None:
        return ranks.reduce_scatter(x[0], "fast", tag, log)[None]
    _note(log, "psum_scatter")
    return x.reshape(n_pods, lanes, lanes, -1).sum(dim=1) \
        .reshape(n_pods * lanes, -1)


def slow_all_gather(x: torch.Tensor, n_pods: int, lanes: int,
                    log: list | None = None, ranks: RankGroups | None = None,
                    tag=None) -> torch.Tensor:
    """All-gather over the slow group (the ranks that share a lane), untiled:
    per-rank ``x`` ``[D, ...]`` → ``[D, n_pods, ...]``, rank (P, L) getting
    every pod's lane-L ``x`` in pod order.  With ``ranks``, ``x`` is this
    process's ``[1, ...]``."""
    if ranks is not None:
        return ranks.all_gather(x[0], "slow", tag, log)[None]
    _note(log, "all_gather")
    ext = tuple(x.shape[1:])
    by_lane = x.reshape((n_pods, lanes) + ext).transpose(0, 1)   # [L, P_src]
    return by_lane.unsqueeze(0).expand((n_pods, lanes, n_pods) + ext) \
        .reshape((n_pods * lanes, n_pods) + ext)


def fast_all_gather(x: torch.Tensor, n_pods: int, lanes: int,
                    log: list | None = None, ranks: RankGroups | None = None,
                    tag=None) -> torch.Tensor:
    """All-gather inside each pod, tiled (NAP-3's last leg on its own):
    per-rank ``x`` ``[D, n]`` (or ``[n_pods, lanes, n]``) → ``[D, lanes *
    n]``, the pod's pieces in lane order.  With ``ranks``, ``x`` is this
    process's ``[1, n]``."""
    if ranks is not None:
        return ranks.all_gather(x[0], "fast", tag, log).reshape(1, -1)
    return _all_gather_lanes(x.reshape(n_pods, lanes, -1), log) \
        .reshape(n_pods * lanes, -1)


def hier_psum(x: torch.Tensor, n_pods: int, lanes: int,
              strategy: str = "nap3", log: list | None = None,
              ranks: RankGroups | None = None, tag=None) -> torch.Tensor:
    """All-reduce over all ranks of the per-rank partials ``x`` (``[D, ...]``);
    every rank gets the total.  ``nap3`` = RS(fast) → AR(slow) → AG(fast):
    the slow axis carries 1/|fast| of the bytes (paper Fig. 12).  With
    ``ranks``, ``x`` is this process's ``[1, ...]`` and the steps are
    collectives between the processes (``tag`` labels their tally), the
    same pieces (rank (P, L) reduces piece L), the result bit-identical on
    every rank."""
    if strategy == "flat":
        if ranks is not None:
            return ranks.all_reduce(x, "world", tag, log)
        _note(log, "psum")
        return x.sum(dim=0, keepdim=True).expand(x.shape)
    if strategy != "nap3":
        raise ValueError(f"hier_psum: unknown strategy {strategy!r}")
    flat = x.reshape(x.shape[0], -1)
    F = flat.shape[1]
    pad = (-F) % lanes
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    # 1) reduce-scatter inside the pod: rank (P, L) keeps piece L
    piece = fast_reduce_scatter(flat, n_pods, lanes, log, ranks, tag)
    # 2) one aggregated inter-pod reduction per piece
    if ranks is not None:
        piece = ranks.all_reduce(piece, "slow", tag, log)
    else:
        _note(log, "psum")
        # left [n_pods, lanes, n] with the pod dim broadcast: step 3 then
        # copies nothing either (the result is a view of one pod's sums)
        piece = piece.reshape(n_pods, lanes, -1).sum(dim=0, keepdim=True) \
            .expand(n_pods, lanes, -1)
    # 3) redistribute inside the pod (tiled: pieces concatenate in lane order)
    full = fast_all_gather(piece, n_pods, lanes, log, ranks, tag)
    return full[:, :F].reshape(x.shape)


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


def hier_all_to_all(x: torch.Tensor, n_pods: int, lanes: int,
                    strategy: str = "nap3", log: list | None = None,
                    ranks: RankGroups | None = None) -> torch.Tensor:
    """All-to-all over all ranks: ``x`` is ``[D, D, ...]``, sender rank
    then destination chunk (pod-major); rank ``e`` receives ``[D, ...]``
    with chunk ``e`` of every sender ``d`` at index ``d``.

    ``flat`` is one all-to-all over both rank axes.  ``nap3`` routes
    pod-crossing chunks as one aggregated message per pod pair: a2a over the
    lanes (lane ``l`` collects its pod's chunks bound for lane ``l`` of
    every pod), then a2a over the pods.  Two hops put every chunk where it
    belongs, so ``nap3`` equals ``flat`` bit for bit (the reference's
    docstring speaks of a third, redistributing step; its code and its
    signature have two).  With ``ranks``, ``x`` is this process's
    ``[1, D, ...]``."""
    if strategy not in ALL_TO_ALL_SIGNATURES:
        raise ValueError(f"hier_all_to_all: unknown strategy {strategy!r}")
    D = n_pods * lanes
    if x.shape[1] != D:
        raise ValueError(f"hier_all_to_all: {x.shape[1]} chunks for {D} ranks")
    if ranks is not None:
        if strategy == "nap3" and (n_pods, lanes) != (ranks.n_pods,
                                                       ranks.lanes):
            raise ValueError(f"hier_all_to_all: a {n_pods} x {lanes} grid "
                             f"over {ranks.n_pods} x {ranks.lanes} ranks")
        return _all_to_all_ranks(x, n_pods, lanes, strategy, log, ranks)
    ext = tuple(x.shape[2:])
    if strategy == "flat":
        return _all_to_all(x, 0, 1, log).reshape(x.shape)
    v = x.reshape((n_pods, lanes, n_pods, lanes) + ext)
    v = _all_to_all(v, 1, 3, log)        # lane axis: [P_src, l_dst, P_dst, l_src]
    v = _all_to_all(v, 0, 2, log)        # pod axis:  [P_dst, l_dst, P_src, l_src]
    return v.reshape(x.shape)


def _all_to_all_ranks(x, n_pods, lanes, strategy, log, ranks: RankGroups):
    """:func:`hier_all_to_all` between processes, the result in the stacked
    form's order (source pod-major)."""
    ext = tuple(x.shape[2:])
    if strategy == "flat":
        return ranks.all_to_all(x[0], "world", log=log)[None]
    v = x[0].reshape((n_pods, lanes) + ext).transpose(0, 1)  # [l_dst, P_dst]
    v = ranks.all_to_all(v, "fast", log=log)                 # [l_src, P_dst]
    v = ranks.all_to_all(v.transpose(0, 1), "slow", log=log)  # [P_src, l_src]
    return v.reshape(x.shape)


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


# --------------------------------------------------------------------------
# DTensor on a DeviceMesh (the mesh shardings and the dry-run): the
# placements, the rank-by-rank regions and the process-group plumbing, so
# that every torch.distributed call of the port stays in this module.  The
# collectives DTensor issues under these are not NAP strategies; the
# dry-run logs them (repro_torch.launch.roofline.CollectiveLog).
# --------------------------------------------------------------------------

def replicate():
    """The ``Replicate()`` placement."""
    from torch.distributed.tensor import Replicate
    return Replicate()


def shard(dim: int):
    """The ``Shard(dim)`` placement."""
    from torch.distributed.tensor import Shard
    return Shard(dim)


def partial():
    """The ``Partial()`` (pending sum) placement."""
    from torch.distributed.tensor import Partial
    return Partial()


def distribute(t: torch.Tensor, mesh, placements):
    """``distribute_tensor``: ``t`` (whole on every rank) placed on
    ``mesh``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, list(placements))


def from_local(t: torch.Tensor, mesh, placements):
    """A DTensor of this rank's shard ``t`` (no check, no collective)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, list(placements), run_check=False)


def local_region(fn, out_placements, in_placements, mesh,
                 redistribute_inputs: bool = False, in_grad_placements=None):
    """``local_map``: ``fn`` runs on each rank's shards (plain tensors);
    ``out_placements`` a list for one output.  ``in_grad_placements``: each
    input's gradient placements (by default the input's own; see
    :func:`summed_grad`)."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=redistribute_inputs)


def summed_grad(placements, data_placements) -> tuple:
    """The gradient placements of a ``local_map`` region's input placed by
    ``placements`` that meets data placed by ``data_placements``: where
    the input is replicated over a mesh dim that the data is sharded over,
    each rank there holds the gradient of its own share of the data, so
    the gradient is ``Partial`` (a pending sum) over that dim, as
    ``shard_map``'s transpose sums it; elsewhere the input's own."""
    return tuple(partial() if p.is_replicate() and d.is_shard() else p
                 for p, d in zip(placements, data_placements))


def implicit_replication():
    """The context in which plain tensors join DTensor operands as
    replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def start_fake_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process rank 0): every collective returns at once, moving
    nothing.  Any default group of another size or backend is torn down
    first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend(), dist.get_world_size()) == ("fake",
                                                          world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=world_size,
                            rank=0)


def default_world_size() -> int | None:
    """The default group's size, ``None`` when none is initialised."""
    return dist.get_world_size() if dist.is_initialized() else None


def end_default_group() -> None:
    """Tear the default process group down (if there is one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def device_mesh(device_type: str, shape: tuple[int, ...],
                names: tuple[str, ...]):
    """``init_device_mesh`` over the default group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def group_ranks(arg) -> tuple[int, ...] | None:
    """The global ranks of a process group given as a group name (a
    functional collective's argument), a ``ProcessGroup`` or its script
    object (a c10d op's); ``None`` for anything else."""
    from torch.distributed import distributed_c10d as c10d
    pg = None
    if isinstance(arg, str):
        try:
            pg = c10d._resolve_process_group(arg)
        except (KeyError, RuntimeError, ValueError):
            return None
    elif isinstance(arg, dist.ProcessGroup):
        pg = arg
    elif isinstance(arg, torch.ScriptObject):
        pg = dist.ProcessGroup.unbox(arg)
    if pg is None:
        return None
    return tuple(dist.get_process_group_ranks(pg))


def group_reduce(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """A functional all-reduce (``op``: "sum", "max") of ``x`` over
    ``group`` (the default group when ``None``), waited for."""
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(
        x, op, dist.group.WORLD if group is None else group))


class _GroupSum(torch.autograd.Function):
    """:func:`group_reduce` "sum" of a value every rank then reads whole;
    backward, each rank's share gets that (replicated) gradient as it
    is."""

    @staticmethod
    def forward(ctx, x, group):
        return group_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def group_sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable :func:`group_reduce` "sum" (see :class:`_GroupSum`)."""
    return _GroupSum.apply(x, group)
