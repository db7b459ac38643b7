"""Bound solvers and the session store (port of ``repro/amg/api/sessions.py``).

A **session** is one (matrix fingerprint, :class:`AMGConfig`) pair bound to a
backend: the object that owns the expensive state — the host ``Hierarchy``
and, for ``backend="torch"``, the lowered
:class:`~repro_torch.amg.dist_solve.DistHierarchy` with its device-resident
level tensors.  With ``setup_backend="dist"`` there is no host
``Hierarchy``: the partitioned setup (:mod:`repro_torch.amg.dist_setup`)
births per-rank levels that are lowered straight onto the card.
:class:`AMGSolver` is the entry point (``AMGSolver(cfg).setup(A)``);
sessions live in a :class:`SessionStore` with
a pluggable :class:`EvictionPolicy` (:class:`LRUPolicy`, :class:`TTLPolicy`,
:class:`BytesBudgetPolicy`) and per-entry setup-cost / hit / streaming-update
accounting; :class:`~repro_torch.amg.api.service.AMGService` instantiates
its own store so its budget and counters are service-scoped.

With ``ranks="process"`` every process of a ``torch.distributed`` group of
``n_pods × lanes`` ranks calls the same entry point with the same ``A`` and
``b``: rank 0 sets up and lowers once, each rank solves on its own slice, and
every rank returns the whole solution and the same residual history.

``BoundSolver.update`` streams ``A + ΔA``: on the frozen pattern a
value-only refresh (the torch backend copies the new values beneath its
captured CUDA graphs), escalating to a full re-setup on a convergence
regression.  A dist-born session refreshes its partitioned levels through
the cached NAP schedules of their Galerkin row exchanges.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ...core.nap_collectives import PROCESS_TODO, rank_groups
from ..csr import CSR
from ..dist_solve import FactorPatternChanged
from ..hierarchy import (Hierarchy, refresh_values as _hierarchy_refresh,
                         setup as _hierarchy_setup)
from ..solve import (MultiSolveResult, SolveOptions, host_pcg, host_solve,
                     host_vcycle)
from .config import (AMGConfig, PatternMismatch, RequestOptions, apply_update,
                     matrix_fingerprint, pattern_fingerprint)
from .registry import backend_class, register_backend


# --------------------------------------------------------------------------
# Session store + eviction policies
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CacheEntry:
    """One stored session with the accounting eviction policies consume."""

    value: object
    nbytes: int = 0
    setup_cost: float = 0.0       # seconds it took to build the value
    hits: int = 0
    created: float = 0.0
    last_used: float = 0.0
    # optional re-measure hook: a torch session lowers its device arrays
    # lazily on first solve, so resident bytes grow after the put
    nbytes_fn: object = dataclasses.field(default=None, repr=False,
                                          compare=False)

    def refresh_nbytes(self) -> None:
        if self.nbytes_fn is not None:
            self.nbytes = int(self.nbytes_fn())


class EvictionPolicy:
    """Decides what a :class:`SessionStore` drops: :meth:`expired` per entry
    on every access, :meth:`victims` after an insert."""

    name = "none"

    def expired(self, entry: CacheEntry, now: float) -> bool:
        return False

    def victims(self, entries: "OrderedDict[object, CacheEntry]",
                now: float) -> list:
        return []


class LRUPolicy(EvictionPolicy):
    """Bounded entry count, least-recently-used first."""

    name = "lru"

    def __init__(self, max_entries: int = 16):
        self.max_entries = max(1, int(max_entries))

    def victims(self, entries, now):
        n_over = len(entries) - self.max_entries
        return list(entries)[:n_over] if n_over > 0 else []


class TTLPolicy(EvictionPolicy):
    """Idle-time-to-live: an entry not touched for ``ttl`` seconds is
    expired on its next access (plus an optional LRU entry bound)."""

    name = "ttl"

    def __init__(self, ttl: float, max_entries: int | None = None):
        self.ttl = float(ttl)
        self.max_entries = max_entries

    def expired(self, entry, now):
        return now - entry.last_used > self.ttl

    def victims(self, entries, now):
        if self.max_entries is None:
            return []
        n_over = len(entries) - self.max_entries
        return list(entries)[:n_over] if n_over > 0 else []


class BytesBudgetPolicy(EvictionPolicy):
    """Cost-aware bytes budget: while the resident total exceeds
    ``max_bytes``, evict the entry with the lowest *retention value*
    ``setup_cost * (1 + hits) / max(nbytes, 1)`` — sessions that are cheap
    to rebuild, rarely hit or disproportionately large go first (ties
    least-recently-used)."""

    name = "bytes_budget"

    def __init__(self, max_bytes: int, max_entries: int | None = None):
        self.max_bytes = int(max_bytes)
        self.max_entries = max_entries

    @staticmethod
    def retention_value(entry: CacheEntry) -> float:
        return entry.setup_cost * (1 + entry.hits) / max(entry.nbytes, 1)

    def victims(self, entries, now):
        out = []
        if self.max_entries is not None:
            n_over = len(entries) - self.max_entries
            if n_over > 0:
                out.extend(list(entries)[:n_over])
        # recency-ordered iteration makes the min() tie-break LRU
        live = [(k, e) for k, e in entries.items() if k not in out]
        total = sum(e.nbytes for _, e in live)
        while total > self.max_bytes and live:
            k, e = min(live, key=lambda ke: self.retention_value(ke[1]))
            out.append(k)
            live.remove((k, e))
            total -= e.nbytes
        return out


class SessionStore:
    """Keyed session cache with pluggable eviction and accounting.
    Thread-safe (a service's worker and foreground callers may touch it
    concurrently); ``clock`` is injectable for deterministic tests."""

    def __init__(self, policy: EvictionPolicy | None = None,
                 clock=time.monotonic):
        self.policy = policy or LRUPolicy(SESSION_CACHE_SIZE)
        self._clock = clock
        self._entries: "OrderedDict[object, CacheEntry]" = OrderedDict()
        self._lock = threading.RLock()
        self._counters = {"hits": 0, "misses": 0, "puts": 0, "evictions": 0,
                          "expirations": 0, "setup_cost_evicted": 0.0,
                          "refreshes": 0, "resetups": 0}
        # streaming-update trigger reasons ("drift", "regression",
        # "pattern", "evicted") -> count
        self._triggers: dict[str, int] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def get(self, key, default=None):
        now = self._clock()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and self.policy.expired(entry, now):
                self._drop(key, entry, "expirations")
                entry = None
            if entry is None:
                self._counters["misses"] += 1
                return default
            entry.hits += 1
            entry.last_used = now
            self._counters["hits"] += 1
            self._entries.move_to_end(key)
            return entry.value

    def put(self, key, value, *, nbytes: int = 0, setup_cost: float = 0.0,
            nbytes_fn=None) -> None:
        now = self._clock()
        with self._lock:
            self._entries[key] = CacheEntry(value, int(nbytes),
                                            float(setup_cost), 0, now, now,
                                            nbytes_fn)
            self._entries.move_to_end(key)
            self._counters["puts"] += 1
            for e in self._entries.values():     # lazy lowerings may have
                e.refresh_nbytes()               # grown since their put
            for k, e in [(k, e) for k, e in self._entries.items()
                         if self.policy.expired(e, now)]:
                self._drop(k, e, "expirations")
            for k in self.policy.victims(self._entries, now):
                if k in self._entries:
                    self._drop(k, self._entries[k], "evictions")

    def _drop(self, key, entry: CacheEntry, counter: str) -> None:
        del self._entries[key]
        self._counters[counter] += 1
        self._counters["setup_cost_evicted"] += entry.setup_cost

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def rekey(self, old_key, new_key) -> None:
        """Move an entry to a new key without touching its accounting: a
        streamed update changed the value fingerprint, but the session (and
        its setup cost / hit history) is the same."""
        with self._lock:
            entry = self._entries.pop(old_key, None)
            if entry is not None:
                self._entries[new_key] = entry
                self._entries.move_to_end(new_key)

    def note_update(self, action: str, reason: str) -> None:
        """Record a streaming update: ``action`` is ``"refresh"`` (value-only
        hierarchy reuse) or ``"resetup"`` (full re-setup), ``reason`` the
        trigger ("drift", "regression", "pattern", "evicted")."""
        if action not in ("refresh", "resetup"):
            raise ValueError(f"unknown update action {action!r}")
        with self._lock:
            self._counters["refreshes" if action == "refresh"
                           else "resetups"] += 1
            self._triggers[reason] = self._triggers.get(reason, 0) + 1

    def stats(self) -> dict:
        """Counters + resident totals (hit/evict/setup-cost accounting)."""
        with self._lock:
            for e in self._entries.values():
                e.refresh_nbytes()
            return {**self._counters, "policy": self.policy.name,
                    "triggers": dict(self._triggers),
                    "entries": len(self._entries),
                    "bytes": sum(e.nbytes for e in self._entries.values()),
                    "setup_cost_total": sum(e.setup_cost for e in
                                            self._entries.values())}

    def entry_table(self) -> list[dict]:
        """Per-entry accounting rows (for reports)."""
        now = self._clock()
        with self._lock:
            for e in self._entries.values():
                e.refresh_nbytes()
            return [{"key": k, "nbytes": e.nbytes,
                     "setup_cost": e.setup_cost, "hits": e.hits,
                     "idle_s": now - e.last_used}
                    for k, e in self._entries.items()]


def _csr_nbytes(M) -> int:
    return int(M.indptr.nbytes + M.indices.nbytes + M.data.nbytes)


def session_nbytes(value) -> int:
    """Resident-bytes estimate for store accounting: CSR bytes of a host
    hierarchy; for a lowered DistHierarchy its device bytes (level tensors,
    state buffers and graph pool, ``DistHierarchy.nbytes``).  A torch
    session counts the one lowering it solves on, not every lowering its
    hierarchy's ``dist_cache`` holds; a dist-born session (no host
    hierarchy) counts its lowering alone."""
    if value is None:
        return 0
    if isinstance(value, Hierarchy):
        return sum(_csr_nbytes(M) for lv in value.levels
                   for M in (lv.A, lv.P, lv.R) if M is not None)
    if isinstance(value, BoundSolver):
        return (session_nbytes(value.hierarchy)
                + session_nbytes(getattr(value, "_dist", None)))
    return int(getattr(value, "nbytes", 0))


# --------------------------------------------------------------------------
# Bound solvers
# --------------------------------------------------------------------------


class BoundSolver:
    """A hierarchy bound to one backend.  ``solve``/``pcg`` accept ``b`` of
    shape ``[n]`` or ``[n, k]``; the multi-RHS form returns a
    :class:`~repro_torch.amg.solve.MultiSolveResult`."""

    backend_name = "?"
    # ---- streaming-session state, set by AMGSolver.setup.  A solver made
    # through bind_hierarchy has none of it and cannot stream updates.
    _fine: CSR | None = None          # canonical fine-grid CSR of the session
    pattern_fp: str | None = None     # frozen sparsity-pattern fingerprint
    _fingerprint: str | None = None   # full (values) fingerprint = store key
    _store = None                     # SessionStore holding this session
    _store_key = None
    _plevels = None                   # partitioned levels (dist-born setup)
    # convergence tracking for RefreshPolicy: baseline is the first solve
    # after the most recent (re-)setup, last the most recent solve
    baseline_iterations: int | None = None
    last_iterations: int | None = None
    last_update_reason: str | None = None   # trigger of the latest update()

    def __init__(self, config: AMGConfig, hierarchy: Hierarchy | None):
        # ``hierarchy`` is None on the setup_backend="dist" path: the levels
        # were born partitioned and no host Hierarchy ever existed
        self.config = config
        self.hierarchy = hierarchy

    @classmethod
    def from_hierarchy(cls, h: Hierarchy, dist=None,
                       opts: SolveOptions | None = None) -> "BoundSolver":
        return cls(AMGConfig(backend=cls.backend_name,
                             opts=opts or SolveOptions()), h)

    # ------------------------------------------------------------ properties
    @property
    def A(self) -> CSR:
        if self.hierarchy is None:
            raise ValueError(
                "this solver was set up with setup_backend='dist': levels "
                "are partitioned across the ranks and no global fine-grid "
                "CSR exists")
        return self.hierarchy.levels[0].A

    @property
    def n(self) -> int:
        return self.A.nrows

    @property
    def opts(self) -> SolveOptions:
        return self.config.opts

    def staging_dtype(self) -> np.dtype:
        """Host dtype right-hand sides are staged in: float64 sessions stage
        in float64, float32 sessions in float32."""
        return np.dtype(np.float64 if self.config.dtype == "float64"
                        else np.float32)

    def _check_b(self, b) -> np.ndarray:
        """Validate shape and convert ``b`` ONCE to :meth:`staging_dtype`."""
        b = np.asarray(b)
        if b.ndim not in (1, 2) or b.shape[0] != self.n:
            raise ValueError(f"b must be [{self.n}] or [{self.n}, k], "
                             f"got shape {b.shape}")
        return np.asarray(b, dtype=self.staging_dtype())

    # -------------------------------------------------------------- methods
    def solve(self, b, *, tol: float | None = None,
              maxiter: int | None = None, x0=None):
        """Stationary AMG iteration (``config.tol``/``maxiter`` defaults)."""
        res = self._solve(b, tol=tol, maxiter=maxiter, x0=x0)
        self._observe(res)
        return res

    def pcg(self, b, *, tol: float | None = None,
            maxiter: int | None = None, x0=None):
        """AMG-preconditioned CG (``config.tol``/``pcg_maxiter`` defaults)."""
        res = self._pcg(b, tol=tol, maxiter=maxiter, x0=x0)
        self._observe(res)
        return res

    def run(self, b, options: RequestOptions | None = None):
        """One request through the unified knob set (``None`` knobs resolve
        to the session config's defaults)."""
        o = (options or RequestOptions()).resolve(self.config)
        fn = self.pcg if o.method == "pcg" else self.solve
        return fn(b, tol=o.tol, maxiter=o.maxiter, x0=o.x0)

    def _solve(self, b, *, tol=None, maxiter=None, x0=None):
        raise NotImplementedError

    def _pcg(self, b, *, tol=None, maxiter=None, x0=None):
        raise NotImplementedError

    def vcycle(self, b, x0=None):
        raise NotImplementedError

    def _observe(self, result) -> None:
        """Track iteration counts for the adaptive re-setup policy."""
        it = getattr(result, "iterations", None)
        if it is None:
            return
        self.last_iterations = int(it)
        if self.baseline_iterations is None:
            self.baseline_iterations = int(it)

    # ---------------------------------------------------- streaming updates
    def update(self, A_new: CSR | None = None, *, data=None,
               delta=None) -> str:
        """Streaming matrix update on the session's frozen pattern.

        Exactly one of ``A_new`` (full replacement CSR), ``data`` (new
        values in CSR order) or ``delta`` (additive ΔA values).  On a
        pattern match the session performs a **value-only refresh**: the
        Galerkin products re-run numerically onto the frozen levels and the
        new values are lowered onto the frozen layouts, so compiled
        programs (captured graphs on the card) are reused.  When the
        config's :class:`~repro_torch.amg.api.config.RefreshPolicy` says
        convergence has regressed past the post-setup baseline, or a block
        smoother's placed factor changed its pattern, the update escalates
        to a full re-setup.  Returns the action taken
        (``"refresh"`` | ``"resetup"``).  A changed sparsity pattern raises
        :class:`~repro_torch.amg.api.config.PatternMismatch`."""
        if self._fine is None:
            raise ValueError(
                "streaming updates need a session created by "
                "AMGSolver.setup; this solver wraps a bare hierarchy")
        if A_new is None:
            A_new = apply_update(self._fine, data=data, delta=delta)
        elif data is not None or delta is not None:
            raise ValueError("pass A_new or data=/delta=, not both")
        fp_pat = pattern_fingerprint(A_new)
        if fp_pat != self.pattern_fp:
            raise PatternMismatch(
                f"update pattern {fp_pat[:12]} does not match the session's "
                f"frozen pattern {self.pattern_fp[:12]}; a value-only "
                f"refresh is impossible — re-run setup(A_new) for "
                f"structural changes")
        regressed = (self.last_iterations is not None and
                     self.config.refresh.regressed(self.baseline_iterations,
                                                   self.last_iterations))
        if regressed or not self._can_refresh():
            action = "resetup"
            reason = "regression" if regressed else "evicted"
            self._resetup(A_new)
            self.baseline_iterations = None
            self.last_iterations = None
        else:
            action, reason = "refresh", "drift"
            try:
                self._refresh(A_new)
            except FactorPatternChanged:
                # a block smoother's placed triangle cannot take the new
                # values in place
                action, reason = "resetup", "pattern"
                self._resetup(A_new)
                self.baseline_iterations = None
                self.last_iterations = None
        self.last_update_reason = reason
        if self._store is not None:
            self._store.note_update(action, reason)
            self._rekey(A_new)
        return action

    def _rekey(self, A_new: CSR) -> None:
        """Move the store entry onto the updated value fingerprint, so a
        later ``setup(A_new)`` under the same config hits this session."""
        fp = matrix_fingerprint(A_new)
        new_key = (fp,) + tuple(self._store_key[1:])
        self._store.rekey(self._store_key, new_key)
        self._store_key = new_key
        self._fingerprint = fp

    def _can_refresh(self) -> bool:
        return True

    def _refresh(self, A_new: CSR) -> None:
        _hierarchy_refresh(self.hierarchy, A_new)
        self._fine = self.hierarchy.levels[0].A    # re-pointed by refresh

    def _resetup(self, A_new: CSR) -> None:
        self.hierarchy = _hierarchy_setup(A_new,
                                          **self.config.setup_kwargs())
        self._fine = self.hierarchy.levels[0].A


@register_backend("host")
class HostBoundSolver(BoundSolver):
    """Reference numpy backend; multi-RHS runs k independent column solves."""

    def staging_dtype(self) -> np.dtype:
        # the numpy reference always computes in float64
        return np.dtype(np.float64)

    def _per_column(self, fn, b, x0):
        cols, xs = [], []
        for j in range(b.shape[1]):
            r = fn(b[:, j], None if x0 is None else x0[:, j])
            cols.append(r)
            xs.append(r.x)
        return MultiSolveResult(np.stack(xs, axis=1), cols)

    def _solve(self, b, *, tol=None, maxiter=None, x0=None):
        b = self._check_b(b)
        tol = self.config.tol if tol is None else tol
        maxiter = self.config.maxiter if maxiter is None else maxiter
        run = lambda bc, xc: host_solve(self.hierarchy, bc, tol=tol,
                                        maxiter=maxiter, opts=self.opts,
                                        x0=xc)
        if b.ndim == 2:
            return self._per_column(run, b, x0)
        return run(b, x0)

    def _pcg(self, b, *, tol=None, maxiter=None, x0=None):
        b = self._check_b(b)
        tol = self.config.tol if tol is None else tol
        maxiter = self.config.pcg_maxiter if maxiter is None else maxiter
        run = lambda bc, xc: host_pcg(self.hierarchy, bc, tol=tol,
                                      maxiter=maxiter, opts=self.opts, x0=xc)
        if b.ndim == 2:
            return self._per_column(run, b, x0)
        return run(b, x0)

    def vcycle(self, b, x0=None):
        b = self._check_b(b)
        if b.ndim == 2:
            x0c = (lambda j: None) if x0 is None else (lambda j: x0[:, j])
            return np.stack([host_vcycle(self.hierarchy, b[:, j], x0c(j),
                                         self.opts)
                             for j in range(b.shape[1])], axis=1)
        return host_vcycle(self.hierarchy, b, x0, self.opts)


@register_backend("torch")
class TorchBoundSolver(BoundSolver):
    """Device-resident backend (mirrors the reference's ``DistBoundSolver``):
    lowers the hierarchy onto the rank grid ONCE, on first use, and reuses
    the :class:`~repro_torch.amg.dist_solve.DistHierarchy` for every call.
    A dist-born session (:meth:`from_dist_setup`) has its lowering from the
    start and no host hierarchy."""

    def __init__(self, config: AMGConfig, hierarchy: Hierarchy | None):
        super().__init__(config, hierarchy)
        self._dist = None

    @classmethod
    def from_hierarchy(cls, h, dist=None, opts=None):
        from ..dist_solve import _ensure_dist
        dh = _ensure_dist(h, dist)             # raises when dist is missing
        self = cls(AMGConfig(backend=cls.backend_name, device=str(dh.device),
                             opts=opts or SolveOptions()), h)
        self._dist = dh
        return self

    @classmethod
    def from_dist_setup(cls, config: AMGConfig, dh) -> "TorchBoundSolver":
        """Bind an already-lowered ``DistHierarchy`` with no host
        ``Hierarchy``: one **born partitioned** (the ``setup_backend="dist"``
        path), or this process's rank slice (``ranks="process"``)."""
        self = cls(config, None)
        self._dist = dh
        return self

    @property
    def n(self) -> int:
        if self.hierarchy is None:
            return self._dist.levels[0].A.row_part.n
        return self.A.nrows

    def staging_dtype(self) -> np.dtype:
        # an already-lowered hierarchy is the source of truth
        if self._dist is not None:
            return np.dtype(np.float64 if self._dist.dtype == torch.float64
                            else np.float32)
        return super().staging_dtype()

    @property
    def dist_hierarchy(self):
        """The lowered hierarchy; built on first access, then reused (through
        the hierarchy's ``dist_cache``, shared by bound solvers that share a
        hierarchy and the build knobs)."""
        if self._dist is None:
            from ..dist_solve import _ensure_dist
            self._dist = _ensure_dist(self.hierarchy,
                                      self.config.dist_build_kwargs())
        return self._dist

    def _solve(self, b, *, tol=None, maxiter=None, x0=None):
        from ..dist_solve import dist_solve
        b = self._check_b(b)
        tol = self.config.tol if tol is None else tol
        maxiter = self.config.maxiter if maxiter is None else maxiter
        return dist_solve(self.dist_hierarchy, b, tol=tol, maxiter=maxiter,
                          opts=self.opts, x0=x0)

    def _pcg(self, b, *, tol=None, maxiter=None, x0=None):
        from ..dist_solve import dist_pcg
        b = self._check_b(b)
        tol = self.config.tol if tol is None else tol
        maxiter = self.config.pcg_maxiter if maxiter is None else maxiter
        return dist_pcg(self.dist_hierarchy, b, tol=tol, maxiter=maxiter,
                        opts=self.opts, x0=x0)

    def vcycle(self, b, x0=None):
        from ..dist_solve import dist_vcycle
        if x0 is not None:
            raise ValueError("the torch backend's vcycle starts from x=0; "
                             "x0= is not supported")
        return dist_vcycle(self.dist_hierarchy, self._check_b(b), self.opts)

    # ---------------------------------------------------- streaming updates
    def update(self, A_new: CSR | None = None, *, data=None,
               delta=None) -> str:
        if self.config.ranks == "process":
            raise NotImplementedError(f"update {PROCESS_TODO}")
        return super().update(A_new, data=data, delta=delta)

    def _can_refresh(self) -> bool:
        # a dist-born session refreshes through its partitioned levels; if
        # they were evicted from the setup store, only a full re-setup can
        # honor the update
        return self.hierarchy is not None or self._plevels is not None

    def _refresh(self, A_new: CSR) -> None:
        """The reference's ``DistBoundSolver._refresh``.  Host-setup
        sessions: the hierarchy refresh re-lowers every DistHierarchy in its
        ``dist_cache`` in place; a prebuilt lowering that bypassed the cache
        is refreshed explicitly.  Dist-born sessions: the Galerkin products
        replay through the cached NAP schedules onto the partitioned levels,
        whose values are then copied beneath the lowering's graphs."""
        if self.hierarchy is not None:
            _hierarchy_refresh(self.hierarchy, A_new)
            self._fine = self.hierarchy.levels[0].A
            cached = self.hierarchy.dist_cache.values()
            if self._dist is not None and \
                    all(dh is not self._dist for dh in cached):
                self._dist.refresh_values(self.hierarchy.levels)
            return
        from ..dist_setup import refresh_partitioned_values
        refresh_partitioned_values(self._plevels, A_new)
        if self._dist is not None:
            self._dist.refresh_values(self._plevels)
        # copy-on-write, as on the host path: never mutate the caller's A
        self._fine = CSR(self._fine.shape, self._fine.indptr,
                         self._fine.indices,
                         np.array(A_new.data, dtype=np.float64))

    def _resetup(self, A_new: CSR) -> None:
        if self.hierarchy is not None:
            super()._resetup(A_new)
            self._dist = None            # lowered again lazily on next solve
            return
        from ...core import MACHINES
        from ..dist_setup import dist_setup_partitioned
        from ..dist_solve import DistHierarchy
        c = self.config
        plevels, records = dist_setup_partitioned(
            A_new, c.n_pods, c.lanes, params=MACHINES[c.machine],
            strategy=c.strategy, **c.setup_kwargs())
        bk = c.dist_build_kwargs()
        self._dist = DistHierarchy.from_partitioned(
            plevels, bk.pop("n_pods"), bk.pop("lanes"),
            setup_records=records, **bk)
        self._plevels = plevels
        self._fine = A_new


# --------------------------------------------------------------------------
# The session object + default stores
# --------------------------------------------------------------------------

SESSION_CACHE_SIZE = 16
# module-level defaults: independent AMGSolver callers share sessions
_SESSIONS = SessionStore(LRUPolicy(SESSION_CACHE_SIZE))
# hierarchies keyed by (matrix fingerprint, setup kwargs) only, so configs
# that differ in solve/backend knobs share one setup (and, through the
# hierarchy's dist_cache, one lowering).  setup_backend="dist" entries hold
# the partitioned levels and a born-partitioned DistHierarchy instead of a
# host Hierarchy (keyed with the rank-grid/strategy/lowering knobs they
# depend on).
_SETUPS = SessionStore(LRUPolicy(SESSION_CACHE_SIZE))


def clear_sessions() -> None:
    _SESSIONS.clear()
    _SETUPS.clear()


def session_count() -> int:
    return len(_SESSIONS)


class AMGSolver:
    """The session entry point: ``AMGSolver(config).setup(A)`` returns a
    :class:`BoundSolver` cached per (matrix fingerprint, config); configs
    that differ only in knobs irrelevant to the setup phase share ONE host
    hierarchy.  ``store`` / ``setup_store`` override the module-level
    default :class:`SessionStore` s.

    ``ranks="process"`` needs this process's default ``torch.distributed``
    group of ``n_pods * lanes`` ranks (:attr:`ranks` is its
    :class:`~repro_torch.core.nap_collectives.RankGroups`): every process
    makes its solvers and sessions in the same order."""

    def __init__(self, config: AMGConfig | None = None, *,
                 store: SessionStore | None = None,
                 setup_store: SessionStore | None = None, **overrides):
        if config is None:
            config = AMGConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        backend_class(config.backend)        # fail fast on unknown backend
        self.ranks = (rank_groups(config.n_pods, config.lanes)
                      if config.ranks == "process" else None)
        self.config = config
        self.store = store if store is not None else _SESSIONS
        self.setup_store = (setup_store if setup_store is not None
                            else _SETUPS)

    def setup(self, A: CSR, *, fingerprint: str | None = None) -> BoundSolver:
        """Bind ``A`` under this config (cached).  ``fingerprint=`` skips
        re-hashing when the caller already knows the matrix fingerprint."""
        fp = fingerprint or matrix_fingerprint(A)
        key = (fp, self.config)
        bound = self.store.get(key)
        if self.ranks is not None:
            # one process per rank: every rank must hold the same A, and a
            # cached session is used only where every rank has it (a rank
            # that sets up alone would wait for the others forever)
            self.ranks.check_same(fp, "matrix fingerprint")
            if not self.ranks.all_true(bound is not None):
                bound = None
        if bound is not None:
            return bound
        t0 = time.perf_counter()
        if self.config.setup_backend == "dist":
            bound = self._setup_dist(A, fp)
        elif self.ranks is not None:
            bound = self._setup_process(A, fp)
        else:
            bound = backend_class(self.config.backend)(
                self.config, self._host_hierarchy(A, fp))
        # streaming-session state: the canonical fine CSR (the hierarchy's
        # own level-0 object on host-setup sessions, so delta updates
        # compose), the frozen pattern fingerprint and the store linkage
        # update() re-keys
        bound._fine = (bound.hierarchy.levels[0].A
                       if bound.hierarchy is not None else A)
        bound._fingerprint = fp
        bound.pattern_fp = pattern_fingerprint(A)
        bound._store = self.store
        bound._store_key = key
        # nbytes_fn: a torch session's device tensors are lowered lazily on
        # first solve, so resident bytes are re-measured at eviction time
        self.store.put(key, bound, nbytes=session_nbytes(bound),
                       setup_cost=time.perf_counter() - t0,
                       nbytes_fn=lambda: session_nbytes(bound))
        return bound

    def _host_hierarchy(self, A: CSR, fp: str) -> Hierarchy:
        """The host setup of ``A`` under this config's setup knobs, shared
        through :attr:`setup_store` by every config with the same knobs."""
        skw = self.config.setup_kwargs()
        skey = (fp, tuple(sorted(skw.items())))
        h = self.setup_store.get(skey)
        if h is None:
            t1 = time.perf_counter()
            h = _hierarchy_setup(A, **skw)
            self.setup_store.put(skey, h, nbytes=session_nbytes(h),
                                 setup_cost=time.perf_counter() - t1)
        return h

    def _setup_process(self, A: CSR, fp: str) -> BoundSolver:
        """The ranks="process" path: rank 0 runs the host setup (shared as
        on the stacked path) and the lowering once, every rank receives its
        slice (:meth:`~repro_torch.amg.dist_solve.DistHierarchy.scattered`).
        The slice is cached per (matrix, setup knobs, lowering knobs), so
        configs that differ only in solve knobs share it."""
        from ..dist_solve import DistHierarchy
        c = self.config
        skey = (fp, tuple(sorted(c.setup_kwargs().items())), c.n_pods,
                c.lanes, c.strategy, c.machine, c.dtype, c.device,
                c.use_kernel, c.reduce_strategy, c.overlap, "process")
        dh = self.setup_store.get(skey)
        if not self.ranks.all_true(dh is not None):
            t0 = time.perf_counter()
            h = self._host_hierarchy(A, fp) if self.ranks.rank == 0 else None
            t_setup = time.perf_counter() - t0
            bk = c.dist_build_kwargs()
            del bk["n_pods"], bk["lanes"]
            dh = DistHierarchy.scattered(h, self.ranks, **bk)
            dh.timings["setup_s"] = t_setup
            self.setup_store.put(skey, dh, nbytes=session_nbytes(dh),
                                 setup_cost=time.perf_counter() - t0)
        return backend_class(c.backend).from_dist_setup(c, dh)

    def _setup_dist(self, A: CSR, fp: str) -> BoundSolver:
        """The setup_backend="dist" path: run the partitioned node-aware
        setup (NAP SpGEMM Galerkin products) and bind the resulting
        DistHierarchy.  Two cache tiers mirror the host path's setup/lower
        split: the partitioned blocks are keyed by the knobs the setup loop
        depends on (setup kwargs + rank grid + strategy + machine), the
        lowered DistHierarchy additionally by the pure lowering knobs — so
        configs differing only in dtype/device/kernel/reduce knobs re-lower
        but never re-run the setup loop, and solve-knob-only changes share
        both."""
        c = self.config
        base = (fp, tuple(sorted(c.setup_kwargs().items())),
                c.n_pods, c.lanes, c.strategy, c.machine)
        pkey = base + ("dist_partitioned",)
        skey = base + ("dist_lowered", c.dtype, c.device, c.use_kernel,
                       c.reduce_strategy, c.overlap)
        dh = self.setup_store.get(skey)
        if dh is None:
            cached = self.setup_store.get(pkey)
            if cached is None:
                from ...core import MACHINES
                from ..dist_setup import dist_setup_partitioned
                t0 = time.perf_counter()
                plevels, records = dist_setup_partitioned(
                    A, c.n_pods, c.lanes, params=MACHINES[c.machine],
                    strategy=c.strategy, **c.setup_kwargs())
                self.setup_store.put(pkey, (plevels, records),
                                     setup_cost=time.perf_counter() - t0)
            else:
                plevels, records = cached
            from ..dist_solve import DistHierarchy
            bk = c.dist_build_kwargs()
            t0 = time.perf_counter()
            dh = DistHierarchy.from_partitioned(
                plevels, bk.pop("n_pods"), bk.pop("lanes"),
                setup_records=records, **bk)
            self.setup_store.put(skey, dh, nbytes=session_nbytes(dh),
                                 setup_cost=time.perf_counter() - t0)
        bound = backend_class(c.backend).from_dist_setup(c, dh)
        # partitioned blocks are the refresh target for streamed updates;
        # when they were evicted between setup and update, update()
        # escalates to a full re-setup instead
        part_cached = self.setup_store.get(pkey)
        if part_cached is not None:
            bound._plevels = part_cached[0]
        return bound
