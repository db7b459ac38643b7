"""Bound solvers and the session store (port of ``repro/amg/api/sessions.py``).

A **session** is one (matrix fingerprint, :class:`AMGConfig`) pair bound to a
backend: the object that owns the expensive state — the host ``Hierarchy``
and, for ``backend="torch"``, the lowered
:class:`~repro_torch.amg.dist_solve.DistHierarchy` with its device-resident
level tensors.  :class:`AMGSolver` is the entry point
(``AMGSolver(cfg).setup(A)``); sessions live in a :class:`SessionStore` with
an :class:`LRUPolicy` and per-entry setup-cost / hit accounting.

Not ported yet: streaming ``update`` (value-only refresh), the TTL and
bytes-budget policies, and the partitioned ``setup_backend="dist"`` path.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..csr import CSR
from ..hierarchy import Hierarchy, setup as _hierarchy_setup
from ..solve import (MultiSolveResult, SolveOptions, host_pcg, host_solve,
                     host_vcycle)
from .config import AMGConfig, RequestOptions, matrix_fingerprint
from .registry import backend_class, register_backend


# --------------------------------------------------------------------------
# Session store + eviction policy
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


class SessionStore:
    """Keyed session cache with pluggable eviction and accounting.
    Thread-safe; ``clock`` is injectable for deterministic tests."""

    def __init__(self, policy: EvictionPolicy | None = None,
                 clock=time.monotonic):
        self.policy = policy or LRUPolicy(SESSION_CACHE_SIZE)
        self._clock = clock
        self._entries: "OrderedDict[object, CacheEntry]" = OrderedDict()
        self._lock = threading.RLock()
        self._counters = {"hits": 0, "misses": 0, "puts": 0, "evictions": 0,
                          "expirations": 0, "setup_cost_evicted": 0.0}

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

    def stats(self) -> dict:
        """Counters + resident totals (hit/evict/setup-cost accounting)."""
        with self._lock:
            for e in self._entries.values():
                e.refresh_nbytes()
            return {**self._counters, "policy": self.policy.name,
                    "entries": len(self._entries),
                    "bytes": sum(e.nbytes for e in self._entries.values()),
                    "setup_cost_total": sum(e.setup_cost for e in
                                            self._entries.values())}


def _csr_nbytes(M) -> int:
    return int(M.indptr.nbytes + M.indices.nbytes + M.data.nbytes)


def session_nbytes(value) -> int:
    """Resident-bytes estimate for store accounting: CSR bytes of a host
    hierarchy, device-tensor bytes of a lowered DistHierarchy."""
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

    def __init__(self, config: AMGConfig, hierarchy: Hierarchy):
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
    def run(self, b, options: RequestOptions | None = None):
        """One request through the unified knob set (``None`` knobs resolve
        to the session config's defaults)."""
        o = (options or RequestOptions()).resolve(self.config)
        fn = self.pcg if o.method == "pcg" else self.solve
        return fn(b, tol=o.tol, maxiter=o.maxiter, x0=o.x0)

    def solve(self, b, *, tol: float | None = None,
              maxiter: int | None = None, x0=None):
        """Stationary AMG iteration (``config.tol``/``maxiter`` defaults)."""
        raise NotImplementedError

    def pcg(self, b, *, tol: float | None = None,
            maxiter: int | None = None, x0=None):
        """AMG-preconditioned CG (``config.tol``/``pcg_maxiter`` defaults)."""
        raise NotImplementedError

    def vcycle(self, b, x0=None):
        raise NotImplementedError

    def update(self, A_new: CSR | None = None, *, data=None, delta=None):
        raise NotImplementedError(
            "streaming updates (value-only hierarchy refresh) are not ported "
            "yet (ROADMAP queue 1, streaming refresh); run "
            "AMGSolver(config).setup(A_new) instead")


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

    def solve(self, b, *, tol=None, maxiter=None, x0=None):
        b = self._check_b(b)
        tol = self.config.tol if tol is None else tol
        maxiter = self.config.maxiter if maxiter is None else maxiter
        run = lambda bc, xc: host_solve(self.hierarchy, bc, tol=tol,
                                        maxiter=maxiter, opts=self.opts,
                                        x0=xc)
        if b.ndim == 2:
            return self._per_column(run, b, x0)
        return run(b, x0)

    def pcg(self, b, *, tol=None, maxiter=None, x0=None):
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
    the :class:`~repro_torch.amg.dist_solve.DistHierarchy` for every call."""

    def __init__(self, config: AMGConfig, hierarchy: Hierarchy):
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

    def solve(self, b, *, tol=None, maxiter=None, x0=None):
        from ..dist_solve import dist_solve
        b = self._check_b(b)
        tol = self.config.tol if tol is None else tol
        maxiter = self.config.maxiter if maxiter is None else maxiter
        return dist_solve(self.dist_hierarchy, b, tol=tol, maxiter=maxiter,
                          opts=self.opts, x0=x0)

    def pcg(self, b, *, tol=None, maxiter=None, x0=None):
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


# --------------------------------------------------------------------------
# The session object + default stores
# --------------------------------------------------------------------------

SESSION_CACHE_SIZE = 16
# module-level defaults: independent AMGSolver callers share sessions
_SESSIONS = SessionStore(LRUPolicy(SESSION_CACHE_SIZE))
# hierarchies keyed by (matrix fingerprint, setup kwargs) only, so configs
# that differ in solve/backend knobs share one setup (and, through the
# hierarchy's dist_cache, one lowering)
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
    default :class:`SessionStore` s."""

    def __init__(self, config: AMGConfig | None = None, *,
                 store: SessionStore | None = None,
                 setup_store: SessionStore | None = None, **overrides):
        if config is None:
            config = AMGConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        backend_class(config.backend)        # fail fast on unknown backend
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
        if bound is not None:
            return bound
        t0 = time.perf_counter()
        skw = self.config.setup_kwargs()
        skey = (fp, tuple(sorted(skw.items())))
        h = self.setup_store.get(skey)
        if h is None:
            t1 = time.perf_counter()
            h = _hierarchy_setup(A, **skw)
            self.setup_store.put(skey, h, nbytes=session_nbytes(h),
                                 setup_cost=time.perf_counter() - t1)
        bound = backend_class(self.config.backend)(self.config, h)
        # nbytes_fn: a torch session's device tensors are lowered lazily on
        # first solve, so resident bytes are re-measured at eviction time
        self.store.put(key, bound, nbytes=session_nbytes(bound),
                       setup_cost=time.perf_counter() - t0,
                       nbytes_fn=lambda: session_nbytes(bound))
        return bound
