# Copy of repro/amg/api/service.py (numpy only); only the docstrings and imports differ.
"""AMGService: admission-scheduled, wire-addressable solver serving (port of
``repro/amg/api/service.py``).

The serving surface over the session API: it keeps hot sessions pinned and
feeds the multi-RHS programs, which on ``backend="torch"`` run as captured
CUDA graphs (one graph per chunk width, :mod:`repro_torch.amg.programs`).

* **Ticketed async admission** — :meth:`submit` returns a :class:`Ticket`
  immediately; ``ticket.result()`` blocks until the scheduler has run the
  solve.  Requests carry per-request ``tol``/``maxiter``/``x0`` warm starts
  and ``b`` payloads of shape ``[n]`` or ``[n, k]``.
* **Cross-burst coalescing** — requests whose
  ``(matrix_id,) + RequestOptions.group_key()`` coalescing keys match and
  that arrive within one ``coalesce_window`` are stacked into ONE
  multi-RHS solve (chunks of at most ``max_rhs`` columns), even when they
  were submitted in separate bursts.
* **Priority classes with starvation-free scheduling** — ``"interactive"``
  / ``"default"`` / ``"batch"`` (or any int; lower runs first); a waiting
  group's effective priority improves by one class per ``priority_aging``
  seconds, so a steady interactive stream can never starve batch work.
* **Wire addressability** — :meth:`register_wire` / :meth:`submit_wire` /
  :meth:`update_wire` accept the encoded payloads of
  :mod:`repro_torch.amg.api.config`, so the whole service can be driven
  over a byte transport (matrices registered by fingerprint, requests
  referencing them by that id).
* **Streaming updates** — :meth:`update` applies ``A + ΔA`` value drift to
  a registered matrix under a STABLE matrix id: a pattern-matching update
  refreshes the live session's values in place (hierarchy, NAP schedules
  and captured programs reused), escalating to a full re-setup on
  convergence regression, a changed pattern, or an evicted session.
* **Accounting** — :meth:`report` returns a :class:`ServiceReport` with
  per-request diagnostics plus the session store's hit/evict/setup-cost
  and refresh/re-setup counters (:meth:`SessionStore.stats`).

Two execution modes share the same scheduler: a background worker thread
(:meth:`start`/:meth:`close`, or the context manager) that honors the
coalescing window in real time, and the synchronous :meth:`drain` (no
thread, window treated as already elapsed) for deterministic callers.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from ...core.nap_collectives import PROCESS_TODO
from ..csr import CSR
from ..solve import MultiSolveResult
from .config import (AMGConfig, PatternMismatch, RequestOptions,
                     apply_update, csr_from_wire, matrix_fingerprint,
                     solve_request_from_wire, update_request_from_wire)
from .sessions import (AMGSolver, BoundSolver, BytesBudgetPolicy, LRUPolicy,
                       SessionStore, _csr_nbytes)

PRIORITY_CLASSES = {"interactive": 0, "default": 1, "batch": 2}


class ServiceClosed(RuntimeError):
    """The service was closed before this request could be executed.

    Raised out of :meth:`Ticket.result` for requests still queued when
    :meth:`AMGService.close` ran (always with ``flush=False``; with the
    default flushing close only requests admitted during the shutdown race
    see it) — a typed, immediate failure instead of a ``result(timeout=)``
    expiry."""


class Ticket:
    """Handle for one admitted request; :meth:`result` blocks until the
    scheduler has executed it (and re-raises any solve-side failure)."""

    def __init__(self, service: "AMGService", rid: int, matrix_id: str):
        self.rid = rid
        self.matrix_id = matrix_id
        self.diagnostics: dict | None = None   # set when the solve lands
        self._service = service
        self._event = threading.Event()
        self._x: np.ndarray | None = None
        self._error: BaseException | None = None
        self._cb_lock = threading.Lock()
        self._callbacks: list = []

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self) -> BaseException | None:
        """The solve-side failure, or None (only meaningful once done)."""
        return self._error

    def add_done_callback(self, fn) -> None:
        """Call ``fn(ticket)`` when the request finishes (success or
        failure).  Runs in the scheduler's thread — or immediately in the
        caller's if the ticket is already done.  This is the hook the async
        serving front-end bridges on (no polling thread per request)."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def result(self, timeout: float | None = None) -> np.ndarray:
        """The solution ``x`` ([n], or [n, k] for a multi-RHS payload)."""
        if not self._event.is_set() and not self._service.running:
            raise RuntimeError(
                "service worker is not running and the request has not been "
                "drained — call service.start() (or use it as a context "
                "manager) for async admission, or service.drain() for "
                "synchronous processing")
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not finished after "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._x

    def _fulfill(self, x, diagnostics: dict) -> None:
        self._x = x
        self.diagnostics = diagnostics
        self._finish()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._finish()

    def _finish(self) -> None:
        with self._cb_lock:
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)


@dataclasses.dataclass
class ServiceReport:
    """Snapshot of a service's accounting: admission/batching counters,
    per-request diagnostics, and the session store's stats."""

    stats: dict
    per_request: dict
    store: dict
    matrices: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        s, st = self.stats, self.store
        lines = [
            f"requests={s['requests']} (wire={s['wire_requests']}) "
            f"batches={s['batches']} batched_rhs={s['batched_rhs']} "
            f"setups={s['setups']} updates={s['updates']} "
            f"unconverged={s['unconverged']} errors={s['errors']}",
            f"store[{st['policy']}]: entries={st['entries']} "
            f"bytes={st['bytes']} hits={st['hits']} misses={st['misses']} "
            f"evictions={st['evictions']} expirations={st['expirations']} "
            f"setup_cost_total={st['setup_cost_total']:.3f}s",
        ]
        if st.get("refreshes") or st.get("resetups"):
            trig = ",".join(f"{k}:{v}" for k, v in
                            sorted(st.get("triggers", {}).items()))
            lines.append(
                f"streaming: refreshes={st['refreshes']} "
                f"resetups={st['resetups']} triggers=[{trig}]")
        if self.matrices:
            m = self.matrices
            lines.append(
                f"matrices[{m['policy']}]: entries={m['entries']} "
                f"bytes={m['bytes']} evictions={m['evictions']}")
        return "\n".join(lines)


@dataclasses.dataclass
class _Pending:
    rid: int
    b: np.ndarray                # [n] or [n, k]
    x0: np.ndarray | None
    priority: int
    submitted: float
    ticket: Ticket

    @property
    def ncols(self) -> int:
        return 1 if self.b.ndim == 1 else int(self.b.shape[1])


@dataclasses.dataclass
class _Group:
    """Requests sharing one ``(matrix_id,) + RequestOptions.group_key()``
    coalescing key; everything in a group can ride the same multi-RHS
    solve."""

    key: tuple
    created: float
    requests: list[_Pending] = dataclasses.field(default_factory=list)

    @property
    def priority(self) -> int:
        return min(p.priority for p in self.requests)


class AMGService:
    """Admission-scheduled solver service over one :class:`AMGConfig`.

    ``max_rhs`` caps the columns of one multi-RHS solve; ``coalesce_window``
    (seconds) is how long an open group waits for more same-key right-hand
    sides before the worker launches it; ``store`` defaults to a fresh
    LRU :class:`SessionStore` so eviction budgets and hit counters are
    scoped to this service (pass a shared store to pool sessions);
    ``priority_aging`` is the seconds of waiting that promote a group by
    one priority class (starvation freedom).  ``max_matrices`` /
    ``max_matrix_bytes`` bound the matrix registry (LRU by count; with a
    bytes budget, the cost-aware policy) — counters surface in
    :meth:`report` as ``matrices``.  ``clock`` is injectable for
    deterministic scheduler tests.
    """

    def __init__(self, config: AMGConfig | None = None, *, max_rhs: int = 8,
                 coalesce_window: float = 0.0,
                 store: SessionStore | None = None,
                 priority_aging: float = 0.5,
                 max_matrices: int = 64,
                 max_matrix_bytes: int | None = None,
                 diagnostics_limit: int = 4096, clock=time.monotonic):
        self.config = config or AMGConfig()
        if self.config.ranks == "process":
            raise NotImplementedError(f"AMGService {PROCESS_TODO}")
        self.max_rhs = max(1, int(max_rhs))
        self.coalesce_window = float(coalesce_window)
        self.priority_aging = max(1e-9, float(priority_aging))
        self.store = store if store is not None else SessionStore(LRUPolicy())
        self.solver = AMGSolver(self.config, store=self.store)
        self._clock = clock
        # the matrix registry is bounded (entry count, optionally bytes)
        # through the same eviction machinery as the session store — a
        # long-lived service whose session store drops cold sessions must
        # not keep every matrix ever registered resident forever
        policy = (BytesBudgetPolicy(max_matrix_bytes,
                                    max_entries=max_matrices)
                  if max_matrix_bytes is not None
                  else LRUPolicy(max_matrices))
        self._matrices: SessionStore = SessionStore(policy, clock=clock)
        self._groups: dict[tuple, _Group] = {}
        self._cond = threading.Condition()
        self._worker: threading.Thread | None = None
        self._stop = False
        self._flush_on_stop = True
        self._next_rid = 0
        self.stats = {"requests": 0, "wire_requests": 0, "batches": 0,
                      "batched_rhs": 0, "setups": 0, "unconverged": 0,
                      "updates": 0, "errors": 0}
        # per-request diagnostics of the most recent `diagnostics_limit`
        # executed solves (bounded so a long-lived service cannot grow
        # without limit; tickets keep their own copy regardless)
        self.diagnostics_limit = max(1, int(diagnostics_limit))
        self.diagnostics: dict[int, dict] = {}

    # ------------------------------------------------------------- lifecycle
    @property
    def running(self) -> bool:
        return self._worker is not None

    def start(self) -> "AMGService":
        """Spawn the admission worker (idempotent)."""
        if self._worker is None:
            self._stop = False
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="amg-service", daemon=True)
            self._worker.start()
        return self

    def close(self, flush: bool = True) -> None:
        """Stop the worker.  ``flush=True`` (default) executes every queued
        group first (window ignored); ``flush=False`` abandons the queue.
        Either way, any request still un-executed when the worker has
        stopped — the whole queue under ``flush=False``, shutdown-race
        admissions under ``flush=True`` — fails immediately with a typed
        :class:`ServiceClosed` instead of hanging until a
        ``result(timeout=...)`` expires."""
        w = self._worker
        if w is not None:
            with self._cond:
                self._stop = True
                self._flush_on_stop = flush
                self._cond.notify_all()
            w.join()
            self._worker = None
            self._stop = False
            self._flush_on_stop = True
        self._fail_queued(ServiceClosed(
            "AMGService was closed before this request was executed"))

    def _fail_queued(self, error: BaseException) -> None:
        with self._cond:
            groups, self._groups = list(self._groups.values()), {}
        for group in groups:
            self.stats["errors"] += len(group.requests)
            for p in group.requests:
                self._record_diag(p.rid, {"error": repr(error)})
                p.ticket._fail(error)

    def __enter__(self) -> "AMGService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- registration
    def register(self, matrix_id: str, A: CSR, *,
                 fingerprint: str | None = None) -> str:
        """Register a matrix under an id; its fingerprint is computed once
        here (or passed in by a caller that already decoded it) and reused
        for every session lookup.  The registry is bounded: the service's
        eviction policy (count, optionally bytes) drops the least-valuable
        registrations once over budget."""
        self._matrices.put(matrix_id, (A, fingerprint or
                                       matrix_fingerprint(A)),
                           nbytes=_csr_nbytes(A))
        return matrix_id

    def register_wire(self, payload: dict) -> str:
        """Register an encoded CSR payload; the matrix id IS its verified
        content fingerprint (so the registration is idempotent and requests
        can address the matrix without any out-of-band id exchange)."""
        A, fp = csr_from_wire(payload)
        return self.register(fp, A, fingerprint=fp)

    def _lookup_matrix(self, matrix_id: str) -> tuple[CSR, str]:
        got = self._matrices.get(matrix_id)
        if got is None:
            raise KeyError(f"unknown matrix_id {matrix_id!r}; registered: "
                           f"{sorted(self._matrices.keys())}")
        return got

    def bound_for(self, matrix_id: str) -> BoundSolver:
        """The session for a registered matrix (setup on first use; later
        calls hit the session store)."""
        A, fp = self._lookup_matrix(matrix_id)
        misses = self.store.stats()["misses"]
        bound = self.solver.setup(A, fingerprint=fp)
        if self.store.stats()["misses"] > misses:
            self.stats["setups"] += 1
        return bound

    # -------------------------------------------------------------- admission
    def submit(self, matrix_id: str, b, *,
               options: RequestOptions | None = None,
               method: str | None = None, tol: float | None = None,
               maxiter: int | None = None, x0=None, priority=None,
               rid: int | None = None) -> Ticket:
        """Admit one solve; returns a :class:`Ticket` immediately.

        Per-request knobs travel as ONE frozen
        :class:`~repro_torch.amg.api.config.RequestOptions` (``options=``); the
        individual ``method``/``tol``/``maxiter``/``x0`` kwargs are sugar
        that constructs it and cannot be mixed with ``options=``.  ``b``
        is ``[n]`` or ``[n, k]``; requests sharing
        ``(matrix_id,) + options.group_key()`` coalesce into one
        multi-RHS solve when admitted within one window.
        """
        if options is None:
            options = RequestOptions(method=method or "solve", tol=tol,
                                     maxiter=maxiter, x0=x0)
        elif any(v is not None for v in (method, tol, maxiter, x0)):
            raise ValueError("pass options= or individual solve knobs, "
                             "not both")
        A, _ = self._lookup_matrix(matrix_id)
        options = options.resolve(self.config)
        n = A.nrows
        b = np.asarray(b)
        if (b.ndim not in (1, 2) or b.shape[0] != n
                or (b.ndim == 2 and b.shape[1] == 0)):
            raise ValueError(f"b must be [{n}] or [{n}, k] with k >= 1, "
                             f"got shape {b.shape}")
        x0 = options.x0
        if x0 is not None:
            x0 = np.asarray(x0)
            if x0.shape != b.shape:
                raise ValueError(f"x0 must match b's shape {b.shape}, "
                                 f"got {x0.shape}")
            x0 = x0.copy()
        # defensive copy: submit() returns before the solve runs, so a
        # caller reusing its buffer must not corrupt the queued request
        b = b.copy()
        prio = self._resolve_priority(priority)
        key = (matrix_id,) + options.group_key()
        now = self._clock()
        with self._cond:
            if rid is None:
                rid = self._next_rid
            self._next_rid = max(self._next_rid, rid) + 1
            ticket = Ticket(self, rid, matrix_id)
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = _Group(key, now)
            group.requests.append(_Pending(rid, b, x0, prio, now, ticket))
            self.stats["requests"] += 1
            self._cond.notify_all()
        return ticket

    def submit_wire(self, payload: dict) -> Ticket:
        """Admit one encoded solve request (see
        :func:`~repro_torch.amg.api.config.solve_request_to_wire`)."""
        kwargs = solve_request_from_wire(payload)
        self.stats["wire_requests"] += 1
        return self.submit(kwargs.pop("matrix_id"), kwargs.pop("b"),
                           **kwargs)

    # ------------------------------------------------------ streaming updates
    def update(self, matrix_id: str, A_new: CSR | None = None, *,
               data=None, delta=None) -> dict:
        """Apply a streaming value update to a registered matrix.

        The matrix id stays STABLE across updates — in-flight and future
        requests keep addressing it.  Exactly one of ``A_new`` (full CSR),
        ``data`` (values on the frozen pattern) or ``delta`` (additive ΔA).
        Routing: a live session with a matching pattern takes the
        value-only refresh (or its policy-escalated re-setup); a changed
        pattern or an evicted session runs a full setup.  Returns
        ``{"matrix": id, "action": "refresh"|"resetup", "reason": ...}``.
        """
        A_old, fp = self._lookup_matrix(matrix_id)
        if A_new is None:
            A_new = apply_update(A_old, data=data, delta=delta)
        elif data is not None or delta is not None:
            raise ValueError("pass A_new or data=/delta=, not both")
        self.stats["updates"] += 1
        bound = self.store.get((fp, self.solver.config))
        if bound is not None:
            try:
                action = bound.update(A_new)
                reason = bound.last_update_reason
                self._matrices.put(matrix_id,
                                   (bound._fine, bound._fingerprint),
                                   nbytes=_csr_nbytes(bound._fine))
                return {"matrix": matrix_id, "action": action,
                        "reason": reason}
            except PatternMismatch:
                # structural change: the session cannot refresh — the
                # service escalates explicitly with a full setup
                reason = "pattern"
        else:
            reason = "evicted"
        fp_new = matrix_fingerprint(A_new)
        self.register(matrix_id, A_new, fingerprint=fp_new)
        self.bound_for(matrix_id)                   # full (re-)setup
        self.store.note_update("resetup", reason)
        return {"matrix": matrix_id, "action": "resetup", "reason": reason}

    def update_wire(self, payload: dict) -> dict:
        """Apply one encoded update request (see
        :func:`~repro_torch.amg.api.config.update_request_to_wire`); returns the
        :meth:`update` result with the request's ``rid`` echoed."""
        kwargs = update_request_from_wire(payload)
        self.stats["wire_requests"] += 1
        rid = kwargs.pop("rid", None)
        out = self.update(kwargs.pop("matrix_id"), kwargs.pop("A", None),
                          **kwargs)
        if rid is not None:
            out["rid"] = rid
        return out

    @staticmethod
    def _resolve_priority(priority) -> int:
        if priority is None:
            return PRIORITY_CLASSES["default"]
        if isinstance(priority, str):
            try:
                return PRIORITY_CLASSES[priority]
            except KeyError:
                raise ValueError(
                    f"unknown priority class {priority!r}; known: "
                    f"{sorted(PRIORITY_CLASSES)} (or any int)") from None
        return int(priority)

    # -------------------------------------------------------------- scheduling
    def _order_key(self, group: _Group, now: float) -> tuple:
        """Scheduling order among ripe groups: effective priority first
        (aged — one class per ``priority_aging`` seconds waited, so low
        priorities cannot starve), then arrival order."""
        aged = group.priority - (now - group.created) / self.priority_aging
        return (aged, group.created)

    def drain(self) -> dict[int, np.ndarray]:
        """Synchronously execute everything queued (the window is treated
        as already elapsed); returns ``{rid: x}``.  Only valid when the
        background worker is not running."""
        if self._worker is not None:
            raise RuntimeError("drain() is for synchronous use; this "
                               "service has a running worker — collect "
                               "results through ticket.result() instead")
        out: dict[int, np.ndarray] = {}
        while True:
            with self._cond:
                if not self._groups:
                    return out
                now = self._clock()
                group = min(self._groups.values(),
                            key=lambda g: self._order_key(g, now))
                del self._groups[group.key]
            out.update(self._execute_group(group))

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._groups and not self._stop:
                    self._cond.wait()
                if self._stop and (not self._groups
                                   or not self._flush_on_stop):
                    return
                now = self._clock()
                ripe = [g for g in self._groups.values()
                        if self._stop
                        or now - g.created >= self.coalesce_window]
                if not ripe:
                    deadline = min(g.created + self.coalesce_window
                                   for g in self._groups.values())
                    self._cond.wait(timeout=max(deadline - now, 1e-3))
                    continue
                group = min(ripe, key=lambda g: self._order_key(g, now))
                del self._groups[group.key]
            self._execute_group(group)

    # --------------------------------------------------------------- execution
    def _chunks(self, requests: list[_Pending]):
        """Split a group into multi-RHS-solve-sized chunks: total columns per
        chunk ≤ ``max_rhs`` (a single over-wide request stays whole)."""
        chunk, cols = [], 0
        for p in requests:
            if chunk and cols + p.ncols > self.max_rhs:
                yield chunk
                chunk, cols = [], 0
            chunk.append(p)
            cols += p.ncols
        if chunk:
            yield chunk

    def _execute_group(self, group: _Group) -> dict[int, np.ndarray]:
        matrix_id, method, tol, maxiter = group.key
        out: dict[int, np.ndarray] = {}
        try:
            bound = self.bound_for(matrix_id)
        except Exception as e:                     # setup failed: fail all
            self.stats["errors"] += len(group.requests)
            for p in group.requests:
                self._record_diag(p.rid, {"error": repr(e)})
                p.ticket._fail(e)
            return out
        fn = bound.solve if method == "solve" else bound.pcg
        now = self._clock()
        for chunk in self._chunks(group.requests):
            batch = self.stats["batches"]
            try:
                out.update(self._run_chunk(fn, chunk, tol, maxiter, batch,
                                           method, now))
            except Exception as e:
                self.stats["errors"] += len(chunk)
                for p in chunk:
                    self._record_diag(p.rid, {"error": repr(e)})
                    p.ticket._fail(e)
                continue
            self.stats["batches"] += 1
        return out

    def _run_chunk(self, fn, chunk: list[_Pending], tol, maxiter,
                   batch: int, method: str, now: float) -> dict:
        out = {}
        ncols = sum(p.ncols for p in chunk)
        n = chunk[0].b.shape[0]
        if len(chunk) == 1 and chunk[0].b.ndim == 1:
            p = chunk[0]
            res = fn(p.b, tol=tol, maxiter=maxiter, x0=p.x0)
            results = [(p, np.asarray(res.x), res)]
        else:
            B = np.concatenate([p.b.reshape(n, -1) for p in chunk], axis=1)
            if any(p.x0 is not None for p in chunk):
                X0 = np.concatenate(
                    [(p.x0.reshape(n, -1) if p.x0 is not None
                      else np.zeros((n, p.ncols))) for p in chunk], axis=1)
            else:
                X0 = None
            mres = fn(B, tol=tol, maxiter=maxiter, x0=X0)
            results, o = [], 0
            for p in chunk:
                block = np.asarray(mres.x[:, o: o + p.ncols])
                x = block[:, 0] if p.b.ndim == 1 else block
                # per-request view over this request's columns — reuses
                # MultiSolveResult's converged/iterations aggregation
                results.append((p, x,
                                MultiSolveResult(block,
                                                 mres.columns[o: o + p.ncols])))
                o += p.ncols
        for p, x, res in results:
            diag = {"converged": bool(res.converged),
                    "iterations": int(res.iterations), "method": method,
                    "batch": batch, "batch_cols": ncols,
                    "wait_s": max(now - p.submitted, 0.0)}
            if not res.converged:
                self.stats["unconverged"] += 1
            self._record_diag(p.rid, diag)
            out[p.rid] = x
            p.ticket._fulfill(x, diag)
        if ncols > 1:
            self.stats["batched_rhs"] += ncols
        return out

    def _record_diag(self, rid: int, diag: dict) -> None:
        self.diagnostics.pop(rid, None)          # re-insert at the tail
        self.diagnostics[rid] = diag
        while len(self.diagnostics) > self.diagnostics_limit:
            del self.diagnostics[next(iter(self.diagnostics))]

    # -------------------------------------------------------------- reporting
    def report(self) -> ServiceReport:
        return ServiceReport(stats=dict(self.stats),
                             per_request={r: dict(d) for r, d in
                                          self.diagnostics.items()},
                             store=self.store.stats(),
                             matrices=self._matrices.stats())
