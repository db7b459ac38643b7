# Copy of repro/serve/server.py: aclose also closes open connections; only the imports and the module docstring differ otherwise.
"""AMGWire: the asyncio socket front-end over the AMG serving stack.

The ROADMAP's "millions of users" story needs real connections before any
of the admission machinery (coalescing windows, priority aging) can be
said to stretch anywhere — this module is that front-end.  One
:class:`AMGWireServer` hosts many named **tenants**; each tenant owns its
own :class:`~repro.amg.api.AMGConfig`, its own
:class:`~repro.amg.api.SessionStore` (eviction budgets scoped per tenant)
and its own quotas:

* ``max_inflight`` — bounded per-tenant admission queue (queued +
  executing).  Overload is shed by **priority class**: batch traffic is
  rejected once the queue is half full, default at three quarters,
  interactive only when completely full — so an overloaded tenant keeps
  serving its latency-critical stream while batch work gets explicit
  429-style ``rejected`` frames (never a dropped connection).
* ``max_matrix_bytes`` / ``max_matrices`` — registration quota: an
  over-quota ``register`` gets a ``rejected`` frame; the service's own
  bounded registry (same eviction machinery as the session store) is the
  backstop underneath.

Connections are plain asyncio streams speaking the length-prefixed JSON
frames of :mod:`repro.serve.wire`; the *content* of every frame is the
existing versioned codec (``csr_to_wire`` payloads register matrices by
verified content fingerprint, ``solve_request_to_wire`` payloads admit
solves, ``update_request_to_wire`` payloads stream ``A + ΔA`` value drift
into a tenant's live sessions — schema-v2 frames; the connection opens
with a ``hello`` frame advertising the schemas the server accepts).
Every decode failure — malformed JSON, schema-version mismatch,
unknown key, unknown matrix id — becomes a structured ``error`` frame and
the connection survives; the server process never dies on a bad payload.

The bridge from async connection handlers to the threaded
:class:`~repro.amg.api.AMGService` is the **awaitable ticket adapter**
(:func:`ticket_future`): ``submit`` returns a ticket immediately, the
ticket's done-callback resolves an asyncio future on the event loop, and
the handler awaits it — no polling thread per request, thousands of
in-flight solves per loop.

In the port a tenant's :class:`~repro_torch.amg.api.AMGConfig` may carry
``backend="torch"`` and a ``device``: on the card every admitted solve then
runs through its session's captured CUDA graphs (the ``*_m`` programs for a
coalesced chunk), and such a config refuses to be made on a machine
without a card unless it asks for ``device="cpu"``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
import threading

from ..amg.api import AMGConfig, WireError
from ..amg.api.config import array_to_wire, csr_from_wire
from ..amg.api.service import AMGService, PRIORITY_CLASSES, ServiceClosed
from ..amg.api.sessions import LRUPolicy, SessionStore, _csr_nbytes
from .wire import (MAX_FRAME_BYTES, check_request_envelope, encode_frame,
                   error_frame, hello_frame, read_frame, response_frame)

# fraction of a tenant's max_inflight each priority class may fill before
# admission sheds it: batch loses half the queue to interactive headroom
SHED_FRACTIONS = {0: 1.0, 1: 0.75, 2: 0.5}
_CLASS_NAMES = {v: k for k, v in PRIORITY_CLASSES.items()}


def priority_class_name(prio: int) -> str:
    return _CLASS_NAMES.get(prio, str(prio))


def ticket_future(ticket, loop: asyncio.AbstractEventLoop) -> asyncio.Future:
    """The awaitable ticket adapter: an asyncio future resolved on ``loop``
    when the threaded scheduler finishes the ticket — ``(x, diagnostics)``
    on success, the solve-side exception (:class:`ServiceClosed` included)
    otherwise."""
    fut = loop.create_future()

    def _done(t):
        def _resolve():
            if fut.cancelled():
                return
            err = t.exception()
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result((t.result(timeout=0), t.diagnostics))
        try:
            loop.call_soon_threadsafe(_resolve)
        except RuntimeError:
            pass                       # loop already closed: nobody waiting

    ticket.add_done_callback(_done)
    return fut


@dataclasses.dataclass
class TenantSpec:
    """One tenant's config + quotas (everything per-tenant by design: a
    noisy tenant exhausts its own queue and its own byte budget, never a
    neighbor's)."""

    config: AMGConfig = dataclasses.field(default_factory=AMGConfig)
    max_inflight: int = 32
    max_matrices: int = 64
    max_matrix_bytes: int | None = None
    max_rhs: int = 8
    coalesce_window: float = 0.0


class _Tenant:
    def __init__(self, name: str, spec: TenantSpec):
        self.name = name
        self.spec = spec
        self.service = AMGService(
            spec.config, max_rhs=spec.max_rhs,
            coalesce_window=spec.coalesce_window,
            store=SessionStore(LRUPolicy()),
            max_matrices=spec.max_matrices,
            max_matrix_bytes=spec.max_matrix_bytes)
        self.inflight = 0              # touched only on the event loop
        self.registered_bytes = 0
        self.counters = {"registered": 0, "admitted": 0, "completed": 0,
                         "updated": 0, "rejected": 0, "errors": 0}
        self.rejected_by_class: dict[str, int] = {}

    def admit_limit(self, prio: int) -> int:
        frac = SHED_FRACTIONS.get(max(0, min(int(prio), 2)), 0.5)
        return max(1, math.ceil(self.spec.max_inflight * frac))

    def stats(self) -> dict:
        return {**self.counters, "inflight": self.inflight,
                "max_inflight": self.spec.max_inflight,
                "rejected_by_class": dict(self.rejected_by_class),
                "service": dict(self.service.stats),
                "store": self.service.store.stats(),
                "matrices": self.service._matrices.stats()}


class AMGWireServer:
    """The multi-tenant asyncio front-end; see the module docstring.

    Lifecycle: ``await start(host, port)`` binds the socket and spawns one
    admission worker thread per tenant; ``await aclose()`` stops accepting,
    fails still-queued requests with :class:`ServiceClosed` (typed error
    frames, not hangs) and joins the workers.
    """

    def __init__(self, tenants: dict[str, TenantSpec] | None = None, *,
                 max_frame: int = MAX_FRAME_BYTES):
        self.tenants = {name: _Tenant(name, spec)
                        for name, spec in (tenants or {}).items()}
        self.max_frame = int(max_frame)
        self.connections = 0           # currently open
        self.dropped_connections = 0   # closed by a server-side failure
        self._server: asyncio.AbstractServer | None = None
        self._tasks: set[asyncio.Task] = set()
        self._writers: set[asyncio.StreamWriter] = set()   # open connections

    # -------------------------------------------------------------- lifecycle
    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> tuple[str, int]:
        """Bind and start serving; returns the actual (host, port) —
        ``port=0`` picks a free one."""
        for tenant in self.tenants.values():
            tenant.service.start()
        self._server = await asyncio.start_server(self._handle, host, port)
        sock = self._server.sockets[0].getsockname()
        return sock[0], sock[1]

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        await self._server.serve_forever()

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()            # stop accepting
        # flush=False: still-queued work fails typed (ServiceClosed); the
        # completion tasks then flush those as 503 error frames before we
        # return — a client awaiting a response at shutdown gets a frame,
        # never a silent hang
        for tenant in self.tenants.values():
            tenant.service.close(flush=False)
        if self._tasks:
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)
        # then end the open connections (their last frames are flushed
        # first): from Python 3.12 wait_closed() waits for every connection
        for writer in list(self._writers):
            writer.close()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    def stats(self) -> dict:
        return {"connections": self.connections,
                "dropped_connections": self.dropped_connections,
                "tenants": {name: t.stats()
                            for name, t in self.tenants.items()}}

    # ------------------------------------------------------------ connections
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.connections += 1
        self._writers.add(writer)
        lock = asyncio.Lock()          # serializes interleaved responses
        try:
            # unsolicited greeting: advertise the schema versions this
            # server accepts so the client can negotiate before sending
            await self._send(writer, lock, hello_frame(self.tenants))
            while True:
                try:
                    frame = await read_frame(reader, self.max_frame)
                except WireError as e:      # malformed/oversized frame
                    code = 413 if "exceeds" in str(e) else 400
                    await self._send(writer, lock,
                                     error_frame(None, e, code))
                    continue                # the stream stays aligned
                if frame is None:
                    break                   # client closed
                await self._dispatch(frame, writer, lock)
        except (ConnectionResetError, BrokenPipeError):
            pass                            # client vanished mid-write
        except Exception:
            self.dropped_connections += 1   # must stay 0: server-side bug
            raise
        finally:
            self.connections -= 1
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _send(self, writer: asyncio.StreamWriter, lock: asyncio.Lock,
                    frame: dict) -> None:
        async with lock:
            try:
                writer.write(encode_frame(frame))
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass                        # receiver gone; solve stands

    # --------------------------------------------------------------- dispatch
    async def _dispatch(self, frame: dict, writer, lock) -> None:
        seq = frame.get("seq")
        try:
            kind = check_request_envelope(frame)
        except WireError as e:
            await self._send(writer, lock, error_frame(seq, e, 400))
            return
        if kind == "ping":
            await self._send(writer, lock, response_frame(
                "pong", seq, tenants=sorted(self.tenants)))
            return
        if kind == "stats":
            name = frame.get("tenant")
            body = (self.stats() if name is None
                    else {"tenants": {name: t.stats()}}
                    if (t := self.tenants.get(name)) is not None else None)
            if body is None:
                await self._send(writer, lock, error_frame(
                    seq, KeyError(f"unknown tenant {name!r}"), 404))
                return
            await self._send(writer, lock,
                             response_frame("stats", seq, **body))
            return
        tenant = self.tenants.get(frame.get("tenant"))
        if tenant is None:
            await self._send(writer, lock, error_frame(
                seq, KeyError(f"unknown tenant {frame.get('tenant')!r}; "
                              f"known: {sorted(self.tenants)}"), 404))
            return
        payload = frame.get("payload")
        try:
            if kind == "register":
                await self._register(tenant, payload, seq, writer, lock)
            elif kind == "update":
                await self._update(tenant, payload, seq, writer, lock)
            else:
                await self._solve(tenant, payload, seq, writer, lock)
        except WireError as e:              # strict codec rejection
            tenant.counters["errors"] += 1
            await self._send(writer, lock, error_frame(seq, e, 400))
        except KeyError as e:               # unknown matrix id
            tenant.counters["errors"] += 1
            await self._send(writer, lock, error_frame(seq, e, 404))
        except ValueError as e:             # bad method/priority/shape
            tenant.counters["errors"] += 1
            await self._send(writer, lock, error_frame(seq, e, 400))
        except Exception as e:              # never take the server down
            tenant.counters["errors"] += 1
            await self._send(writer, lock, error_frame(seq, e, 500))

    async def _register(self, tenant: _Tenant, payload, seq,
                        writer, lock) -> None:
        A, fp = csr_from_wire(payload)      # WireError -> structured frame
        nbytes = _csr_nbytes(A)
        budget = tenant.spec.max_matrix_bytes
        already = fp in tenant.service._matrices
        if (budget is not None and not already
                and tenant.registered_bytes + nbytes > budget):
            tenant.counters["rejected"] += 1
            await self._send(writer, lock, response_frame(
                "rejected", seq, code=429, reason="matrix byte quota",
                tenant=tenant.name, registered_bytes=tenant.registered_bytes,
                matrix_bytes=nbytes, max_matrix_bytes=budget))
            return
        tenant.service.register(fp, A, fingerprint=fp)
        tenant.registered_bytes = tenant.service._matrices.stats()["bytes"]
        tenant.counters["registered"] += 1
        await self._send(writer, lock, response_frame(
            "registered", seq, matrix=fp, bytes=nbytes))

    async def _update(self, tenant: _Tenant, payload, seq,
                      writer, lock) -> None:
        # the refresh/re-setup is synchronous compute — run it off the
        # event loop so concurrent connections keep being served (a KeyError
        # for an unregistered fingerprint maps to a 404 error frame in
        # _dispatch, exactly like an unknown matrix id on the solve path)
        result = await asyncio.to_thread(tenant.service.update_wire, payload)
        tenant.counters["updated"] += 1
        await self._send(writer, lock, response_frame("updated", seq,
                                                      **result))

    async def _solve(self, tenant: _Tenant, payload, seq,
                     writer, lock) -> None:
        from ..amg.api.config import solve_request_from_wire
        kwargs = solve_request_from_wire(payload)   # strict decode first
        prio = AMGService._resolve_priority(kwargs.get("priority"))
        limit = tenant.admit_limit(prio)
        if tenant.inflight >= limit:
            cls = priority_class_name(prio)
            tenant.counters["rejected"] += 1
            tenant.rejected_by_class[cls] = \
                tenant.rejected_by_class.get(cls, 0) + 1
            await self._send(writer, lock, response_frame(
                "rejected", seq, code=429, reason="tenant over capacity",
                tenant=tenant.name, priority=cls,
                inflight=tenant.inflight, limit=limit,
                max_inflight=tenant.spec.max_inflight))
            return
        ticket = tenant.service.submit(**kwargs)    # KeyError/ValueError up
        tenant.service.stats["wire_requests"] += 1
        tenant.counters["admitted"] += 1
        tenant.inflight += 1
        fut = ticket_future(ticket, asyncio.get_running_loop())
        task = asyncio.ensure_future(
            self._complete(tenant, ticket, fut, seq, writer, lock))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _complete(self, tenant: _Tenant, ticket, fut, seq,
                        writer, lock) -> None:
        try:
            x, diag = await fut
        except ServiceClosed as e:
            tenant.counters["errors"] += 1
            tenant.inflight -= 1
            await self._send(writer, lock, error_frame(seq, e, 503))
            return
        except asyncio.CancelledError:
            tenant.inflight -= 1
            raise
        except Exception as e:              # solve-side failure
            tenant.counters["errors"] += 1
            tenant.inflight -= 1
            await self._send(writer, lock, error_frame(seq, e, 500))
            return
        tenant.counters["completed"] += 1
        tenant.inflight -= 1
        await self._send(writer, lock, response_frame(
            "solution", seq, rid=ticket.rid, x=array_to_wire(x),
            diagnostics=diag))


class ServerThread:
    """Run an :class:`AMGWireServer` on a background thread with its own
    event loop — the sync-world entrypoint (demo, load-generator
    self-hosting, tests driving blocking clients).  Context manager::

        with ServerThread({"alpha": TenantSpec()}) as srv:
            ...connect to (srv.host, srv.port)...
    """

    def __init__(self, tenants: dict[str, TenantSpec], *,
                 host: str = "127.0.0.1", port: int = 0, **kw):
        self._tenants, self._host, self._port, self._kw = \
            tenants, host, port, kw
        self.server: AMGWireServer | None = None
        self.host: str | None = None
        self.port: int | None = None
        self._ready = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop: asyncio.Event | None = None
        self._thread: threading.Thread | None = None
        self._failure: BaseException | None = None

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        self.server = AMGWireServer(self._tenants, **self._kw)
        try:
            self.host, self.port = await self.server.start(self._host,
                                                           self._port)
        except BaseException as e:
            self._failure = e
            self._ready.set()
            raise
        self._ready.set()
        await self._stop.wait()
        await self.server.aclose()

    def __enter__(self) -> "ServerThread":
        self._thread = threading.Thread(target=lambda: asyncio.run(
            self._main()), name="amg-wire-server", daemon=True)
        self._thread.start()
        self._ready.wait(timeout=60)
        if self._failure is not None:
            raise self._failure
        assert self.port is not None, "server failed to bind"
        return self

    def __exit__(self, *exc) -> None:
        if self._loop is not None and self._stop is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop.set)
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=60)
