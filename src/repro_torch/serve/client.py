# Verbatim copy of repro/serve/client.py; only the imports and module paths may differ.
"""Blocking AMGWire client: one TCP connection, pipelined requests.

The client assigns a monotonically increasing ``seq`` to every request
and a background reader thread routes response frames back to the
waiting caller — so many threads can pipeline solves down one connection
and collect them out of order, exactly the shape the open-loop load
generator needs.  Responses come back as the raw envelope dicts;
:meth:`solve` additionally decodes ``solution`` frames into
``(x, diagnostics)`` and raises typed :class:`Rejected` /
:class:`RemoteError` for the backpressure and error frames, so callers
can tell "shed by admission" from "the solve failed" from "I sent
garbage" without string matching.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time

import numpy as np

from ..amg.api import SUPPORTED_SCHEMAS, WIRE_SCHEMA, array_from_wire
from .wire import MAX_FRAME_BYTES, _HEADER


class Rejected(RuntimeError):
    """The server shed this request (429-style ``rejected`` frame)."""

    def __init__(self, frame: dict):
        self.frame = frame
        super().__init__(frame.get("reason", "rejected"))


class RemoteError(RuntimeError):
    """The server answered with a structured ``error`` frame."""

    def __init__(self, frame: dict):
        self.frame = frame
        self.code = frame.get("code")
        self.error = frame.get("error")
        super().__init__(f"[{self.code}] {self.error}: "
                         f"{frame.get('message')}")


class AMGWireClient:
    """``with AMGWireClient.connect(host, port) as c: c.solve(...)``."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._wlock = threading.Lock()
        self._slock = threading.Lock()
        self._next_seq = 0
        self._waiting: dict[int, "_Slot"] = {}
        self._orphans: list[dict] = []
        self._orphans_ready = threading.Event()
        self._closed = False
        self.hello: dict | None = None   # the server's greeting, once seen
        self.schema = WIRE_SCHEMA        # negotiated down on connect()
        self._reader = threading.Thread(target=self._read_loop,
                                        name="amg-wire-client", daemon=True)
        self._reader.start()

    @classmethod
    def connect(cls, host: str, port: int,
                timeout: float = 60.0) -> "AMGWireClient":
        """Connect and negotiate: the server greets with a ``hello`` frame
        advertising its ``supported_schemas``; the client speaks the
        highest version both sides know.  A server that never says hello
        (a pre-v2 server) leaves the client at its own default."""
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(None)
        client = cls(sock)
        try:
            frame = client.recv_unmatched(timeout=min(timeout, 5.0))
        except TimeoutError:
            return client
        if frame.get("kind") != "hello":     # not a greeting: put it back
            with client._slock:
                client._orphans.insert(0, frame)
                client._orphans_ready.set()
            return client
        client.hello = frame
        offered = frame.get("supported_schemas") or [WIRE_SCHEMA]
        common = [s for s in offered if s in SUPPORTED_SCHEMAS]
        if not common:
            client.close()
            raise RuntimeError(
                f"no common wire schema: server speaks {offered}, "
                f"client speaks {list(SUPPORTED_SCHEMAS)}")
        client.schema = max(common)
        return client

    # ----------------------------------------------------------- raw framing
    def send(self, kind: str, *, tenant: str | None = None,
             payload: dict | None = None, **extra) -> int:
        """Send one request frame; returns its ``seq`` (await it with
        :meth:`recv`)."""
        with self._slock:
            seq = self._next_seq
            self._next_seq += 1
            self._waiting[seq] = _Slot()
        frame = {"schema": self.schema, "kind": kind, "seq": seq, **extra}
        if tenant is not None:
            frame["tenant"] = tenant
        if payload is not None:
            frame["payload"] = payload
        self.send_raw(json.dumps(frame, separators=(",", ":"))
                      .encode("utf-8"))
        return seq

    def send_raw(self, body: bytes) -> None:
        """Send pre-encoded bytes as one frame (tests use this to send
        deliberately malformed bodies)."""
        with self._wlock:
            self._sock.sendall(_HEADER.pack(len(body)) + body)

    def recv(self, seq: int, timeout: float | None = 60.0) -> dict:
        """Block until the response for ``seq`` arrives; returns the raw
        envelope frame (kind may be solution/registered/rejected/error/...).
        """
        return self.recv_timed(seq, timeout)[0]

    def recv_timed(self, seq: int,
                   timeout: float | None = 60.0) -> tuple[dict, float]:
        """Like :meth:`recv` but also returns the ``perf_counter`` time the
        reader thread saw the response — so an open-loop load generator
        harvesting long after the fact still measures true latency."""
        with self._slock:
            slot = self._waiting[seq]
        if not slot.event.wait(timeout):
            raise TimeoutError(f"no response for seq {seq} "
                               f"after {timeout}s")
        with self._slock:
            self._waiting.pop(seq, None)
        if slot.frame is None:
            raise ConnectionError("connection closed while waiting "
                                  f"for seq {seq}")
        return slot.frame, slot.t_recv

    def recv_unmatched(self, timeout: float | None = 60.0) -> dict:
        """Block until a frame with no registered seq arrives (server
        responses to raw/malformed sends carry ``seq: null``)."""
        if not self._orphans_ready.wait(timeout):
            raise TimeoutError(f"no unmatched frame after {timeout}s")
        with self._slock:
            frame = self._orphans.pop(0)
            if not self._orphans:
                self._orphans_ready.clear()
        return frame

    # --------------------------------------------------------- typed helpers
    def register(self, tenant: str, payload: dict,
                 timeout: float | None = 60.0) -> dict:
        """Register an encoded CSR (``csr_to_wire`` payload); returns the
        ``registered`` frame.  Raises :class:`Rejected` on quota."""
        frame = self.recv(self.send("register", tenant=tenant,
                                    payload=payload), timeout)
        return self._typed(frame, "registered")

    def solve(self, tenant: str, payload: dict,
              timeout: float | None = 60.0) -> tuple[np.ndarray, dict]:
        """Submit an encoded solve request; returns ``(x, diagnostics)``.
        Raises :class:`Rejected` (shed) or :class:`RemoteError`."""
        frame = self.recv(self.send("solve", tenant=tenant,
                                    payload=payload), timeout)
        frame = self._typed(frame, "solution")
        return array_from_wire(frame["x"]), frame.get("diagnostics") or {}

    def update(self, tenant: str, payload: dict,
               timeout: float | None = 60.0) -> dict:
        """Stream a value update (``update_request_to_wire`` payload) into
        a tenant's live session; returns the ``updated`` frame (``action``
        is ``"refresh"`` or ``"resetup"``, ``reason`` the trigger).
        Raises :class:`RemoteError` — 404 for an unregistered matrix."""
        frame = self.recv(self.send("update", tenant=tenant,
                                    payload=payload), timeout)
        return self._typed(frame, "updated")

    def stats(self, tenant: str | None = None,
              timeout: float | None = 60.0) -> dict:
        frame = self.recv(self.send("stats", tenant=tenant), timeout)
        return self._typed(frame, "stats")

    def ping(self, timeout: float | None = 60.0) -> dict:
        return self._typed(self.recv(self.send("ping"), timeout), "pong")

    @staticmethod
    def _typed(frame: dict, want: str) -> dict:
        kind = frame.get("kind")
        if kind == want:
            return frame
        if kind == "rejected":
            raise Rejected(frame)
        if kind == "error":
            raise RemoteError(frame)
        raise RuntimeError(f"expected a {want!r} frame, got {kind!r}: "
                           f"{frame}")

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._reader.join(timeout=10)

    def __enter__(self) -> "AMGWireClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ read loop
    def _read_loop(self) -> None:
        try:
            while True:
                frame = self._read_frame()
                if frame is None:
                    break
                seq = frame.get("seq")
                t = time.perf_counter()
                with self._slock:
                    slot = self._waiting.get(seq)
                if slot is not None:
                    slot.frame = frame
                    slot.t_recv = t
                    slot.event.set()
                else:
                    with self._slock:
                        self._orphans.append(frame)
                        self._orphans_ready.set()
        finally:
            # wake every waiter so nobody blocks on a dead connection
            with self._slock:
                slots = list(self._waiting.values())
            for slot in slots:
                slot.event.set()

    def _read_frame(self) -> dict | None:
        header = self._recv_exact(_HEADER.size)
        if header is None:
            return None
        (length,) = struct.unpack(">I", header)
        if length > MAX_FRAME_BYTES:
            return None
        body = self._recv_exact(length)
        if body is None:
            return None
        try:
            obj = json.loads(body)
        except ValueError:
            return None
        return obj if isinstance(obj, dict) else None

    def _recv_exact(self, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf


class _Slot:
    __slots__ = ("event", "frame", "t_recv")

    def __init__(self):
        self.event = threading.Event()
        self.frame: dict | None = None
        self.t_recv = 0.0
