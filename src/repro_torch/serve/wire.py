# Verbatim copy of repro/serve/wire.py; only the imports and module paths may differ.
"""Length-prefixed JSON framing for the AMGWire protocol.

One frame = a 4-byte big-endian unsigned length followed by that many
bytes of UTF-8 JSON.  The framing is the transport half of the serving
story; the *content* of every frame is the existing versioned wire codec
(:mod:`repro_torch.amg.api.config`) wrapped in a small server envelope:

Client → server frames (``schema`` may be any version the server
supports — v1 frames still decode on a v2 server)::

    {"schema": 2, "kind": "register", "tenant": T, "seq": n,
     "payload": csr_to_wire(A)}
    {"schema": 2, "kind": "solve",    "tenant": T, "seq": n,
     "payload": solve_request_to_wire(...)}
    {"schema": 2, "kind": "update",   "tenant": T, "seq": n,   # schema ≥ 2
     "payload": update_request_to_wire(...)}
    {"schema": 2, "kind": "stats",    "tenant": T?, "seq": n}
    {"schema": 2, "kind": "ping",     "seq": n}

Server → client frames::

    {"schema": 2, "kind": "hello",      "seq": null,           # on connect
     "supported_schemas": [1, 2], "tenants": [...]}
    {"schema": 2, "kind": "registered", "seq": n, "matrix": fp,
     "bytes": nb}
    {"schema": 2, "kind": "solution",   "seq": n, "x": array_to_wire(x),
     "diagnostics": {...}}
    {"schema": 2, "kind": "updated",    "seq": n, "matrix": id,
     "action": "refresh"|"resetup", "reason": ...}
    {"schema": 2, "kind": "rejected",   "seq": n, "code": 429,
     "reason": ..., ...}       # admission backpressure, NEVER a dropped
                               # connection
    {"schema": 2, "kind": "error",      "seq": n?, "code": 4xx/5xx,
     "error": ExcName, "message": ...}
    {"schema": 2, "kind": "stats",      "seq": n, "tenants": {...}}
    {"schema": 2, "kind": "pong",       "seq": n}

``seq`` is a client-chosen correlation id: solves complete out of order,
so responses echo it.  The unsolicited ``hello`` frame (``seq: null``)
advertises the schema versions the server accepts so a client can
negotiate down (or refuse) before sending anything.  Decode failures
never desynchronize the stream — an oversized body is drained and a
too-large/undecodable frame surfaces as a typed :class:`WireError`
subclass the server turns into a structured ``error`` frame while the
connection stays up.
"""
from __future__ import annotations

import asyncio
import json
import struct

from ..amg.api.config import SUPPORTED_SCHEMAS, WIRE_SCHEMA, WireError

MAX_FRAME_BYTES = 1 << 26        # 64 MiB: far beyond any smoke matrix
_HEADER = struct.Struct(">I")

REQUEST_KINDS = ("register", "solve", "update", "stats", "ping")
RESPONSE_KINDS = ("hello", "registered", "solution", "updated", "rejected",
                  "error", "stats", "pong")
# frame kinds that did not exist in a given schema version: a frame
# claiming an older schema must not smuggle in newer kinds
_KIND_MIN_SCHEMA = {"update": 2}


class FrameTooLarge(WireError):
    """A frame's declared length exceeds the limit (body was drained, the
    stream stays aligned on the next frame boundary)."""


class BadFrame(WireError):
    """A frame's body is not a JSON object."""


def encode_frame(obj: dict) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise FrameTooLarge(f"frame of {len(body)} bytes exceeds the "
                            f"{MAX_FRAME_BYTES}-byte limit")
    return _HEADER.pack(len(body)) + body


async def read_frame(reader: asyncio.StreamReader,
                     max_frame: int = MAX_FRAME_BYTES) -> dict | None:
    """Read one frame; ``None`` on EOF (clean or mid-frame disconnect).

    Raises :class:`FrameTooLarge` (after draining the oversized body) or
    :class:`BadFrame` — both recoverable: the next :func:`read_frame` on
    the same reader starts at the next frame boundary.
    """
    try:
        header = await reader.readexactly(_HEADER.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _HEADER.unpack(header)
    if length > max_frame:
        remaining = length
        while remaining > 0:            # drain: stay frame-aligned
            chunk = await reader.read(min(remaining, 1 << 20))
            if not chunk:
                return None
            remaining -= len(chunk)
        raise FrameTooLarge(f"frame of {length} bytes exceeds the "
                            f"{max_frame}-byte limit")
    try:
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    try:
        obj = json.loads(body)
    except (ValueError, UnicodeDecodeError) as e:
        raise BadFrame(f"frame body is not valid JSON: {e}") from e
    if not isinstance(obj, dict):
        raise BadFrame(f"frame body must be a JSON object, "
                       f"got {type(obj).__name__}")
    return obj


def check_request_envelope(frame: dict) -> str:
    """Validate a client frame's ``schema``/``kind``; returns the kind.
    Any supported schema version is accepted (a v1 client keeps working
    against a v2 server), but a kind introduced by a later version is
    rejected when the frame claims an older schema.  Raises
    :class:`WireError` on version mismatch or unknown kind (the server
    answers with a structured error frame, exactly like the inner codec's
    strict decoders)."""
    schema = frame.get("schema")
    if schema not in SUPPORTED_SCHEMAS:
        raise WireError(f"wire schema version mismatch: frame has "
                        f"{schema!r}, this server speaks "
                        f"{list(SUPPORTED_SCHEMAS)}")
    kind = frame.get("kind")
    if kind not in REQUEST_KINDS:
        raise WireError(f"unknown frame kind {kind!r}; "
                        f"known: {list(REQUEST_KINDS)}")
    if schema < _KIND_MIN_SCHEMA.get(kind, 1):
        raise WireError(f"frame kind {kind!r} needs schema >= "
                        f"{_KIND_MIN_SCHEMA[kind]}, frame has {schema}")
    return kind


def hello_frame(tenants) -> dict:
    """The unsolicited server greeting: advertises the schema versions the
    server accepts (clients negotiate on ``supported_schemas``) and the
    tenant names it hosts."""
    return response_frame("hello", None,
                          supported_schemas=list(SUPPORTED_SCHEMAS),
                          tenants=sorted(tenants))


def response_frame(kind: str, seq, **fields) -> dict:
    assert kind in RESPONSE_KINDS, kind
    return {"schema": WIRE_SCHEMA, "kind": kind, "seq": seq, **fields}


def error_frame(seq, exc: BaseException, code: int) -> dict:
    return response_frame("error", seq, code=code,
                          error=type(exc).__name__, message=str(exc))
