"""Serving front-ends of the port: the batched LM generation engine and the
AMGWire socket server over :class:`~repro_torch.amg.api.AMGService`."""
from .client import AMGWireClient, Rejected, RemoteError
from .engine import Engine, Request, prefill_to_decode_cache
from .server import (AMGWireServer, ServerThread, TenantSpec,
                     priority_class_name, ticket_future)
from .wire import (BadFrame, FrameTooLarge, MAX_FRAME_BYTES, REQUEST_KINDS,
                   RESPONSE_KINDS, check_request_envelope, encode_frame,
                   error_frame, read_frame, response_frame)

__all__ = [
    "AMGWireClient", "AMGWireServer", "BadFrame", "Engine", "FrameTooLarge",
    "MAX_FRAME_BYTES", "REQUEST_KINDS", "RESPONSE_KINDS", "Rejected",
    "RemoteError", "Request", "ServerThread", "TenantSpec",
    "check_request_envelope", "encode_frame", "error_frame",
    "prefill_to_decode_cache", "priority_class_name", "read_frame",
    "response_frame", "ticket_future",
]
