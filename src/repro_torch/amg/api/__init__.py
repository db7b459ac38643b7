"""Session API of the port (``repro/amg/api`` counterpart).

Surface::

    cfg = AMGConfig(backend="torch", n_pods=2, lanes=4, dtype="float64")
    bound = AMGSolver(cfg).setup(A)      # cached per (matrix, config)
    res = bound.pcg(b)                   # b: [n] or [n, k] (multi-RHS)
    bound.update(delta=dA)               # A + ΔA on the frozen pattern

    # the partitioned setup: levels born per rank, lowered straight onto the
    # card (no host Hierarchy; bound.hierarchy is None)
    cfg = AMGConfig(backend="torch", setup_backend="dist", n_pods=2,
                    lanes=4, dtype="float64")

    with AMGService(cfg) as svc:         # coalesces requests into the
        svc.register("m", A)             # multi-RHS programs
        x = svc.submit("m", b, method="pcg").result()

Backends: ``"host"`` (numpy reference) and ``"torch"`` (rank-stacked device
solve through the CUDA kernels; ``device="cuda"`` by default).
"""
from .config import (AMGConfig, PatternMismatch, RefreshPolicy,
                     RequestOptions, SUPPORTED_SCHEMAS, WIRE_SCHEMA,
                     WireError, apply_update, array_from_wire, array_to_wire,
                     csr_from_wire, csr_to_wire, matrix_fingerprint,
                     pattern_fingerprint, solve_request_from_wire,
                     solve_request_to_wire, update_request_from_wire,
                     update_request_to_wire)
from .registry import (available_backends, backend_class, bind_hierarchy,
                       register_backend)
from .sessions import (AMGSolver, BoundSolver, BytesBudgetPolicy, CacheEntry,
                       EvictionPolicy, HostBoundSolver, LRUPolicy,
                       SESSION_CACHE_SIZE, SessionStore, TorchBoundSolver,
                       TTLPolicy, clear_sessions, session_count,
                       session_nbytes)
from .service import (AMGService, PRIORITY_CLASSES, ServiceClosed,
                      ServiceReport, Ticket)

__all__ = [
    "AMGConfig", "AMGService", "AMGSolver", "BoundSolver",
    "BytesBudgetPolicy", "CacheEntry", "EvictionPolicy", "HostBoundSolver",
    "LRUPolicy", "PRIORITY_CLASSES", "PatternMismatch", "RefreshPolicy",
    "RequestOptions", "SESSION_CACHE_SIZE", "SUPPORTED_SCHEMAS",
    "ServiceClosed", "ServiceReport", "SessionStore", "TTLPolicy", "Ticket",
    "TorchBoundSolver", "WIRE_SCHEMA", "WireError", "apply_update",
    "array_from_wire", "array_to_wire", "available_backends",
    "backend_class", "bind_hierarchy", "clear_sessions", "csr_from_wire",
    "csr_to_wire", "matrix_fingerprint", "pattern_fingerprint",
    "register_backend", "session_count", "session_nbytes",
    "solve_request_from_wire", "solve_request_to_wire",
    "update_request_from_wire", "update_request_to_wire",
]
