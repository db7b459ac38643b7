"""Session API of the port (``repro/amg/api`` counterpart).

Surface::

    cfg = AMGConfig(backend="torch", n_pods=2, lanes=4, dtype="float64")
    bound = AMGSolver(cfg).setup(A)      # cached per (matrix, config)
    res = bound.pcg(b)                   # b: [n] or [n, k] (multi-RHS)

Backends: ``"host"`` (numpy reference) and ``"torch"`` (rank-stacked device
solve through the CUDA kernels; ``device="cuda"`` by default).
"""
from .config import (AMGConfig, RefreshPolicy, RequestOptions,
                     SUPPORTED_SCHEMAS, WIRE_SCHEMA, WireError,
                     array_from_wire, array_to_wire, csr_from_wire,
                     csr_to_wire, matrix_fingerprint, pattern_fingerprint,
                     solve_request_from_wire, solve_request_to_wire)
from .registry import (available_backends, backend_class, bind_hierarchy,
                       register_backend)
from .sessions import (AMGSolver, BoundSolver, CacheEntry, EvictionPolicy,
                       HostBoundSolver, LRUPolicy, SESSION_CACHE_SIZE,
                       SessionStore, TorchBoundSolver, clear_sessions,
                       session_count, session_nbytes)

__all__ = [
    "AMGConfig", "AMGSolver", "BoundSolver", "CacheEntry", "EvictionPolicy",
    "HostBoundSolver", "LRUPolicy", "RefreshPolicy", "RequestOptions",
    "SESSION_CACHE_SIZE", "SUPPORTED_SCHEMAS", "SessionStore",
    "TorchBoundSolver", "WIRE_SCHEMA", "WireError", "array_from_wire",
    "array_to_wire", "available_backends", "backend_class", "bind_hierarchy",
    "clear_sessions", "csr_from_wire", "csr_to_wire", "matrix_fingerprint",
    "pattern_fingerprint", "register_backend", "session_count",
    "session_nbytes", "solve_request_from_wire", "solve_request_to_wire",
]
