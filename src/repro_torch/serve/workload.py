# Copy of repro/serve/workload.py: default_tol also covers the torch backend; only the imports may differ otherwise.
"""Shared workload construction for the AMG serving harnesses.

The in-process harness (``repro_torch.launch.serve --solver amg``), the
socket server's tests and ``chip_smoke.py``'s wire phase build the same
traffic as the reference's harnesses: a small family of 3-D Laplacian
matrices registered by content fingerprint, Gaussian right-hand sides
encoded through the versioned wire codec with one real JSON byte hop, and
relative-residual validation of every returned solution.  A request built
here is byte-for-byte the reference's for the same generator state.
"""
from __future__ import annotations

import json

import numpy as np

from ..amg.api import (csr_to_wire, matrix_fingerprint,
                       solve_request_to_wire, update_request_to_wire)
from ..amg.problems import laplace_3d


def default_tol(backend: str, tol: float | None = None,
                dtype: str = "float32") -> float:
    """The torch backend computes in ``dtype``, float32 by default, whose
    residual floor (~1e-7 relative) sits above the host default tol — don't
    let every solve burn maxiter chasing an unreachable tolerance (the
    reference's 1e-6 for its fp32 ``dist``).  A bfloat16 session defaults
    to 1e-5, which its PCG reaches (8 bits of mantissa); a float64 torch
    session and the host backend to 1e-8."""
    if tol is not None:
        return float(tol)
    if backend == "torch" and dtype in ("float32", "bfloat16"):
        return 1e-6 if dtype == "float32" else 1e-5
    return 1e-8


def json_hop(obj: dict) -> dict:
    """One real JSON byte round-trip — proves the payload is what would
    survive an actual transport, not just a dict that happens to work."""
    return json.loads(json.dumps(obj))


def build_problems(n: int, count: int = 2) -> dict:
    """``count`` Laplacian test matrices at descending grid sizes starting
    from ``n`` (floor 4), keyed by content fingerprint — the id they
    register under over the wire."""
    sizes, size = [], max(4, int(n))
    for _ in range(max(1, count)):
        sizes.append(size)
        size = max(4, size - 2)
    out = {}
    for s in dict.fromkeys(sizes):
        A = laplace_3d(s)
        out[matrix_fingerprint(A)] = A
    return out


def matrix_payloads(problems: dict) -> dict:
    """Encoded registration payloads per matrix id (JSON round-tripped)."""
    return {mid: json_hop(csr_to_wire(A)) for mid, A in problems.items()}


def make_request(rng: np.random.Generator, problems: dict, mid: str, *,
                 method: str = "pcg", rid: int | None = None,
                 priority=None) -> tuple[np.ndarray, dict]:
    """One solve admission against ``mid``: a Gaussian right-hand side and
    its encoded (JSON round-tripped) ``solve_request`` payload."""
    b = rng.standard_normal(problems[mid].nrows)
    payload = json_hop(solve_request_to_wire(
        mid, b, method=method, rid=rid, priority=priority))
    return b, payload


def make_update(rng: np.random.Generator, problems: dict, mid: str, *,
                scale: float = 1e-3, rid: int | None = None) -> dict:
    """One streaming value update against ``mid``: a small random additive
    ΔA on the frozen sparsity pattern (symmetrized so pcg's SPD assumption
    survives the drift) as an encoded (JSON round-tripped)
    ``update_request`` payload.  Mutates ``problems[mid]`` to the drifted
    matrix so later residual validation uses the operator the server is
    actually solving with."""
    A = problems[mid]
    delta = scale * np.abs(A.data) * rng.standard_normal(A.nnz)
    # the Laplacian pattern is symmetric, so transposing the delta on the
    # frozen pattern and averaging keeps the drifted operator symmetric
    delta = 0.5 * (delta + A.__class__(A.shape, A.indptr, A.indices,
                                       delta).T.data)
    payload = json_hop(update_request_to_wire(mid, delta=delta, rid=rid))
    problems[mid] = A.__class__(A.shape, A.indptr, A.indices,
                                A.data + delta)
    return payload


def rel_residual(A, x: np.ndarray, b: np.ndarray) -> float:
    """``|b - A x| / |b|`` — the validation every harness applies to every
    returned solution."""
    nb = float(np.linalg.norm(b))
    return float(np.linalg.norm(b - A.matvec(np.asarray(x)))) / (nb or 1.0)


def percentile(sorted_samples: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample list."""
    if not sorted_samples:
        return float("nan")
    rank = max(0, min(len(sorted_samples) - 1,
                      int(np.ceil(q / 100.0 * len(sorted_samples))) - 1))
    return float(sorted_samples[rank])


def summarize_latencies(samples_s: list[float]) -> dict:
    """p50/p99/p999 + mean/max latency (milliseconds) of a sample list
    given in seconds; empty dict when there are no samples (a fully-shed
    class has no latency distribution)."""
    if not samples_s:
        return {}
    s = sorted(samples_s)
    return {"p50_ms": percentile(s, 50.0) * 1e3,
            "p99_ms": percentile(s, 99.0) * 1e3,
            "p999_ms": percentile(s, 99.9) * 1e3,
            "mean_ms": float(np.mean(s)) * 1e3,
            "max_ms": s[-1] * 1e3}
