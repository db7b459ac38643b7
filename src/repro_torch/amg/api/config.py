# Copy of repro/amg/api/config.py: adds AMGConfig.device and AMGConfig.ranks,
# resolves torch dtypes, and refuses what this port does not run yet.
"""Solver-session configuration and the versioned wire codec.

:class:`AMGConfig` is the frozen, hashable description of a full solver
session (setup knobs, solve options, backend/mesh/strategy/kernel knobs) —
hashability is what makes it a cache key for the session store.

The **wire codec** makes the whole serving surface addressable over a
byte-oriented transport: every payload is a plain JSON-serializable dict
tagged with a ``schema`` version and a ``kind``.  Decoders are strict —
a missing/mismatched schema version or any key the decoder does not know
raises :class:`WireError` (corrupt or future-versioned payloads fail loudly
instead of being half-applied):

* ``AMGConfig.to_wire()`` / ``AMGConfig.from_wire()`` — config round-trip.
* :func:`csr_to_wire` / :func:`csr_from_wire` — CSR matrix payloads
  (base64-encoded little-endian arrays) carrying the content
  :func:`matrix_fingerprint`, so a matrix can be registered *by fingerprint*
  and later requests can address it by that id; decode re-verifies the
  fingerprint as an integrity check.
* :func:`solve_request_to_wire` / :func:`solve_request_from_wire` — one
  solve admission (``b`` payload of shape ``[n]`` or ``[n, k]``, per-request
  :class:`RequestOptions` + ``priority``), consumed by
  :meth:`~repro.amg.api.service.AMGService.submit_wire`.
* :func:`update_request_to_wire` / :func:`update_request_from_wire` —
  schema-v2 streaming update: a full replacement CSR, a values-only
  payload, or an additive ``ΔA`` on the registered matrix's frozen
  sparsity pattern, addressed by registered fingerprint.

**Versioning.**  ``WIRE_SCHEMA`` is what this codec *emits*;
``SUPPORTED_SCHEMAS`` is what it *accepts*.  v1 frames still decode —
the v2 additions are purely additive (the ``update`` kind and the nested
``options`` key on solve requests).  A v1-tagged frame carrying a
v2-only key is rejected under strict decode (the default) and tolerated
under ``strict=False`` (a permissive proxy in front of an old client).
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib

import numpy as np
import torch

from ...core.nap_collectives import PROCESS_TODO
from ...device import resolve_device
from ..csr import CSR
from ..solve import SolveOptions

_DTYPES = ("float32", "float64", "bfloat16")
#: AMGConfig.ranks: all ranks stacked in this process, or one process each
RANKS = ("stacked", "process")
BLOCK_SMOOTHERS = ("block_jacobi", "hybrid_gs", "hybrid_gs_sym")

#: Schema version this codec emits.
WIRE_SCHEMA = 2
#: Schema versions this codec accepts (v1 frames are a strict subset).
SUPPORTED_SCHEMAS = (1, 2)


class WireError(ValueError):
    """A wire payload failed to decode (bad schema version, unknown key,
    wrong kind, or a corrupt/fingerprint-mismatched body)."""


class PatternMismatch(ValueError):
    """A streaming update's sparsity pattern does not match the session's
    frozen pattern — a value-only refresh is impossible.  Raised instead
    of silently re-running setup; callers escalate explicitly."""


# --------------------------------------------------------------------------
# Configuration
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """When does a streamed value update escalate to a full re-setup?

    A session tracks each solve's iteration count against the *baseline*
    (the first solve after the most recent setup or re-setup).  A
    value-only refresh keeps the frozen hierarchy; once convergence has
    regressed past ``regress_ratio × baseline + regress_slack``
    iterations, the next update triggers a full node-aware re-setup
    instead (pattern changes always do)."""

    regress_ratio: float = 1.5
    regress_slack: int = 2

    def __post_init__(self):
        if self.regress_ratio < 1.0:
            raise ValueError(f"regress_ratio must be >= 1, "
                             f"got {self.regress_ratio}")
        if self.regress_slack < 0:
            raise ValueError(f"regress_slack must be >= 0, "
                             f"got {self.regress_slack}")

    def regressed(self, baseline: int | None, iterations: int) -> bool:
        """Has ``iterations`` regressed past the post-setup baseline?"""
        if baseline is None:
            return False
        return iterations > self.regress_ratio * baseline + self.regress_slack


@dataclasses.dataclass(frozen=True, eq=False)
class RequestOptions:
    """Per-request solve knobs, unified across the three call surfaces
    (:meth:`AMGService.submit`, wire solve requests, and the
    ``solve``/``pcg`` free functions).

    ``tol``/``maxiter`` default to ``None`` = "use the session config's
    default" — :meth:`resolve` pins them so equal resolved options mean
    interchangeable requests.  ``x0`` is a warm start and deliberately
    **not** part of :meth:`group_key` (requests with different warm
    starts still coalesce into one multi-RHS batch)."""

    method: str = "solve"
    tol: float | None = None
    maxiter: int | None = None
    x0: np.ndarray | None = None

    def __post_init__(self):
        if self.method not in ("solve", "pcg"):
            raise ValueError(f"unknown method {self.method!r}; "
                             f"must be 'solve' or 'pcg'")

    def resolve(self, config: "AMGConfig") -> "RequestOptions":
        """Pin ``tol``/``maxiter`` from the session config's defaults."""
        tol = config.tol if self.tol is None else float(self.tol)
        maxiter = self.maxiter
        if maxiter is None:
            maxiter = (config.pcg_maxiter if self.method == "pcg"
                       else config.maxiter)
        return dataclasses.replace(self, tol=tol, maxiter=int(maxiter))

    def group_key(self) -> tuple:
        """The coalescing key: requests with equal keys may batch into one
        multi-RHS solve (the warm start rides per-request, not per-key)."""
        return (self.method, self.tol, self.maxiter)

    def to_wire_fields(self) -> dict:
        """The request-payload fields this carries (flat, v1-compatible;
        absent fields mean "config default")."""
        d: dict = {"method": self.method}
        if self.tol is not None:
            d["tol"] = float(self.tol)
        if self.maxiter is not None:
            d["maxiter"] = int(self.maxiter)
        if self.x0 is not None:
            d["x0"] = array_to_wire(np.asarray(self.x0))
        return d


@dataclasses.dataclass(frozen=True)
class AMGConfig:
    """Frozen, hashable description of a full solver session: setup knobs,
    smoother options, iteration defaults, and backend/mesh/strategy/kernel
    knobs.  Hashability is what makes it a cache key — two configs that
    compare equal always produce interchangeable solvers."""

    # -- setup phase (Algorithm 1)
    solver: str = "rs"                   # "rs" | "sa"
    theta: float = 0.25
    max_coarse: int = 100
    max_levels: int = 25
    aggressive: bool = False
    prolongation_sweeps: int = 1
    seed: int = 42
    # "host": serial numpy setup; "dist": the partitioned node-aware setup
    # (repro_torch.amg.dist_setup) — levels are born partitioned and only the
    # "torch" solve backend can consume them
    setup_backend: str = "host"
    # -- solve phase (Algorithm 2): cycle shape, smoother, sweep counts
    # (pure solve knobs — sessions differing only here share setup+lowering)
    opts: SolveOptions = dataclasses.field(default_factory=SolveOptions)
    tol: float = 1e-8
    maxiter: int = 100
    pcg_maxiter: int = 200
    # -- backend + mesh + strategy + kernel knobs
    backend: str = "host"                # registry name: "host" | "torch"
    n_pods: int = 1
    lanes: int = 1
    strategy: str = "auto"               # "auto" | "standard" | "nap2" | "nap3"
    # repro_torch.core.MACHINES name.  The default is the reference's, kept
    # only so strategy selections match it; it does not describe the H100.
    machine: str = "tpu_v5e"
    dtype: str = "float32"
    # None/True = the CUDA kernels (their plain versions on the CPU);
    # False = the plain PyTorch versions
    use_kernel: bool | None = None
    reduce_strategy: str = "nap3"        # norms/dots: "nap3" | "flat"
    # torch backend: "cuda" (default) or "cpu"; "cuda" on a machine with no
    # card raises instead of running on the CPU
    device: str = "cuda"
    # torch backend: where the ranks live — "stacked" (default): all D ranks
    # of the grid as a leading tensor dim in this process; "process": one
    # process per rank, this one holding its own rank, the collectives
    # torch.distributed calls (the reference's mesh of devices)
    ranks: str = "stacked"
    # halo-exchange/compute overlap in every distributed apply; False keeps
    # the serial fused form (the parity oracle)
    overlap: bool = True
    # streaming sessions: when does an A + ΔA update escalate from a
    # value-only refresh to a full node-aware re-setup
    refresh: RefreshPolicy = dataclasses.field(default_factory=RefreshPolicy)

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, "
                             f"got {self.dtype!r}")
        if self.setup_backend not in ("host", "dist"):
            raise ValueError(f"setup_backend must be 'host' or 'dist', "
                             f"got {self.setup_backend!r}")
        if self.setup_backend == "dist" and self.backend != "torch":
            raise ValueError(
                "setup_backend='dist' births partitioned levels that only "
                f"backend='torch' can consume (got backend={self.backend!r})")
        if self.setup_backend == "dist" and self.solver != "rs":
            raise ValueError(
                "setup_backend='dist' supports solver='rs' only "
                f"(got solver={self.solver!r})")
        from ...core import MACHINES
        if self.machine not in MACHINES:
            raise ValueError(f"unknown machine {self.machine!r}; "
                             f"known: {sorted(MACHINES)}")
        if self.ranks not in RANKS:
            raise ValueError(f"ranks must be one of {RANKS}, "
                             f"got {self.ranks!r}")
        if self.ranks == "process":
            if self.backend != "torch":
                raise ValueError("ranks='process' runs on backend='torch' "
                                 f"only (got backend={self.backend!r})")
            if self.setup_backend == "dist":
                raise NotImplementedError(
                    f"setup_backend='dist' {PROCESS_TODO}")
            if self.opts.smoother in BLOCK_SMOOTHERS:
                raise NotImplementedError(
                    f"smoother {self.opts.smoother!r} {PROCESS_TODO}")
        if self.backend == "torch":
            resolve_device(self.device)

    def replace(self, **changes) -> "AMGConfig":
        return dataclasses.replace(self, **changes)

    # ------------------------------------------------------------ round-trip
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)       # recurses into opts
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "AMGConfig":
        d = dict(d)
        opts = d.pop("opts", None)
        if isinstance(opts, dict):
            opts = SolveOptions(**opts)
        refresh = d.pop("refresh", None)
        if isinstance(refresh, dict):
            refresh = RefreshPolicy(**refresh)
        return cls(opts=opts or SolveOptions(),
                   refresh=refresh or RefreshPolicy(), **d)

    # ------------------------------------------------------------------ wire
    def to_wire(self) -> dict:
        """JSON-serializable wire payload (``schema`` + ``kind`` tagged)."""
        return {"schema": WIRE_SCHEMA, "kind": "amg_config", **self.to_dict()}

    @classmethod
    def from_wire(cls, payload: dict) -> "AMGConfig":
        """Strict decode: wrong schema version, wrong ``kind`` or ANY key
        not named by a config / :class:`SolveOptions` field raises
        :class:`WireError`."""
        body = _check_envelope(payload, "amg_config")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(body) - known
        if unknown:
            raise WireError(f"amg_config payload has unknown key(s) "
                            f"{sorted(unknown)}; known: {sorted(known)}")
        for key, klass in (("opts", SolveOptions), ("refresh", RefreshPolicy)):
            nested = body.get(key)
            if nested is None:
                continue
            if not isinstance(nested, dict):
                raise WireError(f"amg_config {key} must be a dict of "
                                f"{klass.__name__} fields, got {type(nested)}")
            nknown = {f.name for f in dataclasses.fields(klass)}
            nunknown = set(nested) - nknown
            if nunknown:
                raise WireError(f"amg_config {key} has unknown key(s) "
                                f"{sorted(nunknown)}; known: {sorted(nknown)}")
        try:
            return cls.from_dict(body)
        except (TypeError, ValueError) as e:
            raise WireError(f"amg_config payload rejected: {e}") from e

    # ------------------------------------------------------- derived kwargs
    def setup_kwargs(self) -> dict:
        return dict(solver=self.solver, theta=self.theta,
                    max_coarse=self.max_coarse, max_levels=self.max_levels,
                    aggressive=self.aggressive,
                    prolongation_sweeps=self.prolongation_sweeps,
                    seed=self.seed)

    def dist_build_kwargs(self) -> dict:
        """Kwargs for ``DistHierarchy.build`` (resolves machine + dtype)."""
        from ...core import MACHINES
        dtype = {"float32": torch.float32, "float64": torch.float64,
                 "bfloat16": torch.bfloat16}[self.dtype]
        return dict(n_pods=self.n_pods, lanes=self.lanes,
                    params=MACHINES[self.machine], strategy=self.strategy,
                    dtype=dtype, device=self.device,
                    use_kernel=self.use_kernel,
                    reduce_strategy=self.reduce_strategy,
                    overlap=self.overlap)


def matrix_fingerprint(A: CSR) -> str:
    """Content hash of a CSR matrix — the matrix half of the session key,
    and the wire-level matrix id (:func:`csr_to_wire` registration)."""
    h = hashlib.sha1()
    h.update(np.asarray(A.shape, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(A.indptr).tobytes())
    h.update(np.ascontiguousarray(A.indices).tobytes())
    h.update(np.ascontiguousarray(A.data).tobytes())
    return h.hexdigest()


def pattern_fingerprint(A: CSR) -> str:
    """Hash of the sparsity pattern only (shape + indptr + indices, no
    values) — the streaming-session invariant: two matrices with equal
    pattern fingerprints share every comm graph, halo plan, ELL layout
    and compiled program, so updates between them are value-only."""
    h = hashlib.sha1()
    h.update(np.asarray(A.shape, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(A.indptr).tobytes())
    h.update(np.ascontiguousarray(A.indices).tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------------
# Wire primitives
# --------------------------------------------------------------------------


def _check_envelope(payload, kind: str, *, min_schema: int = 1) -> dict:
    """Validate the ``schema``/``kind`` envelope; return the body (a copy
    of the payload without the envelope keys).  Any schema version in
    :data:`SUPPORTED_SCHEMAS` is accepted; ``min_schema`` floors kinds
    that did not exist before a given version (e.g. v2 ``update``)."""
    if not isinstance(payload, dict):
        raise WireError(f"wire payload must be a dict, got {type(payload)}")
    schema = payload.get("schema")
    if schema not in SUPPORTED_SCHEMAS:
        raise WireError(f"wire schema version mismatch: payload has "
                        f"{schema!r}, this codec speaks "
                        f"{list(SUPPORTED_SCHEMAS)}")
    if schema < min_schema:
        raise WireError(f"{kind!r} payloads require schema >= {min_schema}, "
                        f"got {schema}")
    got = payload.get("kind")
    if got != kind:
        raise WireError(f"expected a {kind!r} payload, got kind={got!r}")
    body = dict(payload)
    body.pop("schema")
    body.pop("kind")
    return body


# arrays travel as little-endian raw bytes, base64'd for JSON transport
_WIRE_DTYPES = {"int64": "<i8", "float64": "<f8", "float32": "<f4"}


def array_to_wire(a: np.ndarray, dtype: str | None = None) -> dict:
    """Encode an array as ``{dtype, shape, data}`` (base64, little-endian).
    ``dtype`` re-types on the way out (e.g. fp32 payloads for fp64 data —
    half the bytes, the receiver sees the rounded values)."""
    a = np.ascontiguousarray(a)
    name = dtype or str(a.dtype)
    if name not in _WIRE_DTYPES:
        raise WireError(f"unsupported wire array dtype {name!r}; "
                        f"supported: {sorted(_WIRE_DTYPES)}")
    raw = a.astype(_WIRE_DTYPES[name]).tobytes()
    return {"dtype": name, "shape": list(a.shape),
            "data": base64.b64encode(raw).decode("ascii")}


def array_from_wire(d: dict) -> np.ndarray:
    unknown = set(d) - {"dtype", "shape", "data"}
    if unknown:
        raise WireError(f"array payload has unknown key(s) {sorted(unknown)}")
    try:
        wire_dtype = _WIRE_DTYPES[d["dtype"]]
    except KeyError:
        raise WireError(f"unsupported wire array dtype {d.get('dtype')!r}; "
                        f"supported: {sorted(_WIRE_DTYPES)}") from None
    try:
        raw = base64.b64decode(d["data"], validate=True)
        a = np.frombuffer(raw, dtype=wire_dtype)
        return a.reshape(d["shape"]).astype(d["dtype"])
    except (KeyError, ValueError, TypeError) as e:
        raise WireError(f"corrupt array payload: {e}") from e


def csr_to_wire(A: CSR, dtype: str = "float64") -> dict:
    """Encode a CSR matrix for registration over the wire.

    ``dtype`` controls the value payload ("float32" halves it; index arrays
    stay int64).  The embedded ``fingerprint`` is computed over the matrix
    **as the receiver will decode it** (i.e. after any value rounding), so
    :func:`csr_from_wire` can verify integrity and the sender knows the id
    the matrix will be registered under."""
    data = A.data if dtype == "float64" else \
        A.data.astype(dtype).astype(np.float64)
    decoded = CSR(A.shape, np.ascontiguousarray(A.indptr),
                  np.ascontiguousarray(A.indices), data)
    return {"schema": WIRE_SCHEMA, "kind": "csr",
            "shape": [int(A.nrows), int(A.ncols)],
            "indptr": array_to_wire(A.indptr, "int64"),
            "indices": array_to_wire(A.indices, "int64"),
            "data": array_to_wire(A.data, dtype),
            "fingerprint": matrix_fingerprint(decoded)}


def csr_from_wire(payload: dict) -> tuple[CSR, str]:
    """Decode a CSR payload; returns ``(matrix, fingerprint)``.

    The fingerprint is recomputed from the decoded arrays and checked
    against the payload's claim — a mismatch means transport corruption."""
    body = _check_envelope(payload, "csr")
    unknown = set(body) - {"shape", "indptr", "indices", "data",
                           "fingerprint"}
    if unknown:
        raise WireError(f"csr payload has unknown key(s) {sorted(unknown)}")
    try:
        shape = (int(body["shape"][0]), int(body["shape"][1]))
        A = CSR(shape=shape,
                indptr=array_from_wire(body["indptr"]),
                indices=array_from_wire(body["indices"]),
                data=array_from_wire(body["data"]).astype(np.float64))
    except (KeyError, IndexError, TypeError, ValueError) as e:
        raise WireError(f"corrupt csr payload: {e}") from e
    if A.indptr.shape != (shape[0] + 1,) or A.indices.shape != A.data.shape:
        raise WireError(f"inconsistent csr payload: indptr {A.indptr.shape} "
                        f"for {shape[0]} rows, indices {A.indices.shape} vs "
                        f"data {A.data.shape}")
    fp = matrix_fingerprint(A)
    claimed = body.get("fingerprint")
    if claimed is not None and claimed != fp:
        raise WireError(f"csr payload fingerprint mismatch: payload claims "
                        f"{claimed}, decoded content hashes to {fp}")
    return A, fp


# v1 request keys; "options" arrived with schema 2 (a v1-tagged frame
# carrying it is rejected under strict decode, tolerated otherwise)
_REQUEST_KEYS = {"matrix", "b", "method", "tol", "maxiter", "x0", "priority",
                 "rid"}
_V2_REQUEST_KEYS = {"options"}


def solve_request_to_wire(matrix_id: str, b: np.ndarray, *,
                          options: RequestOptions | None = None,
                          method: str | None = None, tol: float | None = None,
                          maxiter: int | None = None,
                          x0: np.ndarray | None = None,
                          priority=None, rid: int | None = None) -> dict:
    """Encode one solve admission (``b``: [n] or [n, k]) for
    :meth:`~repro.amg.api.service.AMGService.submit_wire`.

    The solve knobs travel as the flat v1 field set (``method``/``tol``/
    ``maxiter``/``x0``) so v1 decoders still read v2 frames; pass either
    an ``options`` dataclass or the individual fields, not both."""
    if options is None:
        options = RequestOptions(method=method or "solve", tol=tol,
                                 maxiter=maxiter, x0=x0)
    elif any(v is not None for v in (method, tol, maxiter, x0)):
        raise ValueError("pass options= or individual solve knobs, not both")
    d = {"schema": WIRE_SCHEMA, "kind": "solve_request",
         "matrix": matrix_id, "b": array_to_wire(np.asarray(b)),
         **options.to_wire_fields()}
    if priority is not None:
        d["priority"] = priority
    if rid is not None:
        d["rid"] = int(rid)
    return d


def solve_request_from_wire(payload: dict, *, strict: bool = True) -> dict:
    """Strict decode of a solve request; returns kwargs for
    :meth:`AMGService.submit` — ``{"matrix_id", "b", "options", ...}``
    with the solve knobs folded into one :class:`RequestOptions`.

    Accepts both the flat v1 knob fields and the nested v2 ``options``
    dict.  Under ``strict`` (the default) a v1-tagged frame carrying the
    v2-only ``options`` key is rejected; ``strict=False`` tolerates the
    additive key."""
    body = _check_envelope(payload, "solve_request")
    schema = payload.get("schema")
    unknown = set(body) - _REQUEST_KEYS - _V2_REQUEST_KEYS
    if unknown:
        raise WireError(f"solve_request payload has unknown key(s) "
                        f"{sorted(unknown)}; known: "
                        f"{sorted(_REQUEST_KEYS | _V2_REQUEST_KEYS)}")
    if strict and schema < 2:
        additive = set(body) & _V2_REQUEST_KEYS
        if additive:
            raise WireError(f"schema-{schema} solve_request carries "
                            f"v2-only key(s) {sorted(additive)} "
                            f"(strict decode)")
    try:
        out = {"matrix_id": body["matrix"], "b": array_from_wire(body["b"])}
    except KeyError as e:
        raise WireError(f"solve_request payload missing {e.args[0]!r}") \
            from None
    raw = body.get("options") if (schema >= 2 or not strict) else None
    if raw is not None and not isinstance(raw, dict):
        raise WireError(f"solve_request options must be a dict, "
                        f"got {type(raw)}")
    knobs = dict(raw or {})
    oknown = {"method", "tol", "maxiter", "x0"}
    ounknown = set(knobs) - oknown
    if ounknown:
        raise WireError(f"solve_request options has unknown key(s) "
                        f"{sorted(ounknown)}; known: {sorted(oknown)}")
    for key in oknown:                      # flat v1 fields fill the gaps
        if key in body and key not in knobs:
            knobs[key] = body[key]
    try:
        out["options"] = RequestOptions(
            method=str(knobs.get("method", "solve")),
            tol=float(knobs["tol"]) if "tol" in knobs else None,
            maxiter=int(knobs["maxiter"]) if "maxiter" in knobs else None,
            x0=array_from_wire(knobs["x0"]) if "x0" in knobs else None)
    except ValueError as e:
        raise WireError(f"solve_request options rejected: {e}") from e
    if "priority" in body:
        out["priority"] = body["priority"]
    if "rid" in body:
        out["rid"] = int(body["rid"])
    return out


# --------------------------------------------------------------------------
# Streaming updates (schema v2)
# --------------------------------------------------------------------------

_UPDATE_KEYS = {"matrix", "csr", "data", "delta", "rid"}


def update_request_to_wire(matrix_id: str, A: CSR | None = None, *,
                           data: np.ndarray | None = None,
                           delta: np.ndarray | None = None,
                           dtype: str = "float64",
                           rid: int | None = None) -> dict:
    """Encode a streaming matrix update addressed to a registered matrix.

    Exactly one payload form:

    * ``A`` — a full replacement CSR (the server decides refresh vs
      re-setup by comparing sparsity patterns);
    * ``data`` — new values on the registered matrix's frozen pattern
      (``A_new.data`` in CSR order, ``nnz`` floats);
    * ``delta`` — additive ``ΔA`` values on the frozen pattern
      (``A_new = A_old + ΔA``), the cheapest form for slow drift.
    """
    forms = [A is not None, data is not None, delta is not None]
    if sum(forms) != 1:
        raise ValueError("update needs exactly one of A=, data= or delta=")
    d: dict = {"schema": WIRE_SCHEMA, "kind": "update_request",
               "matrix": matrix_id}
    if A is not None:
        d["csr"] = csr_to_wire(A, dtype)
    elif data is not None:
        d["data"] = array_to_wire(np.asarray(data, dtype=np.float64), dtype)
    else:
        d["delta"] = array_to_wire(np.asarray(delta, dtype=np.float64), dtype)
    if rid is not None:
        d["rid"] = int(rid)
    return d


def update_request_from_wire(payload: dict) -> dict:
    """Strict decode of an update request; returns kwargs for
    :meth:`AMGService.update` (``matrix_id`` + exactly one of
    ``A``/``data``/``delta``).  Requires schema >= 2."""
    body = _check_envelope(payload, "update_request", min_schema=2)
    unknown = set(body) - _UPDATE_KEYS
    if unknown:
        raise WireError(f"update_request payload has unknown key(s) "
                        f"{sorted(unknown)}; known: {sorted(_UPDATE_KEYS)}")
    if "matrix" not in body:
        raise WireError("update_request payload missing 'matrix'")
    forms = [k for k in ("csr", "data", "delta") if k in body]
    if len(forms) != 1:
        raise WireError(f"update_request needs exactly one of "
                        f"csr/data/delta, got {forms or 'none'}")
    out: dict = {"matrix_id": body["matrix"]}
    if "csr" in body:
        out["A"], _ = csr_from_wire(body["csr"])
    elif "data" in body:
        out["data"] = array_from_wire(body["data"]).astype(np.float64)
    else:
        out["delta"] = array_from_wire(body["delta"]).astype(np.float64)
    if "rid" in body:
        out["rid"] = int(body["rid"])
    return out


def apply_update(A: CSR, *, data: np.ndarray | None = None,
                 delta: np.ndarray | None = None) -> CSR:
    """Materialize a values-only update on ``A``'s frozen pattern."""
    if (data is None) == (delta is None):
        raise ValueError("pass exactly one of data= or delta=")
    vals = np.asarray(data if data is not None else delta, dtype=np.float64)
    if vals.shape != A.data.shape:
        raise PatternMismatch(
            f"update carries {vals.shape[0] if vals.ndim else 0} values for "
            f"a pattern with {A.data.shape[0]} nonzeros")
    new = vals if data is not None else A.data + vals
    return CSR(A.shape, np.ascontiguousarray(A.indptr),
               np.ascontiguousarray(A.indices), np.ascontiguousarray(new))
