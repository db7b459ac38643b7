# Verbatim copy of repro/amg/solve.py (numpy only); only the imports may differ.
"""AMG solve phase (Algorithm 2): V/W/F-cycles, stand-alone iteration, PCG.

The smoother is SpMV-based, so every relaxation sweep, residual,
restriction and interpolation reuses the level's communication pattern —
the operations whose strategy the paper's models select.  The cycle shape
and smoother are both :class:`SolveOptions` knobs; together they span the
communication scenarios the strategy selection is benchmarked on:

======== =================================================================
knob     choices
======== =================================================================
cycle    ``"V"`` one coarse visit per level;
         ``"W"`` two recursive visits (coarse levels visited 2^ℓ times —
         where NAP-2/NAP-3 aggregate the many small inter-node messages);
         ``"F"`` an F-recursion followed by a V-recursion (ℓ+1 visits of
         level ℓ).
smoother ``"jacobi"`` weighted point Jacobi (1 SpMV/sweep);
         ``"chebyshev"`` degree-d polynomial (d SpMVs/sweep);
         ``"block_jacobi"`` per-block diagonal inverses of size
         ``block_size`` (1 SpMV/sweep, denser local update);
         ``"hybrid_gs"`` hybrid Gauss-Seidel — exact forward GS within a
         row part, Jacobi across parts with lagged (halo'd) off-part
         values (1 SpMV/sweep);
         ``"hybrid_gs_sym"`` the symmetric sweep (forward + backward,
         2 SpMVs/sweep) — a symmetric smoother, so the cycle is an SPD
         preconditioner for PCG with every backend.
======== =================================================================

The block smoothers' iterations depend on the row partition: the dist
backend always uses its device partition, and the host reference mimics a
``smoother_parts``-way balanced partition (set it to the device count for
bit-identical host↔dist smoothing; the default 1 gives the classical
serial smoother).

This module owns the **host** (numpy) implementations plus the result
containers.  The public free functions ``vcycle`` / ``solve`` / ``pcg`` are
thin wrappers over the session API of :mod:`repro.amg.api`: they bind the
hierarchy to the requested backend through the backend registry and delegate,
so they share the same caching and multi-RHS semantics as
``AMGSolver(config).setup(A)``:

* ``backend="host"`` — the reference numpy implementation below.
* ``backend="dist"`` — the device-resident path
  (:mod:`repro.amg.dist_solve`): the whole V-cycle runs as one jitted
  shard_map program over a (pods × lanes) mesh, every matvec using the
  level's model-selected node-aware strategy.  Pass ``dist=`` either a
  prebuilt :class:`~repro.amg.dist_solve.DistHierarchy` (reused across
  calls) or a dict of ``DistHierarchy.build`` kwargs
  (e.g. ``dict(n_pods=2, lanes=4)``) — dict kwargs hit a per-hierarchy
  cache, so repeated calls reuse one ``DistHierarchy`` instead of
  rebuilding it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import CSR
from .hierarchy import Hierarchy, Level
from .smoothers import (balanced_offsets, block_diag_inv, block_jacobi,
                        chebyshev, hybrid_gs, hybrid_gs_sym, jacobi)

CYCLES = ("V", "W", "F")
SMOOTHERS = ("jacobi", "chebyshev", "block_jacobi", "hybrid_gs",
             "hybrid_gs_sym")
# recursive coarse visits per cycle shape: each child runs at level+1,
# warm-started from the previous child's result
CYCLE_CHILDREN = {"V": ("V",), "W": ("W", "W"), "F": ("F", "V")}


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Cycle-shape + smoother options.  Frozen (hashable) so it can key
    program caches and live inside a hashable
    :class:`~repro.amg.api.AMGConfig` — two configs differing only in these
    knobs share one hierarchy and one dist lowering, and differ only in
    which compiled cycle program runs (see the module docstring's table)."""

    smoother: str = "jacobi"       # see SMOOTHERS
    presweeps: int = 1
    postsweeps: int = 1
    omega: float = 2.0 / 3.0
    cheby_degree: int = 2
    cycle: str = "V"               # see CYCLES
    block_size: int = 4            # block_jacobi: diagonal block size
    smoother_parts: int = 1        # host row parts for the block smoothers

    def __post_init__(self):
        if self.cycle not in CYCLES:
            raise ValueError(f"cycle must be one of {CYCLES}, "
                             f"got {self.cycle!r}")
        if self.smoother not in SMOOTHERS:
            raise ValueError(f"smoother must be one of {SMOOTHERS}, "
                             f"got {self.smoother!r}")
        if self.block_size < 1 or self.smoother_parts < 1:
            raise ValueError("block_size and smoother_parts must be >= 1")

    def spmvs_per_sweep(self) -> int:
        """SpMVs one relaxation sweep costs (the comm-count multiplier)."""
        if self.smoother == "chebyshev":
            return self.cheby_degree
        return 2 if self.smoother == "hybrid_gs_sym" else 1


def _relax(A: CSR, x, b, opts: SolveOptions, sweeps: int,
           level: Level | None = None):
    """One relaxation call; ``level`` carries the per-level smoother cache
    (block-diagonal inverses extracted once and reused every sweep)."""
    if sweeps == 0:
        return x
    if opts.smoother == "jacobi":
        return jacobi(A, x, b, omega=opts.omega, iterations=sweeps)
    if opts.smoother == "block_jacobi":
        key = ("bdinv", opts.block_size, opts.smoother_parts)
        binv = level.smoother_cache.get(key) if level is not None else None
        if binv is None:
            binv = block_diag_inv(A, opts.block_size, opts.smoother_parts)
            if level is not None:
                level.smoother_cache[key] = binv
        return block_jacobi(A, x, b, opts.block_size, omega=opts.omega,
                            iterations=sweeps, binv=binv)
    if opts.smoother in ("hybrid_gs", "hybrid_gs_sym"):
        bounds = balanced_offsets(A.nrows, opts.smoother_parts)
        fn = hybrid_gs if opts.smoother == "hybrid_gs" else hybrid_gs_sym
        return fn(A, x, b, boundaries=bounds, iterations=sweeps)
    return chebyshev(A, x, b, degree=opts.cheby_degree * sweeps)


@dataclasses.dataclass
class SolveResult:
    x: np.ndarray
    residuals: list[float]
    iterations: int
    converged: bool

    @property
    def avg_conv_factor(self) -> float:
        r = self.residuals
        if len(r) < 2 or r[0] == 0:
            return 1.0
        return (r[-1] / r[0]) ** (1.0 / (len(r) - 1))


@dataclasses.dataclass
class MultiSolveResult:
    """Result of a multi-RHS solve: ``x`` is ``[n, k]``, one
    :class:`SolveResult` per right-hand-side column."""

    x: np.ndarray
    columns: list[SolveResult]

    @property
    def n_rhs(self) -> int:
        return len(self.columns)

    @property
    def iterations(self) -> int:
        return max((c.iterations for c in self.columns), default=0)

    @property
    def converged(self) -> bool:
        return all(c.converged for c in self.columns)


# --------------------------------------------------------------------------
# Host (numpy) backend implementations
# --------------------------------------------------------------------------


def host_cycle(h: Hierarchy, b: np.ndarray, x: np.ndarray | None = None,
               opts: SolveOptions | None = None, level: int = 0,
               shape: str | None = None) -> np.ndarray:
    """One multigrid cycle (Algorithm 2) on the host.

    ``shape`` defaults to ``opts.cycle``; W/F shapes revisit the coarse
    grids per :data:`CYCLE_CHILDREN`, each child warm-started from the
    previous child's coarse solution.
    """
    opts = opts or SolveOptions()
    shape = shape or opts.cycle
    lv = h.levels[level]
    if x is None:
        x = np.zeros_like(b)
    if level == h.n_levels - 1:                       # coarsest: direct solve
        return np.linalg.lstsq(lv.A.to_dense(), b, rcond=None)[0]
    x = _relax(lv.A, x, b, opts, opts.presweeps, lv)  # pre-relaxation
    r = b - lv.A.matvec(x)                            # residual
    rc = lv.R.matvec(r)                               # restrict
    ec = None
    for child in CYCLE_CHILDREN[shape]:               # coarse-grid solve(s)
        ec = host_cycle(h, rc, ec, opts, level + 1, shape=child)
    x = x + lv.P.matvec(ec)                           # interpolate + correct
    x = _relax(lv.A, x, b, opts, opts.postsweeps, lv)  # post-relaxation
    return x


# backward-compat name (one cycle of whatever shape ``opts`` selects)
host_vcycle = host_cycle


def level_visits(n_levels: int, cycle: str) -> list[int]:
    """How many times each level is visited by ONE cycle of the given shape
    (V: once; W: 2^ℓ; F: ℓ+1) — the multiplier on each level's per-visit
    communication, which is what makes W/F-cycles coarse-level heavy."""
    visits = [0] * n_levels

    def rec(lvl: int, shape: str) -> None:
        visits[lvl] += 1
        if lvl == n_levels - 1:
            return
        for child in CYCLE_CHILDREN[shape]:
            rec(lvl + 1, child)

    rec(0, cycle)
    return visits


def host_solve(h: Hierarchy, b: np.ndarray, tol: float = 1e-8,
               maxiter: int = 100, opts: SolveOptions | None = None,
               x0: np.ndarray | None = None) -> SolveResult:
    """Stationary AMG iteration: x <- x + V(A, b - Ax)."""
    A = h.levels[0].A
    x = np.zeros_like(b) if x0 is None else x0.copy()
    nb = float(np.linalg.norm(b)) or 1.0
    res = [float(np.linalg.norm(b - A.matvec(x)))]
    for it in range(maxiter):
        if res[-1] / nb < tol:
            return SolveResult(x, res, it, True)
        x = host_cycle(h, b, x, opts)
        res.append(float(np.linalg.norm(b - A.matvec(x))))
    return SolveResult(x, res, maxiter, res[-1] / nb < tol)


def host_pcg(h: Hierarchy, b: np.ndarray, tol: float = 1e-8,
             maxiter: int = 200, opts: SolveOptions | None = None,
             x0: np.ndarray | None = None) -> SolveResult:
    """AMG-preconditioned conjugate gradients (optionally warm-started).

    The precondition/update body lives once inside the loop (it used to be
    duplicated ahead of it), so cycle-shape changes land in one place.
    """
    A = h.levels[0].A
    x = np.zeros_like(b) if x0 is None else x0.copy()
    r = b - A.matvec(x) if x0 is not None else b.copy()
    nb = float(np.linalg.norm(b)) or 1.0
    res = [float(np.linalg.norm(r))]
    p = None
    rz = 1.0
    for it in range(maxiter):
        if res[-1] / nb < tol:
            return SolveResult(x, res, it, True)
        z = host_cycle(h, r, None, opts)         # precondition (one cycle)
        rz_new = float(r @ z)
        p = z if p is None else z + (rz_new / rz) * p
        rz = rz_new
        Ap = A.matvec(p)
        alpha = rz / float(p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        res.append(float(np.linalg.norm(r)))
    return SolveResult(x, res, maxiter, res[-1] / nb < tol)


# --------------------------------------------------------------------------
# Public free functions: thin wrappers over the session API backend registry
# --------------------------------------------------------------------------


def _bound(h: Hierarchy, backend: str, dist, opts):
    from .api import bind_hierarchy
    return bind_hierarchy(h, backend=backend, dist=dist, opts=opts)


def _request(method: str, tol, maxiter, x0):
    # all three call surfaces (these wrappers, AMGService.submit, wire
    # requests) funnel per-request knobs through one RequestOptions
    from .api.config import RequestOptions
    return RequestOptions(method=method, tol=tol, maxiter=maxiter, x0=x0)


def vcycle(h: Hierarchy, b: np.ndarray, x: np.ndarray | None = None,
           opts: SolveOptions | None = None, level: int = 0,
           backend: str = "host", dist=None) -> np.ndarray:
    """One cycle (Algorithm 2) of the shape ``opts.cycle`` selects."""
    if backend == "host":
        return host_cycle(h, b, x, opts, level)
    if level != 0:
        raise ValueError(f"backend={backend!r} vcycle starts at level 0")
    return _bound(h, backend, dist, opts).vcycle(b, x0=x)


def solve(h: Hierarchy, b: np.ndarray, tol: float = 1e-8, maxiter: int = 100,
          opts: SolveOptions | None = None, x0: np.ndarray | None = None,
          backend: str = "host", dist=None):
    """Stationary AMG iteration: x <- x + cycle(A, b - Ax).

    ``b`` may be ``[n]`` (→ :class:`SolveResult`) or ``[n, k]``
    (→ :class:`MultiSolveResult`, the k systems solved together).
    """
    return _bound(h, backend, dist, opts).run(
        b, _request("solve", tol, maxiter, x0))


def pcg(h: Hierarchy, b: np.ndarray, tol: float = 1e-8, maxiter: int = 200,
        opts: SolveOptions | None = None, x0: np.ndarray | None = None,
        backend: str = "host", dist=None):
    """AMG-preconditioned conjugate gradients (``x0=`` warm start supported
    on every backend; ``b`` may be ``[n]`` or ``[n, k]``)."""
    return _bound(h, backend, dist, opts).run(
        b, _request("pcg", tol, maxiter, x0))
