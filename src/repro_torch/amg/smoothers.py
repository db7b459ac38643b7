# Verbatim copy of repro/amg/smoothers.py (numpy only); only the imports may differ.
"""Relaxation methods for the solve phase (Algorithm 2, ``relax``).

Pointwise smoothers — weighted/l1-Jacobi and Chebyshev — plus the two
*block* smoothers the paper's communication argument extends to:

* :func:`block_jacobi` — per-block diagonal inverses (dense ``bs×bs``
  blocks), same SpMV-shaped communication as Jacobi but a denser local
  update; the block inverses are extracted once at setup and carried on the
  level (:attr:`repro.amg.hierarchy.Level.smoother_cache`).
* :func:`hybrid_gs` — hybrid Gauss-Seidel: exact forward Gauss-Seidel
  *within* each contiguous row part, Jacobi *across* parts, off-part values
  read from the pre-sweep iterate (on the distributed backend those are
  exactly the halo'd off-process values).  This is the processor-block
  Gauss-Seidel of parallel AMG codes: its iteration depends on the row
  partition, so the host reference takes the part boundaries explicitly.
* :func:`hybrid_gs_sym` — the symmetric sweep (forward + backward, each
  against a freshly lagged residual): 2 SpMVs/sweep, but the resulting
  cycle is a symmetric operator, i.e. an SPD preconditioner for PCG.

Every sweep of every smoother is SpMV-based, so the communication pattern
is identical to A·x and every sweep uses the level's selected node-aware
strategy.
"""
from __future__ import annotations

import numpy as np

from .csr import CSR
from .interpolation import estimate_rho_DinvA


def balanced_offsets(n: int, parts: int) -> np.ndarray:
    """Boundaries of a balanced contiguous split of ``n`` rows into
    ``parts`` pieces — the same first-parts-get-the-extra rule as
    :meth:`repro.core.topology.Partition.balanced`, so a host smoother run
    with ``parts == n_devices`` reproduces the device partition exactly."""
    base, extra = divmod(n, parts)
    counts = np.full(parts, base, dtype=np.int64)
    counts[:extra] += 1
    offsets = np.zeros(parts + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets


def block_partition(n: int, bs: int, parts: int = 1) -> list[tuple[int, int]]:
    """Block-Jacobi block ranges: a ``bs``-grid laid down *within* each of
    ``parts`` balanced row parts (blocks never straddle a part boundary —
    the distributed backend cannot invert across devices, and the host
    reference mirrors that rule so the two iterate identically)."""
    bounds = balanced_offsets(n, parts)
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for s in range(int(lo), int(hi), bs):
            out.append((s, min(s + bs, int(hi))))
    return out


def block_diag_inv(A: CSR, bs: int, parts: int = 1) -> list[tuple[int, np.ndarray]]:
    """Dense inverses of A's block diagonal: ``[(start, inv)]`` per block.

    Entries of A outside a block's row/column range are ignored (they belong
    to the Jacobi coupling handled by the residual); zero diagonals are
    replaced by 1 so padded/empty rows update by exactly zero.
    """
    out = []
    for s, e in block_partition(A.nrows, bs, parts):
        sub = A.submatrix_rows(s, e)
        r, c = sub.rows_expanded(), sub.indices
        keep = (c >= s) & (c < e)
        B = np.zeros((e - s, e - s))
        B[r[keep], c[keep] - s] = sub.data[keep]
        d = np.diagonal(B).copy()
        np.fill_diagonal(B, np.where(d == 0, 1.0, d))
        out.append((s, np.linalg.inv(B)))
    return out


def block_jacobi(A: CSR, x: np.ndarray, b: np.ndarray, block_size: int = 4,
                 omega: float = 2.0 / 3.0, iterations: int = 1,
                 parts: int = 1, binv=None) -> np.ndarray:
    """Weighted block-Jacobi: x += ω · blockdiag(A)⁻¹ (b − A x).

    ``binv`` may carry pre-extracted inverses from :func:`block_diag_inv`
    (the setup-time form carried on the level); it must have been built with
    the same ``block_size``/``parts``.
    """
    if binv is None:
        binv = block_diag_inv(A, block_size, parts)
    for _ in range(iterations):
        r = b - A.matvec(x)
        z = np.zeros_like(x)
        for s, inv in binv:
            z[s: s + inv.shape[0]] = inv @ r[s: s + inv.shape[0]]
        x = x + omega * z
    return x


def _resolve_bounds(n: int, boundaries) -> np.ndarray:
    return (np.array([0, n], dtype=np.int64) if boundaries is None
            else np.asarray(boundaries, dtype=np.int64))


def _hybrid_sweep(A: CSR, x: np.ndarray, b: np.ndarray, bounds: np.ndarray,
                  forward: bool) -> np.ndarray:
    """One directional hybrid sweep: solve ``(D + T_part) z = b − A x`` per
    contiguous row part (T = strictly-lower triangle for a forward sweep,
    strictly-upper for a backward one; couplings to rows outside the part
    enter through the lagged residual) and return ``x + z``."""
    r = b - A.matvec(x)
    z = np.zeros_like(x)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        lo, hi = int(lo), int(hi)
        order = range(lo, hi) if forward else range(hi - 1, lo - 1, -1)
        for i in order:
            s, e = int(A.indptr[i]), int(A.indptr[i + 1])
            cols, vals = A.indices[s:e], A.data[s:e]
            if forward:
                in_part = (cols >= lo) & (cols < i)
            else:
                in_part = (cols > i) & (cols < hi)
            acc = r[i] - vals[in_part] @ z[cols[in_part]]
            diag = float(vals[cols == i].sum()) or 1.0
            z[i] = acc / diag
    return x + z


def hybrid_gs(A: CSR, x: np.ndarray, b: np.ndarray,
              boundaries: np.ndarray | None = None,
              iterations: int = 1) -> np.ndarray:
    """Hybrid (processor-block) forward Gauss-Seidel.

    One sweep solves ``(D + L_part) z = b − A x`` per contiguous row part
    (forward substitution within the part; couplings to rows outside the
    part — other parts *and* off-process halo values on the distributed
    backend — enter through the lagged residual) and updates ``x += z``.
    With ``boundaries=[0, n]`` (the default) this is exact sequential
    forward Gauss-Seidel; with the device partition's boundaries it is
    bit-for-bit the distributed backend's smoother.
    """
    bounds = _resolve_bounds(A.nrows, boundaries)
    for _ in range(iterations):
        x = _hybrid_sweep(A, x, b, bounds, forward=True)
    return x


def hybrid_gs_sym(A: CSR, x: np.ndarray, b: np.ndarray,
                  boundaries: np.ndarray | None = None,
                  iterations: int = 1) -> np.ndarray:
    """Symmetric-sweep hybrid Gauss-Seidel: one forward hybrid sweep
    followed by one backward hybrid sweep (each with a freshly lagged
    residual, so the backward half costs a second SpMV).

    The symmetric sweep makes the smoother — and hence the whole
    V-cycle — a *symmetric* operator for symmetric A, which is what PCG
    needs from its preconditioner; plain ``hybrid_gs`` is not.  With
    ``boundaries=[0, n]`` this is textbook symmetric Gauss-Seidel; with
    the device partition's boundaries it is bit-for-bit the distributed
    backend's smoother (off-part values halo'd, i.e. lagged).
    """
    bounds = _resolve_bounds(A.nrows, boundaries)
    for _ in range(iterations):
        x = _hybrid_sweep(A, x, b, bounds, forward=True)
        x = _hybrid_sweep(A, x, b, bounds, forward=False)
    return x


def jacobi(A: CSR, x: np.ndarray, b: np.ndarray, omega: float = 2.0 / 3.0,
           iterations: int = 1, dinv: np.ndarray | None = None) -> np.ndarray:
    if dinv is None:
        d = A.diagonal()
        dinv = 1.0 / np.where(d == 0, 1.0, d)
    for _ in range(iterations):
        x = x + omega * dinv * (b - A.matvec(x))
    return x


def l1_jacobi(A: CSR, x: np.ndarray, b: np.ndarray, iterations: int = 1) -> np.ndarray:
    """l1-Jacobi: unconditionally convergent for SPD A."""
    l1 = np.zeros(A.nrows)
    np.add.at(l1, A.rows_expanded(), np.abs(A.data))
    dinv = 1.0 / np.where(l1 == 0, 1.0, l1)
    for _ in range(iterations):
        x = x + dinv * (b - A.matvec(x))
    return x


def chebyshev_coeffs(rho: float) -> tuple[float, float, float]:
    """(theta, delta, sigma) for D⁻¹A bounds [ρ/30, 1.1ρ] (hypre-style)."""
    lmax, lmin = 1.1 * rho, rho / 30.0
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    return theta, delta, theta / delta


def chebyshev_recurrence(matvec, dinv, x, b, degree: int,
                         theta: float, delta: float, sigma: float):
    """The Chebyshev smoothing recurrence, matvec-agnostic.

    Shared by the host backend (numpy ``A.matvec``) and the device backend
    (distributed SpMV inside shard_map, :mod:`repro.amg.dist_solve`) so the
    two can never drift apart; works on any array type supporting ``+``/``*``.
    """
    r = dinv * (b - matvec(x))
    d = r / theta
    x = x + d
    rho_prev = 1.0 / sigma
    for _ in range(degree - 1):
        rho_k = 1.0 / (2.0 * sigma - rho_prev)
        r = r - dinv * matvec(d)
        d = (rho_k * rho_prev) * d + (2.0 * rho_k / delta) * r
        x = x + d
        rho_prev = rho_k
    return x


def chebyshev(A: CSR, x: np.ndarray, b: np.ndarray, degree: int = 3,
              rho: float | None = None, dinv: np.ndarray | None = None) -> np.ndarray:
    """Chebyshev smoothing on D⁻¹A over [ρ/30, 1.1ρ] (hypre-style)."""
    if dinv is None:
        d = A.diagonal()
        dinv = 1.0 / np.where(d == 0, 1.0, d)
    rho = rho or estimate_rho_DinvA(A)
    theta, delta, sigma = chebyshev_coeffs(rho)
    return chebyshev_recurrence(A.matvec, dinv, x, b, degree,
                                theta, delta, sigma)
