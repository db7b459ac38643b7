# Verbatim copy of repro/amg/interpolation.py (numpy only); only the imports may differ.
"""Interpolation operators (Algorithm 1, ``interpolation``).

* :func:`direct_interpolation` — classical direct interpolation for CF
  splittings (used with PMIS/HMIS-style coarsening).
* :func:`tentative_prolongator` + :func:`jacobi_smooth_prolongator` — the
  smoothed-aggregation transfer: piecewise-constant tentative operator fit
  to the near-nullspace, then 1..k sweeps of weighted-Jacobi smoothing
  (Fig. 21 studies 1 vs 2 sweeps).
"""
from __future__ import annotations

import numpy as np

from .csr import CSR


def direct_interpolation(A: CSR, S: CSR, status: np.ndarray, *,
                         col_status: np.ndarray | None = None,
                         cmap: np.ndarray | None = None,
                         nc: int | None = None) -> CSR:
    """Classical direct interpolation.

    C-point rows are identity; F-point i interpolates from its strong
    C-neighbors j with  w_ij = -(Σ_{k≠i} a_ik / Σ_{j∈C_i^s} a_ij)·a_ij/a_ii.

    The keyword arguments support partitioned (row-block) callers, where row
    knowledge and column knowledge come from different exchanges: ``status``
    is trusted for the block's *rows* (C rows become identity rows), while
    ``col_status`` / ``cmap`` must be valid at every *column* referenced by
    ``S`` (local + halo) and ``nc`` is the global coarse size.  Defaults
    reproduce the serial single-block behavior exactly.
    """
    n = A.nrows
    is_c = status == 1
    col_c = is_c if col_status is None else col_status == 1
    if cmap is None:
        cmap = np.cumsum(col_c) - 1  # fine -> coarse index
    if nc is None:
        nc = int(col_c.sum())
    r = A.rows_expanded()

    # strong C columns per row (pattern from S, values from A)
    srow = S.rows_expanded()
    strongC = col_c[S.indices]
    # A values at the strong-C positions: build lookup from (row,col) of A
    # via merge: both are row-sorted
    Akey = r * n + A.indices
    Skey = srow[strongC] * n + S.indices[strongC]
    pos = np.searchsorted(Akey, Skey)
    pos = np.clip(pos, 0, Akey.size - 1)
    valid = Akey[pos] == Skey
    a_sc = np.where(valid, A.data[pos], 0.0)

    diag = A.diagonal()
    offsum = np.zeros(n)
    np.add.at(offsum, r, np.where(r != A.indices, A.data, 0.0))
    csum = np.zeros(n)
    np.add.at(csum, srow[strongC], a_sc)

    rows_f = srow[strongC]
    f_ok = (status[rows_f] == -1) & (np.abs(csum[rows_f]) > 1e-300)
    alpha = np.where(np.abs(csum[rows_f]) > 1e-300,
                     offsum[rows_f] / np.where(csum[rows_f] == 0, 1, csum[rows_f]), 0.0)
    w = -alpha * a_sc / diag[rows_f]
    prow = rows_f[f_ok]
    pcol = cmap[S.indices[strongC][f_ok]]
    pval = w[f_ok]
    # C-point identity rows
    crow = np.flatnonzero(is_c)
    return CSR.from_coo(
        np.concatenate([prow, crow]),
        np.concatenate([pcol, cmap[crow]]),
        np.concatenate([pval, np.ones(crow.size)]),
        (n, nc),
    )


def tentative_prolongator(agg: np.ndarray, B: np.ndarray | None = None) -> CSR:
    """Piecewise-constant tentative P (near-nullspace B=1 column-normalized)."""
    n = agg.size
    nc = int(agg.max()) + 1
    vals = np.ones(n) if B is None else np.asarray(B, dtype=np.float64)
    norms = np.sqrt(np.bincount(agg, weights=vals * vals, minlength=nc))
    norms[norms == 0] = 1.0
    return CSR.from_coo(np.arange(n), agg, vals / norms[agg], (n, nc))


def estimate_rho_DinvA(A: CSR, iters: int = 10, seed: int = 0) -> float:
    """Power iteration estimate of ρ(D⁻¹A)."""
    rng = np.random.default_rng(seed)
    dinv = 1.0 / np.where(A.diagonal() == 0, 1.0, A.diagonal())
    x = rng.standard_normal(A.nrows)
    lam = 1.0
    for _ in range(iters):
        y = dinv * A.matvec(x)
        lam = float(np.linalg.norm(y))
        if lam == 0:
            return 1.0
        x = y / lam
    return lam


def jacobi_smooth_prolongator(A: CSR, T: CSR, omega: float = 4.0 / 3.0,
                              sweeps: int = 1, rho: float | None = None) -> CSR:
    """P = (I - ω/ρ(D⁻¹A) · D⁻¹A)^sweeps · T."""
    rho = rho or estimate_rho_DinvA(A)
    dinv = 1.0 / np.where(A.diagonal() == 0, 1.0, A.diagonal())
    DA = A.scale_rows(dinv * (omega / rho))
    P = T
    for _ in range(sweeps):
        P = P.add(DA.spgemm(P), alpha=1.0, beta=-1.0)
    return P
