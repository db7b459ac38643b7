# Verbatim copy of repro/amg/strength.py (numpy only); only the imports may differ.
"""Strength-of-connection (Algorithm 1, ``strength``).

Classical (Ruge-Stüben) and symmetric (smoothed-aggregation) measures, both
with the paper's strength tolerance default of 0.25.
"""
from __future__ import annotations

import numpy as np

from .csr import CSR


def classical_strength(A: CSR, theta: float = 0.25) -> CSR:
    """S[i,j] = 1 where -a_ij >= theta * max_k(-a_ik)  (negative coupling);
    falls back to |a_ij| for rows with no negative off-diagonals."""
    r = A.rows_expanded()
    offdiag = r != A.indices
    neg = np.where(offdiag, -A.data, -np.inf)
    # per-row max of negative couplings
    rowmax = np.full(A.nrows, -np.inf)
    np.maximum.at(rowmax, r, neg)
    use_abs = ~np.isfinite(rowmax) | (rowmax <= 0)
    absval = np.where(offdiag, np.abs(A.data), -np.inf)
    rowmax_abs = np.full(A.nrows, -np.inf)
    np.maximum.at(rowmax_abs, r, absval)
    thresh = np.where(use_abs, rowmax_abs, rowmax)[r] * theta
    meas = np.where(use_abs[r], np.abs(A.data), -A.data)
    keep = offdiag & (meas >= thresh) & (meas > 0)
    indptr = np.zeros(A.nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(r[keep], minlength=A.nrows), out=indptr[1:])
    return CSR(A.shape, indptr, A.indices[keep], np.ones(int(keep.sum())))


def symmetric_strength(A: CSR, theta: float = 0.25) -> CSR:
    """SA strength, row-max scaled: |a_ij| >= theta * max_{k≠i} |a_ik|.

    (The textbook √(a_ii·a_jj) scaling empties wide low-magnitude stencils
    such as the 27-point Laplacian at θ=0.25; row-max scaling preserves the
    paper's θ=0.25 semantics across our test problems.)
    """
    r = A.rows_expanded()
    offdiag = r != A.indices
    absval = np.where(offdiag, np.abs(A.data), -np.inf)
    rowmax = np.full(A.nrows, -np.inf)
    np.maximum.at(rowmax, r, absval)
    keep = offdiag & (np.abs(A.data) >= theta * rowmax[r]) & (np.abs(A.data) > 0)
    indptr = np.zeros(A.nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(r[keep], minlength=A.nrows), out=indptr[1:])
    return CSR(A.shape, indptr, A.indices[keep], np.ones(int(keep.sum())))
