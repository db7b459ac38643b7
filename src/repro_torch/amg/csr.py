# Verbatim copy of repro/amg/csr.py (numpy only); only the imports may differ.
"""Minimal-but-fast CSR sparse matrix in pure numpy (no scipy in container).

Implements exactly what AMG needs: SpMV, SpGEMM (vectorized Gustavson via
expand/coalesce), transpose, diagonal extraction, pruning, and converters.
All index arrays are int64; values float64.

Also holds the :class:`BCSR` block layout (dense ``bs×bs`` blocks in a
block-ELL arrangement) and :func:`csr_to_bcsr` — the host-side lowering the
MXU-blocked Pallas kernel (:mod:`repro.kernels.spmv.bcsr`) consumes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSR:
    shape: tuple[int, int]
    indptr: np.ndarray   # (nrows+1,) int64
    indices: np.ndarray  # (nnz,)    int64, column ids (sorted per row)
    data: np.ndarray     # (nnz,)    float64

    # ------------------------------------------------------------ constructors
    @staticmethod
    def from_coo(rows, cols, vals, shape) -> "CSR":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        nrows, ncols = shape
        if rows.size:
            key = rows * ncols + cols
            order = np.argsort(key, kind="stable")
            key, vals = key[order], vals[order]
            uniq, inv = np.unique(key, return_inverse=True)
            summed = np.bincount(inv, weights=vals, minlength=uniq.size)
            rows_u = (uniq // ncols).astype(np.int64)
            cols_u = (uniq % ncols).astype(np.int64)
        else:
            rows_u = cols_u = np.zeros(0, dtype=np.int64)
            summed = np.zeros(0, dtype=np.float64)
        indptr = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows_u, minlength=nrows), out=indptr[1:])
        return CSR(shape=(nrows, ncols), indptr=indptr, indices=cols_u, data=summed)

    @staticmethod
    def from_dense(M) -> "CSR":
        M = np.asarray(M, dtype=np.float64)
        rows, cols = np.nonzero(M)
        return CSR.from_coo(rows, cols, M[rows, cols], M.shape)

    @staticmethod
    def eye(n, value: float = 1.0) -> "CSR":
        return CSR(shape=(n, n),
                   indptr=np.arange(n + 1, dtype=np.int64),
                   indices=np.arange(n, dtype=np.int64),
                   data=np.full(n, value, dtype=np.float64))

    @staticmethod
    def from_diag(d) -> "CSR":
        d = np.asarray(d, dtype=np.float64)
        return CSR(shape=(d.size, d.size),
                   indptr=np.arange(d.size + 1, dtype=np.int64),
                   indices=np.arange(d.size, dtype=np.int64),
                   data=d.copy())

    # ---------------------------------------------------------------- basics
    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def rows_expanded(self) -> np.ndarray:
        """Row id of every stored nonzero, shape (nnz,)."""
        return np.repeat(np.arange(self.nrows, dtype=np.int64), self.row_lengths())

    def to_dense(self) -> np.ndarray:
        M = np.zeros(self.shape)
        M[self.rows_expanded(), self.indices] = self.data
        return M

    def copy(self) -> "CSR":
        return CSR(self.shape, self.indptr.copy(), self.indices.copy(), self.data.copy())

    def diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape))
        r = self.rows_expanded()
        mask = (r == self.indices) & (r < d.size)
        d[r[mask]] = self.data[mask]
        return d

    # ------------------------------------------------------------------- ops
    def matvec(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        prod = self.data * x[self.indices]
        out = np.zeros(self.nrows, dtype=np.result_type(self.data, x))
        np.add.at(out, self.rows_expanded(), prod)
        return out

    def __matmul__(self, other):
        if isinstance(other, CSR):
            return self.spgemm(other)
        return self.matvec(other)

    def transpose(self) -> "CSR":
        order = np.argsort(self.indices, kind="stable")
        rows_t = self.indices[order]
        cols_t = self.rows_expanded()[order]
        indptr = np.zeros(self.ncols + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows_t, minlength=self.ncols), out=indptr[1:])
        return CSR(shape=(self.ncols, self.nrows), indptr=indptr,
                   indices=cols_t, data=self.data[order])

    @property
    def T(self) -> "CSR":
        return self.transpose()

    def spgemm(self, B: "CSR") -> "CSR":
        """C = self @ B — vectorized expand + coalesce (Gustavson order)."""
        A = self
        if A.ncols != B.nrows:
            raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
        lens = B.indptr[A.indices + 1] - B.indptr[A.indices]     # per A-nnz
        total = int(lens.sum())
        if total == 0:
            return CSR.from_coo([], [], [], (A.nrows, B.ncols))
        starts = B.indptr[A.indices]
        # positions into B's arrays for every expanded term
        cum = np.cumsum(lens) - lens
        offs = np.arange(total, dtype=np.int64) - np.repeat(cum, lens)
        pos = np.repeat(starts, lens) + offs
        out_rows = np.repeat(A.rows_expanded(), lens)
        out_cols = B.indices[pos]
        out_vals = np.repeat(A.data, lens) * B.data[pos]
        return CSR.from_coo(out_rows, out_cols, out_vals, (A.nrows, B.ncols))

    def scale_rows(self, d: np.ndarray) -> "CSR":
        out = self.copy()
        out.data = out.data * np.asarray(d)[out.rows_expanded()]
        return out

    def scale_cols(self, d: np.ndarray) -> "CSR":
        out = self.copy()
        out.data = out.data * np.asarray(d)[out.indices]
        return out

    def add(self, B: "CSR", alpha: float = 1.0, beta: float = 1.0) -> "CSR":
        if self.shape != B.shape:
            raise ValueError("shape mismatch in add")
        rows = np.concatenate([self.rows_expanded(), B.rows_expanded()])
        cols = np.concatenate([self.indices, B.indices])
        vals = np.concatenate([alpha * self.data, beta * B.data])
        return CSR.from_coo(rows, cols, vals, self.shape)

    def prune(self, tol: float = 0.0) -> "CSR":
        """Drop entries with |value| <= tol (keeps explicit diagonal)."""
        r = self.rows_expanded()
        keep = (np.abs(self.data) > tol) | (r == self.indices)
        indptr = np.zeros(self.nrows + 1, dtype=np.int64)
        np.cumsum(np.bincount(r[keep], minlength=self.nrows), out=indptr[1:])
        return CSR(self.shape, indptr, self.indices[keep], self.data[keep])

    def offproc_columns(self, lo: int, hi: int, row_lo: int, row_hi: int) -> np.ndarray:
        """Unique column ids outside [lo,hi) among rows [row_lo,row_hi)."""
        sl = slice(self.indptr[row_lo], self.indptr[row_hi])
        cols = self.indices[sl]
        return np.unique(cols[(cols < lo) | (cols >= hi)])

    def submatrix_rows(self, row_lo: int, row_hi: int) -> "CSR":
        sl = slice(int(self.indptr[row_lo]), int(self.indptr[row_hi]))
        indptr = (self.indptr[row_lo:row_hi + 1] - self.indptr[row_lo]).astype(np.int64)
        return CSR((row_hi - row_lo, self.ncols), indptr,
                   self.indices[sl].copy(), self.data[sl].copy())


# --------------------------------------------------------------------------
# BCSR: dense bs×bs blocks in a block-ELL layout (the MXU kernel's form)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BCSR:
    """Block-ELL BCSR: every stored block is a dense ``bs×bs`` tile.

    ``bcols[r, j]`` is the block-column id of block row ``r``'s j-th stored
    block (-1 padding past the row's block count); ``bvals[r, j]`` the dense
    tile (explicit zero fill inside).  Rows/columns are zero-padded up to a
    multiple of ``block_size``; ``shape`` keeps the logical (unpadded)
    extent so round-trips slice the padding back off.
    """

    shape: tuple[int, int]     # logical (unpadded) shape
    block_size: int
    bcols: np.ndarray          # [mb, Kb] int32, -1 pad
    bvals: np.ndarray          # [mb, Kb, bs, bs] float64

    @property
    def n_blocks(self) -> int:
        return int((self.bcols >= 0).sum())

    @property
    def fill(self) -> float:
        """Fraction of stored block entries that are true nonzeros."""
        stored = self.n_blocks * self.block_size ** 2
        return float(np.count_nonzero(self.bvals)) / stored if stored else 0.0

    def to_dense(self) -> np.ndarray:
        bs = self.block_size
        mb, Kb = self.bcols.shape
        nbc = -(-self.shape[1] // bs)
        out = np.zeros((mb * bs, nbc * bs))
        for r in range(mb):
            for j in range(Kb):
                bc = int(self.bcols[r, j])
                if bc < 0:
                    continue
                out[r * bs:(r + 1) * bs, bc * bs:(bc + 1) * bs] = \
                    self.bvals[r, j]
        return out[: self.shape[0], : self.shape[1]]


def csr_to_bcsr(A: CSR, block_size: int) -> BCSR:
    """Lower a CSR matrix to block-ELL BCSR with dense ``bs×bs`` blocks.

    Rows and columns are implicitly padded (with zeros) to multiples of
    ``block_size``; blocks never straddle the padding boundary.  Vectorized:
    one ``np.unique`` over block coordinates, then a scatter of the values
    into their tiles.
    """
    bs = int(block_size)
    if bs <= 0:
        raise ValueError(f"block_size must be positive, got {bs}")
    mb = -(-A.nrows // bs)
    nbc = -(-A.ncols // bs)
    r, c, v = A.rows_expanded(), A.indices, A.data
    if r.size == 0:
        return BCSR(shape=A.shape, block_size=bs,
                    bcols=np.full((mb, 0), -1, dtype=np.int32),
                    bvals=np.zeros((mb, 0, bs, bs)))
    br, bc = r // bs, c // bs
    key = br * nbc + bc
    ukeys, inv = np.unique(key, return_inverse=True)
    ubr = (ukeys // nbc).astype(np.int64)
    ubc = (ukeys % nbc).astype(np.int64)
    # slot of each stored block within its block row (ukeys are sorted, so
    # blocks of one row are contiguous and column-ordered)
    row_starts = np.searchsorted(ubr, np.arange(mb))
    slot = np.arange(ukeys.size, dtype=np.int64) - row_starts[ubr]
    Kb = int(np.bincount(ubr, minlength=mb).max(initial=0))
    bcols = np.full((mb, Kb), -1, dtype=np.int32)
    bcols[ubr, slot] = ubc.astype(np.int32)
    bvals = np.zeros((mb, Kb, bs, bs))
    bvals[ubr[inv], slot[inv], r % bs, c % bs] = v
    return BCSR(shape=A.shape, block_size=bs, bcols=bcols, bvals=bvals)
