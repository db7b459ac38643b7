"""Plain PyTorch versions of the two block-smoother kernels.

Each takes the rank-stacked operands of the distributed solve (a leading
rank dim D) and computes what one launch of the matching CUDA kernel
computes, so the CPU tests and ``chip_smoke.py`` hold the kernels against
them.  They stand for the reference's dense ``minv @ r``
(``repro/amg/dist_solve.py``, ``DistHierarchy._relax``); summation order
may differ from the kernels.

bfloat16 operands follow the sparse kernels' rule (:mod:`..spmv.ref`):
they are widened to float32, products and sums are float32, and the result
``x + w·…`` is rounded to bfloat16 once.  The triangular solve keeps its
solution ``z = T⁻¹ r`` in float32 from one level set to the next, as the
kernel does: a z rounded to bfloat16 at every set would carry a rounding
through each of the DAG's levels.  float32 and float64 compute in their
own type.

The triangular solve runs level by level over the triangle's dependency
DAG: :func:`dag_levels` gives every row its level set on the host,
:func:`level_order` every rank's rows sorted by level set as flat
``d·m + i`` indices, :func:`level_schedule` the rows of each set, and
:func:`tri_solve_ref` solves one set per step, vectorised over ranks.
:func:`rank_level_order` is the kernel's row order (each rank's rows by
level set) and :func:`rank_level_starts` where each rank's sets begin.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spmv.ref import wide


def block_diag_apply_ref(binv: torch.Tensor, r: torch.Tensor,
                         x: torch.Tensor, w: float) -> torch.Tensor:
    """``x + w · Binv r`` with ``Binv`` ``[D, nb, bs, bs]`` the inverses of
    each rank's bs-row diagonal blocks (the grid restarting at the rank's
    first row); ``r``, ``x`` ``[D, m]`` or ``[D, m, k]``."""
    D, nb, bs, _ = binv.shape
    m = r.shape[1]
    rk = wide(r if r.ndim == 3 else r[..., None])
    pad = nb * bs - m
    if pad:
        rk = torch.nn.functional.pad(rk, (0, 0, 0, pad))
    rb = rk.reshape(D, nb, 1, bs, -1)                    # [D, nb, 1, bs, k]
    z = (wide(binv)[..., None] * rb).sum(dim=3)         # [D, nb, bs, k]
    z = z.reshape(D, nb * bs, -1)[:, :m]
    return (wide(x) + w * (z if r.ndim == 3 else z[..., 0])).to(x.dtype)


def block_diag_apply_absum(binv, r, x, w: float) -> torch.Tensor:
    """``|x| + |w| · |Binv| |r|`` in float64: the sum of the magnitudes
    each output entry of :func:`block_diag_apply_ref` adds up, the scale of
    its float32 round-off in bfloat16."""
    return block_diag_apply_ref(binv.double().abs(), r.double().abs(),
                                x.double().abs(), abs(w))


def tri_solve_absum(cols, vals, diag, r, x, w: float,
                    schedule: list[torch.Tensor]) -> torch.Tensor:
    """``|x| + |w| · z̄`` in float64, ``z̄ = |D|⁻¹ (|r| + |L| z̄)`` the
    solve on magnitudes: a bound on every partial sum of ``z`` that
    :func:`tri_solve_ref` forms, the scale of its float32 round-off in
    bfloat16."""
    return tri_solve_ref(cols, -vals.double().abs(), diag.double().abs(),
                         r.double().abs(), x.double().abs(), abs(w), schedule)


def dag_levels(cols: np.ndarray, upper: bool) -> np.ndarray:
    """Level set of every row of each rank's strict triangle ``cols``
    ``[D, m, K]`` (-1 padding): 0 for a row with no dependency, else one
    more than its deepest dependency's.  Rows are visited in dependency
    order (ascending for the lower triangle, descending for the upper),
    all ranks at once."""
    cols = np.asarray(cols)
    D, m, K = cols.shape
    lev = np.zeros((D, m + 1), dtype=np.int64)         # column m: padding
    lev[:, m] = -1
    idx = np.where(cols >= 0, cols, m)
    ranks = np.arange(D)[:, None]
    for i in (range(m - 1, -1, -1) if upper else range(m)):
        if K:
            lev[:, i] = lev[ranks, idx[:, i]].max(axis=1) + 1
    return lev[:, :m]


def level_order(levels: np.ndarray) -> np.ndarray:
    """Every rank's rows (flat ``d·m + i``) sorted by level set, rows of one
    set in flat order: each row comes after every row it depends on."""
    return np.argsort(np.asarray(levels).reshape(-1), kind="stable")


def rank_level_order(levels: np.ndarray) -> np.ndarray:
    """The kernel's row order ``[D, m]`` (int32, rows local to the rank):
    each rank's rows sorted by level set and, within a set, by row, so
    every row comes after each row it depends on (all in lower sets)."""
    lev = np.asarray(levels, dtype=np.int64)
    return np.argsort(lev, axis=1, kind="stable").astype(np.int32)


def rank_level_starts(levels: np.ndarray) -> np.ndarray:
    """Where each level set begins in :func:`rank_level_order`: int32
    ``[D, nlev + 1]``, nlev the most level sets of any rank; rank d's set L
    at positions ``[s[d, L], s[d, L + 1])`` (empty past the rank's last
    set)."""
    lev = np.asarray(levels, dtype=np.int64)
    D, m = lev.shape
    nlev = int(lev.max(initial=-1)) + 1
    counts = np.zeros((D, nlev), dtype=np.int64)
    np.add.at(counts, (np.repeat(np.arange(D), m), lev.reshape(-1)), 1)
    starts = np.zeros((D, nlev + 1), dtype=np.int64)
    starts[:, 1:] = np.cumsum(counts, axis=1)
    return starts.astype(np.int32)


def level_schedule(cols: np.ndarray, upper: bool, device=None,
                   levels: np.ndarray | None = None) -> list[torch.Tensor]:
    """The rows of each level set in order, as flat ``d·m + i`` indices on
    ``device``: the plain solve's steps, one a level (``levels``, where
    given, are :func:`dag_levels` of ``cols`` already)."""
    lev = (dag_levels(cols, upper) if levels is None
           else np.asarray(levels)).reshape(-1)
    counts = np.bincount(lev)
    return [torch.as_tensor(part, device=device)
            for part in np.split(level_order(lev), np.cumsum(counts)[:-1])]


def tri_solve_ref(cols: torch.Tensor, vals: torch.Tensor, diag: torch.Tensor,
                  r: torch.Tensor, x: torch.Tensor, w: float,
                  schedule: list[torch.Tensor]) -> torch.Tensor:
    """``x + w · T⁻¹ r`` with ``T`` each rank's strict triangle
    (``cols``/``vals`` ``[D, m, K]``, -1 padding) plus ``diag`` ``[D, m]``;
    ``r``, ``x`` ``[D, m]`` or ``[D, m, k]``; ``schedule`` the level sets
    of :func:`level_schedule`."""
    D, m, K = cols.shape
    R = wide(r.reshape(D * m, -1))
    z = torch.zeros_like(R)              # float32 for bfloat16 operands
    keep = (cols >= 0).reshape(D * m, K)
    offs = (torch.arange(D, device=cols.device) * m).reshape(D, 1, 1)
    fc = torch.where(cols >= 0, cols.long() + offs, 0).reshape(D * m, K)
    fv = wide(vals.reshape(D * m, K))
    dg = wide(diag.reshape(D * m, 1))
    for rows in schedule:
        g = z[fc[rows]]                                   # [n, K, k]
        s = torch.where(keep[rows][..., None], fv[rows][..., None] * g,
                        0.0).sum(dim=1)
        z[rows] = (R[rows] - s) / dg[rows]
    return (wide(x) + w * z.reshape(r.shape)).to(x.dtype)
