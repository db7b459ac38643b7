"""Dispatch for the local sparse kernels, and the per-level layout heuristic
(port of ``repro/kernels/spmv/ops.py``).

``spmv``/``spmm`` (ELL) and ``bcsr`` (block-ELL) route rank-stacked operands
to the CUDA kernel wrappers (which take their plain version only for CPU
tensors) or, with an explicit ``use_kernel=False``, to the plain versions.  :func:`select_local_kernel` /
:func:`select_dist_kernel` are numpy copies of the reference's heuristic.
"""
from __future__ import annotations

import numpy as np

from .bcsr import BLOCK_SIZES, bcsr_spmm, bcsr_spmv
from .ref import bcsr_apply_ref, ell_spmm_ref, ell_spmv_ref
from .spmv import ell_spmm, ell_spmv


def spmv(cols, vals, x, *, use_kernel: bool | None = None):
    """ELL SpMV.  ``use_kernel=None``/``True`` → the kernel wrapper (the
    CUDA kernel for CUDA tensors); ``False`` → the plain version."""
    if use_kernel is False:
        return ell_spmv_ref(cols, vals, x)
    return ell_spmv(cols, vals, x)


def spmm(cols, vals, x, *, use_kernel: bool | None = None):
    """Native multi-RHS ELL SpMM (``x``: ``[D, m, k]``) — one pass over A
    serves every column."""
    if use_kernel is False:
        return ell_spmm_ref(cols, vals, x)
    return ell_spmm(cols, vals, x)


def bcsr(bcols, bvals, x, *, rows: int | None = None,
         use_kernel: bool | None = None):
    """Block-ELL product, ``x`` ``[D, m]`` or ``[D, m, k]`` → its first
    ``rows`` rows (default all ``mb·bs``), ``[D, rows]`` or ``[D, rows, k]``."""
    if use_kernel is False:
        return bcsr_apply_ref(bcols, bvals, x, rows)
    return (bcsr_spmm if x.ndim == 3 else bcsr_spmv)(bcols, bvals, x, rows)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel the device ran so far: eager launches and,
    for a captured CUDA graph, its capture's launches once per replay
    (:mod:`..launches`)."""
    return {"ell_spmv": ell_spmv.launches, "ell_spmm": ell_spmm.launches,
            "bcsr_spmm": bcsr_spmm.launches}


def reset_launch_counts() -> None:
    ell_spmv.launches = ell_spmm.launches = bcsr_spmm.launches = 0


# --------------------------------------------------------------------------
# Per-level layout selection: ELL gather vs BCSR dense blocks (numpy copy)
# --------------------------------------------------------------------------

# How many stored-value touches a BCSR lane is worth relative to an ELL
# gather lane.  This is the reference's constant, tuned for its TPU's matrix
# unit; the port keeps it only so that every level picks the same layout as
# the reference (and the lowered arrays stay bit-comparable).  It says
# nothing about this card; re-deriving it for the H100 is a later step.
MXU_ADVANTAGE = 4.0


def _bcsr_stats(cols: np.ndarray, bs: int) -> tuple[int, int]:
    """(n_blocks, Kb) of blocking an ELL block's coordinates at bs."""
    n, _ = cols.shape
    r = np.repeat(np.arange(n, dtype=np.int64), cols.shape[1])
    c = np.asarray(cols, dtype=np.int64).reshape(-1)
    keep = c >= 0
    r, c = r[keep], c[keep]
    if r.size == 0:
        return 0, 0
    keys = np.unique((r // bs) << 32 | (c // bs))
    brows = keys >> 32
    kb = int(np.bincount(brows).max(initial=0))
    return int(keys.size), kb


def select_local_kernel(cols: np.ndarray,
                        block_sizes: tuple[int, ...] = BLOCK_SIZES,
                        mxu_advantage: float = MXU_ADVANTAGE) -> dict:
    """Choose the local-SpMV layout for one ELL block: ``cols`` [n, K].

    Compares the adjusted stored-value volume of each candidate BCSR
    blocking (``n_blocks·bs² / mxu_advantage``) against the ELL volume
    ``n·K`` (padding waste included).  Returns a dict::

        {"kernel": "ell" | "bcsr", "block_size": 0 | bs,
         "ell_cost": float, "bcsr_cost": float,
         "ell_fill": nnz / (n·K), "bcsr_fill": nnz / (n_blocks·bs²)}
    """
    cols = np.asarray(cols)
    n, K = cols.shape
    nnz = int((cols >= 0).sum())
    ell_cost = float(n * max(K, 1))
    best = {"kernel": "ell", "block_size": 0, "ell_cost": ell_cost,
            "bcsr_cost": float("inf"),
            "ell_fill": nnz / ell_cost if ell_cost else 0.0, "bcsr_fill": 0.0}
    if nnz == 0:
        return best
    for bs in block_sizes:
        n_blocks, _ = _bcsr_stats(cols, bs)
        stored = n_blocks * bs * bs
        cost = stored / mxu_advantage
        if cost < best["bcsr_cost"]:
            best["bcsr_cost"] = cost
            best["bcsr_fill"] = nnz / stored if stored else 0.0
            best_bs = bs
    if best["bcsr_cost"] < best["ell_cost"]:
        best["kernel"] = "bcsr"
        best["block_size"] = best_bs
    return best


def select_dist_kernel(cols_stack: np.ndarray,
                       block_sizes: tuple[int, ...] = BLOCK_SIZES,
                       mxu_advantage: float = MXU_ADVANTAGE) -> dict:
    """One layout decision for a device-stacked operator: ``cols_stack``
    [D, n, K].  Costs are summed across devices and a single
    (kernel, block_size) is returned in the same dict shape as
    :func:`select_local_kernel`.
    """
    cols_stack = np.asarray(cols_stack)
    D, n, K = cols_stack.shape
    nnz = int((cols_stack >= 0).sum())
    ell_cost = float(D * n * max(K, 1))
    best = {"kernel": "ell", "block_size": 0, "ell_cost": ell_cost,
            "bcsr_cost": float("inf"),
            "ell_fill": nnz / ell_cost if ell_cost else 0.0, "bcsr_fill": 0.0}
    if nnz == 0:
        return best
    best_bs = 0
    for bs in block_sizes:
        stored = sum(_bcsr_stats(cols_stack[d], bs)[0]
                     for d in range(D)) * bs * bs
        cost = stored / mxu_advantage
        if cost < best["bcsr_cost"]:
            best["bcsr_cost"] = cost
            best["bcsr_fill"] = nnz / stored if stored else 0.0
            best_bs = bs
    if best["bcsr_cost"] < best["ell_cost"]:
        best["kernel"] = "bcsr"
        best["block_size"] = best_bs
    return best


__all__ = ["spmv", "spmm", "bcsr", "bcsr_spmv", "bcsr_spmm", "launch_counts",
           "reset_launch_counts", "select_local_kernel", "select_dist_kernel",
           "MXU_ADVANTAGE"]
