# Verbatim copy of repro/amg/hierarchy.py (numpy only); only the imports may differ.
"""AMG setup (Algorithm 1) for Ruge-Stüben and smoothed-aggregation solvers."""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .csr import CSR
from .interpolation import (direct_interpolation, jacobi_smooth_prolongator,
                            tentative_prolongator)
from .splitting import mis2_aggregation, pmis
from .strength import classical_strength, symmetric_strength


@dataclasses.dataclass
class Level:
    A: CSR
    P: CSR | None = None        # to the NEXT (coarser) level
    R: CSR | None = None        # restriction = Pᵀ
    AP: CSR | None = None       # intermediate Galerkin product (Fig. 21 op)
    setup_seconds: float = 0.0
    # per-level smoother data extracted once and carried on the level
    # (block-Jacobi diagonal-block inverses, keyed by (kind, block_size,
    # parts)) — the setup-phase half of the block smoothers
    smoother_cache: dict = dataclasses.field(default_factory=dict,
                                             repr=False, compare=False)


@dataclasses.dataclass
class Hierarchy:
    solver: str
    levels: list[Level]
    theta: float
    # per-hierarchy cache of lowered DistHierarchy objects, keyed by the
    # frozen build kwargs (see repro.amg.dist_solve._ensure_dist) — lives on
    # the hierarchy so its lifetime matches the operators it lowers
    dist_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def grid_complexity(self) -> float:
        return sum(l.A.nrows for l in self.levels) / self.levels[0].A.nrows

    def operator_complexity(self) -> float:
        return sum(l.A.nnz for l in self.levels) / self.levels[0].A.nnz

    def summary(self) -> str:
        rows = [f"{self.solver} hierarchy: {self.n_levels} levels, "
                f"oc={self.operator_complexity():.2f} gc={self.grid_complexity():.2f}"]
        for i, l in enumerate(self.levels):
            rows.append(f"  L{i}: n={l.A.nrows:9d} nnz={l.A.nnz:11d} "
                        f"nnz/row={l.A.nnz / max(l.A.nrows, 1):6.1f}")
        return "\n".join(rows)


# --------------------------------------------------------------------------
# Setup stages (Algorithm 1, one function per stage)
#
# Each stage is callable on its own so a distributed setup can run it
# per-partition: strength is row-local (a row's pattern depends only on that
# row, so it is exact on a partitioned row block); splitting and
# interpolation need off-process values, which :mod:`repro.amg.dist_setup`
# supplies through halo exchanges while calling the same underlying kernels.
# --------------------------------------------------------------------------


def strength_stage(A: CSR, solver: str = "rs", theta: float = 0.25) -> CSR:
    """Strength-of-connection.  Row-local: exact on a partitioned row block."""
    if solver == "rs":
        return classical_strength(A, theta)
    if solver == "sa":
        return symmetric_strength(A, theta)
    raise ValueError(f"unknown solver {solver!r}")


def splitting_stage(S: CSR, solver: str = "rs", seed: int = 42,
                    aggressive: bool = False) -> np.ndarray:
    """CF splitting (rs → PMIS status) or aggregation (sa → aggregate ids).

    Iterates on the global strength graph; the distributed setup re-runs the
    same PMIS iteration per-partition with halo exchanges of the status and
    weight vectors (:func:`repro.amg.dist_setup._dist_pmis`).
    """
    if solver == "rs":
        return pmis(S, seed=seed, aggressive=aggressive)
    if solver == "sa":
        return mis2_aggregation(S, seed=seed)
    raise ValueError(f"unknown solver {solver!r}")


def splitting_stalled(split: np.ndarray, nrows: int, solver: str = "rs") -> bool:
    """True when the splitting made no coarsening progress."""
    if solver == "rs":
        return int((split == 1).sum()) in (0, nrows)
    return int(split.max()) + 1 >= nrows


def interpolation_stage(A: CSR, S: CSR, split: np.ndarray, solver: str = "rs",
                        prolongation_sweeps: int = 1) -> CSR:
    """Build P from the splitting (direct interpolation / smoothed tentative)."""
    if solver == "rs":
        return direct_interpolation(A, S, split)
    if solver == "sa":
        T = tentative_prolongator(split)
        return jacobi_smooth_prolongator(A, T, sweeps=prolongation_sweeps)
    raise ValueError(f"unknown solver {solver!r}")


def coarsen_level(A: CSR, solver: str = "rs", theta: float = 0.25,
                  aggressive: bool = False, prolongation_sweeps: int = 1,
                  seed: int = 42) -> CSR | None:
    """strength → splitting → interpolation; ``None`` when coarsening stalls."""
    S = strength_stage(A, solver, theta)
    split = splitting_stage(S, solver, seed=seed, aggressive=aggressive)
    if splitting_stalled(split, A.nrows, solver):
        return None
    return interpolation_stage(A, S, split, solver, prolongation_sweeps)


def project_pattern_values(src: CSR, indptr: np.ndarray,
                           indices: np.ndarray, nrows: int,
                           ncols: int) -> np.ndarray:
    """Values of ``src`` gathered at a frozen CSR pattern's positions.

    Entries of the frozen pattern absent from ``src`` read as zero;
    entries of ``src`` outside the pattern are dropped — they are exactly
    the positions ``prune`` removed when the pattern froze, so a
    refreshed Galerkin product lands on the layouts every downstream
    plan/kernel was built for."""
    ncols = int(ncols)
    skey = src.rows_expanded().astype(np.int64) * ncols \
        + src.indices.astype(np.int64)
    order = np.argsort(skey, kind="stable")
    skey = skey[order]
    drows = np.repeat(np.arange(int(nrows), dtype=np.int64),
                      np.diff(indptr).astype(np.int64))
    dkey = drows * ncols + indices.astype(np.int64)
    pos = np.searchsorted(skey, dkey)
    pos_c = np.minimum(pos, max(skey.size - 1, 0))
    hit = skey[pos_c] == dkey if skey.size else np.zeros(dkey.shape, bool)
    vals = np.zeros(dkey.shape)
    vals[hit] = src.data[order][pos_c[hit]]
    return vals


def refresh_values(h: Hierarchy, A_new: CSR) -> None:
    """Value-only refresh: re-run the Galerkin products numerically onto
    the frozen level patterns, leaving every structure — splittings,
    interpolation operators, patterns, and the lowered ``dist_cache``
    hierarchies with their compiled programs — untouched.

    The caller is responsible for having checked that ``A_new`` shares
    the fine level's sparsity pattern (``pattern_fingerprint``)."""
    fine = h.levels[0].A
    if A_new.data.shape != fine.data.shape:
        raise ValueError(f"value refresh needs {fine.data.shape[0]} values, "
                         f"got {A_new.data.shape[0]}")
    # copy-on-write: the fine level usually aliases the caller's matrix
    # (setup never copies), so a refresh must re-point it rather than write
    # through the alias and silently mutate user-owned arrays
    h.levels[0].A = CSR(fine.shape, fine.indptr, fine.indices,
                        np.array(A_new.data, dtype=np.float64))
    for lv, nxt in zip(h.levels[:-1], h.levels[1:]):
        lv.smoother_cache.clear()
        AP = lv.A.spgemm(lv.P)               # P/R frozen: values and pattern
        Ac = lv.R.spgemm(AP)
        lv.AP.data[...] = project_pattern_values(
            AP, lv.AP.indptr, lv.AP.indices, lv.AP.nrows, lv.AP.ncols)
        nxt.A.data[...] = project_pattern_values(
            Ac, nxt.A.indptr, nxt.A.indices, nxt.A.nrows, nxt.A.ncols)
    h.levels[-1].smoother_cache.clear()
    for dh in h.dist_cache.values():
        dh.refresh_values(h.levels)


def setup(A: CSR, solver: str = "rs", theta: float = 0.25,
          max_coarse: int = 100, max_levels: int = 25,
          aggressive: bool = False, prolongation_sweeps: int = 1,
          seed: int = 42) -> Hierarchy:
    """Algorithm 1.  ``solver``: "rs" (Ruge-Stüben/HMIS-style) or
    "sa" (smoothed aggregation, MIS-2 aggregates)."""
    levels = [Level(A=A)]
    l = 0
    while levels[l].A.nrows > max_coarse and l + 1 < max_levels:
        t0 = time.perf_counter()
        Al = levels[l].A
        P = coarsen_level(Al, solver, theta, aggressive,
                          prolongation_sweeps, seed + l)
        if P is None:
            break  # coarsening stalled
        R = P.T
        AP = Al.spgemm(P)                                        # Galerkin 1/2
        Ac = R.spgemm(AP)                                        # Galerkin 2/2
        Ac = Ac.prune(1e-14)
        levels[l].P, levels[l].R, levels[l].AP = P, R, AP
        levels[l].setup_seconds = time.perf_counter() - t0
        levels.append(Level(A=Ac))
        if Ac.nrows >= Al.nrows:  # no progress
            levels.pop()
            break
        l += 1
    return Hierarchy(solver=solver, levels=levels, theta=theta)
