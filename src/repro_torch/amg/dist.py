# Verbatim copy of repro/amg/dist.py (numpy only); only the imports may differ.
"""Distributed view of an AMG hierarchy: communication graphs per level and
operation, strategy selection (paper §4), and modeled phase costs.

This is the glue between :mod:`repro.amg` (numerics) and :mod:`repro.core`
(the paper's node-aware schedules + max-rate models).  Everything here is
host-side analysis (numpy only); the execution of the same selections lives
in :mod:`repro.amg.dist_solve` (solve phase: :func:`vector_comm_graph` /
:func:`rect_vector_graph` per level and per operator {A, P, R} feed
:func:`repro.core.selector.select` before compiling the fused V-cycle) and
:mod:`repro.amg.dist_setup` (setup phase: :func:`matrix_comm_graph` is the
schedule source for the NAP matrix-row exchanges of the Galerkin SpGEMMs
A·P and Pᵀ·(AP)).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import (CommGraph, MachineParams, Partition, ScheduleStats,
                    Selection, Topology, build, select)
from .csr import CSR
from .hierarchy import Hierarchy

MATRIX_ROW_HEADER = 16.0  # bytes: global row id + length
MATRIX_ENTRY = 12.0       # bytes per nonzero: col (int32) + value (fp64)


def row_partition(A: CSR, topo: Topology) -> Partition:
    return Partition.balanced(A.nrows, topo)


def vector_comm_graph(A: CSR, part: Partition) -> CommGraph:
    """SpMV A·x pattern: off-process columns of each rank's rows (Fig. 6)."""
    offp = []
    for p in range(part.topo.n_procs):
        lo, hi = part.local_range(p)
        offp.append(A.offproc_columns(lo, hi, lo, hi))
    return CommGraph.from_offproc_columns(part, offp)


def matrix_comm_graph(A: CSR, B: CSR, part: Partition,
                      b_part: Partition | None = None) -> CommGraph:
    """SpGEMM A·B pattern: rows of B for off-process columns of A (Fig. 7).

    ``part`` partitions the rows of A; ``b_part`` partitions the rows of B
    (i.e. the column space of A) and defaults to ``part`` — the A·P case,
    where P's rows follow A's row partition.  For Pᵀ·(AP) pass the coarse
    partition as ``part`` and the fine partition as ``b_part``.

    Returned graph: ``partition`` is ``b_part`` and ``need[p]`` holds global
    *row indices of B* — the columns of rank p's rows of A that fall outside
    p's owned B-row range ``b_part.local_range(p)``.  ``weights[i]`` is the
    byte size of B row i when it is communicated once
    (``MATRIX_ENTRY·nnz(row) + MATRIX_ROW_HEADER``), so the §3 schedules and
    max-rate models price whole-row transfers, matching the paper's
    observation that matrix communication "retains the same communication
    pattern as vectors, but requires entire rows".
    """
    b_part = b_part or part
    weights = (np.diff(B.indptr) * MATRIX_ENTRY + MATRIX_ROW_HEADER).astype(np.float64)
    offp = []
    for p in range(part.topo.n_procs):
        rlo, rhi = part.local_range(p)        # rank p's rows of A
        blo, bhi = b_part.local_range(p)      # rank p's rows of B
        offp.append(A.offproc_columns(blo, bhi, rlo, rhi))
    return CommGraph(partition=b_part, need=offp, weights=weights)


@dataclasses.dataclass
class OpComm:
    """One communicating operation at one level."""
    level: int
    op: str                  # "spmv_A", "restrict", "interp", "spgemm_AP", "spgemm_PtAP"
    graph: CommGraph
    selection: Selection

    @property
    def strategy(self) -> str:
        return self.selection.strategy


def analyze_hierarchy(h: Hierarchy, topo: Topology, params: MachineParams,
                      strategies=("standard", "nap2", "nap3")) -> list[OpComm]:
    """Build comm graphs + select strategies for every op at every level.

    Ops per level ℓ (paper Figs. 14/15):
      solve phase : spmv_A (A_ℓ·x, also every smoother sweep),
                    restrict (Pᵀ·r), interp (P·e)
      setup phase : spgemm_AP (A_ℓ·P_ℓ), spgemm_PtAP (Pᵀ·(AP))
    """
    out: list[OpComm] = []
    for l, lv in enumerate(h.levels):
        part = row_partition(lv.A, topo)
        g = vector_comm_graph(lv.A, part)
        out.append(OpComm(l, "spmv_A", g, select(g, params, strategies)))
        if lv.P is None:
            continue
        # interp P·e: vector comm of coarse vector e (columns of P off-proc)
        cpart = Partition.balanced(lv.P.ncols, topo)
        gp = rect_vector_graph(lv.P, part, cpart)
        out.append(OpComm(l, "interp", gp, select(gp, params, strategies)))
        # restrict Pᵀ·r: vector comm of fine vector r
        rpart = part
        gr = rect_vector_graph(lv.R, cpart, rpart)
        out.append(OpComm(l, "restrict", gr, select(gr, params, strategies)))
        # setup SpGEMMs
        gap = matrix_comm_graph(lv.A, lv.P, part)
        out.append(OpComm(l, "spgemm_AP", gap, select(gap, params, strategies)))
        if lv.AP is not None:
            # Pᵀ·(AP): communicate rows of AP for off-proc cols of Pᵀ
            gpt = matrix_comm_graph(lv.R, lv.AP, cpart, b_part=rpart)
            out.append(OpComm(l, "spgemm_PtAP", gpt, select(gpt, params, strategies)))
    return out


def schedule_comm_stats(graph: CommGraph, strategy: str) -> dict:
    """Modeled message/byte totals of executing ``strategy`` on ``graph``
    once — the per-matvec communication cost the cycle-shape accounting of
    :func:`repro.amg.dist_solve.cycle_comm_stats` multiplies by per-level
    visit counts (W/F-cycles revisit exactly the coarse levels where the
    NAP strategies aggregate small inter-node messages)."""
    st = ScheduleStats.of(build(strategy, graph))
    return {"inter_msgs": int(st.inter_msg_count),
            "inter_bytes": float(st.inter_bytes_total),
            "intra_msgs": int(st.intra_msg_count),
            "intra_bytes": float(st.intra_bytes_total)}


def rect_vector_graph(M: CSR, row_part: Partition, col_part: Partition) -> CommGraph:
    """Vector comm for y = M·x where rows of M follow row_part and x follows
    col_part (rectangular operators P and R)."""
    offp = []
    for p in range(row_part.topo.n_procs):
        rlo, rhi = row_part.local_range(p)
        clo, chi = col_part.local_range(p)
        offp.append(M.offproc_columns(clo, chi, rlo, rhi))
    return CommGraph.from_offproc_columns(col_part, offp)


def phase_costs(ops: list[OpComm], n_levels: int):
    """Aggregate modeled comm seconds per level for solve/setup phases, per
    strategy and for the model-selected mix (Figs. 2/4/14/15).

    An op whose selection was run over a strategy subset simply contributes
    nothing to the strategies it never modeled (the column stays a partial
    sum) — a missing entry must not poison the whole level with ``inf``.
    """
    solve_ops = ("spmv_A", "restrict", "interp")
    out = {"solve": {}, "setup": {}}
    for phase, opset in (("solve", solve_ops), ("setup", ("spgemm_AP", "spgemm_PtAP"))):
        per_level = {}
        for l in range(n_levels):
            row = {"standard": 0.0, "nap2": 0.0, "nap3": 0.0, "selected": 0.0}
            for oc in ops:
                if oc.level != l or oc.op not in opset:
                    continue
                for s in ("standard", "nap2", "nap3"):
                    t = oc.selection.times.get(s)
                    if t is not None and np.isfinite(t):
                        row[s] += t
                row["selected"] += oc.selection.modeled_time
            per_level[l] = row
        out[phase] = per_level
    return out
