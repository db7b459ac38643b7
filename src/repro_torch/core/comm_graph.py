# Verbatim copy of repro/core/comm_graph.py (numpy only); only the imports may differ.
"""Communication graphs: which global indices each rank must receive.

A :class:`CommGraph` is the abstract object the paper's three strategies
schedule.  For *vector* communication (SpMV), index ``i`` is a vector entry
(8 bytes).  For *matrix* communication (SpGEMM ``A·B``), index ``i`` is a row
of ``B`` and weighs ``12·nnz(row) + 16`` bytes (values + column indices + row
header), matching the paper's observation that matrix comm "retains the same
communication pattern as vectors, but requires entire rows".
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Partition, Topology

VECTOR_BYTES = 8.0  # one fp64 value per index


@dataclasses.dataclass
class CommGraph:
    """``need[q]`` = sorted unique global indices rank ``q`` must receive.

    ``weights[i]`` = bytes transferred when index ``i`` is communicated once.
    Owned indices are never in ``need`` (no self-communication).
    """

    partition: Partition
    need: list[np.ndarray]
    weights: np.ndarray | None = None  # (n,) bytes per index; None -> VECTOR_BYTES

    def __post_init__(self) -> None:
        if len(self.need) != self.partition.topo.n_procs:
            raise ValueError("need must have one entry per rank")
        for q, idx in enumerate(self.need):
            lo, hi = self.partition.local_range(q)
            if idx.size and ((idx >= lo) & (idx < hi)).any():
                raise ValueError(f"rank {q} 'needs' indices it owns")

    @property
    def topo(self) -> Topology:
        return self.partition.topo

    def bytes_of(self, indices: np.ndarray) -> float:
        if self.weights is None:
            return VECTOR_BYTES * float(indices.size)
        return float(self.weights[indices].sum())

    # ------------------------------------------------------------------ build
    @staticmethod
    def from_offproc_columns(
        partition: Partition,
        offproc_cols: list[np.ndarray],
        weights: np.ndarray | None = None,
    ) -> "CommGraph":
        """Vector/matrix comm pattern from each rank's off-process columns."""
        need = [np.unique(np.asarray(c, dtype=np.int64)) for c in offproc_cols]
        return CommGraph(partition=partition, need=need, weights=weights)

    # ------------------------------------------------------- derived groupings
    def need_by_owner(self, q: int) -> dict[int, np.ndarray]:
        """Split rank ``q``'s needs by owning rank."""
        idx = self.need[q]
        if idx.size == 0:
            return {}
        owners = self.partition.owner_of_rows(idx)
        out: dict[int, np.ndarray] = {}
        for p in np.unique(owners):
            out[int(p)] = idx[owners == p]
        return out

    def recv_pairs(self) -> list[tuple[int, int, np.ndarray]]:
        """All (owner p, receiver q, indices) point-to-point requirements."""
        out = []
        for q in range(self.topo.n_procs):
            for p, idx in self.need_by_owner(q).items():
                out.append((p, q, idx))
        return out
