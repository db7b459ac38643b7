# Verbatim copy of repro/core/topology.py (numpy only); only the imports may differ.
"""Virtual parallel topology: processes grouped into SMP nodes.

The paper's machine model (Blue Waters: 16 processes per node; Quartz: 32 ppn)
is captured by :class:`Topology`.  On TPU the same object describes the
hierarchical mesh: "node" = ICI pod (or host domain), "process" = chip.

Everything here is plain host-side python/numpy — it is used both by the
rank-faithful simulator (tests/benchmarks) and by the shard_map collective
builders (device path).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """``n_nodes`` SMP nodes with ``ppn`` processes each.

    Processes are ranked ``0 .. n_procs-1`` with node-major contiguous
    placement (rank // ppn == node id), matching the default MPI rank
    placement the paper assumes.
    """

    n_nodes: int
    ppn: int

    def __post_init__(self) -> None:
        if self.n_nodes < 1 or self.ppn < 1:
            raise ValueError("n_nodes and ppn must be positive")

    @property
    def n_procs(self) -> int:
        return self.n_nodes * self.ppn

    def node_of(self, rank: int) -> int:
        return rank // self.ppn

    def local_rank(self, rank: int) -> int:
        return rank % self.ppn

    def ranks_on_node(self, node: int) -> range:
        return range(node * self.ppn, (node + 1) * self.ppn)

    def on_same_node(self, a: int, b: int) -> bool:
        return self.node_of(a) == self.node_of(b)

    def node_array(self) -> np.ndarray:
        """node id of every rank, shape (n_procs,)."""
        return np.repeat(np.arange(self.n_nodes), self.ppn)


@dataclasses.dataclass(frozen=True)
class Partition:
    """Contiguous row-wise partition of ``n`` global rows over ``topo.n_procs``.

    ``offsets[p] .. offsets[p+1]`` are the global rows owned by rank ``p``
    (the row-wise partition of Figure 6 in the paper).
    """

    n: int
    topo: Topology
    offsets: np.ndarray  # (n_procs + 1,)

    @staticmethod
    def balanced(n: int, topo: Topology) -> "Partition":
        P = topo.n_procs
        base, extra = divmod(n, P)
        counts = np.full(P, base, dtype=np.int64)
        counts[:extra] += 1
        offsets = np.zeros(P + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return Partition(n=n, topo=topo, offsets=offsets)

    def owner_of_rows(self, rows: np.ndarray) -> np.ndarray:
        """Owning rank of each global row (vectorized)."""
        return np.searchsorted(self.offsets, rows, side="right") - 1

    def local_range(self, rank: int) -> tuple[int, int]:
        return int(self.offsets[rank]), int(self.offsets[rank + 1])

    def local_size(self, rank: int) -> int:
        lo, hi = self.local_range(rank)
        return hi - lo

    @property
    def max_local_size(self) -> int:
        return int(np.max(np.diff(self.offsets)))
