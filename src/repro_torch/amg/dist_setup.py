# Copy of repro/amg/dist_setup.py (numpy only); dist_setup lowers onto the port's DistHierarchy.
"""Distributed node-aware AMG **setup phase** (paper Figs. 14/15 executed;
PyTorch port of :mod:`repro.amg.dist_setup`).

The paper's headline claim covers both phases of AMG: the setup-phase
SpGEMMs — ``AP_ℓ = A_ℓ·P_ℓ`` and ``A_{ℓ+1} = Pᵀ_ℓ·(AP_ℓ)`` — dominate
communication on coarse levels, and the same three-step node-aware
restructuring that speeds up vector halos applies to matrix-row exchange.
This module runs Algorithm 1 **partitioned from the start**: the fine-grid
matrix is split into per-rank row blocks once, every stage operates on
blocks, and the hierarchy that comes out is *born partitioned* — it is
lowered straight onto the card's rank-stacked tensors by
:meth:`~repro_torch.amg.dist_solve.DistHierarchy.from_partitioned` with no
host gather/re-scatter between setup and solve.

Per level ℓ:

* **strength** — row-local; :func:`~repro_torch.amg.hierarchy.strength_stage`
  runs unchanged on each rank's block (a row's pattern depends only on
  that row).
* **splitting** — the PMIS iteration re-run per-partition: the strength
  transpose arrives through a transpose exchange, and each round's
  unassigned/new-C indicators move through vector halo gathers
  (:func:`_dist_pmis` reproduces :func:`repro_torch.amg.splitting.pmis`
  bit-for-bit).  Aggressive (distance-2) coarsening squares the strength
  graph with the same NAP matrix-row exchange as the Galerkin products.
* **interpolation** — per-block :func:`~repro_torch.amg.interpolation.
  direct_interpolation`, with C/F status and the fine→coarse map for halo
  columns supplied by vector gathers.
* **Galerkin products** — the tentpole: :func:`~repro_torch.amg.dist.
  matrix_comm_graph` (indices = rows of B, weights = per-row bytes) feeds
  :func:`repro_torch.core.selector.select`, and the winning
  standard/NAP-2/NAP-3 schedule is *executed* as a rank-faithful CSR-row
  exchange (:func:`~repro_torch.core.nap_collectives.matrix_halo_exchange`) before each
  rank's local SpGEMM.  Modeled times and measured message/byte counts are
  recorded per (level, op) in :class:`SetupCommRecord`.

Matrix representation: "global indexing, local storage" — each rank holds a
*global-shape* CSR containing only its own rows (:class:`BlockMatrix`), so
column ids never need remapping, every stage kernel is reused verbatim, and
no global CSR of any level operator is ever assembled (the sole exceptions:
the input fine-grid matrix, which the caller hands us, and the coarsest
level's tiny dense pseudo-inverse shared with the host-lowered path).

Entry points: :func:`dist_setup_partitioned` (numpy-only loop → blocks +
records, usable without any device mesh) and :func:`dist_setup`
(→ the port's :class:`~repro_torch.amg.dist_solve.DistHierarchy` on the
card, or on the CPU when asked; the ``AMGConfig(setup_backend="dist")``
path).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core import MachineParams, Partition, Topology, select
from ..core.nap_collectives import (MatrixHaloPlan, build_matrix_halo_plan,
                                    matrix_halo_exchange)
from ..core.perf_model import TPU_V5E
from .csr import CSR
from .dist import matrix_comm_graph
from .hierarchy import strength_stage
from .splitting import CPOINT, FPOINT, UNASSIGNED, _drop_diag

SETUP_STRATEGIES = ("standard", "nap2", "nap3")


# --------------------------------------------------------------------------
# Block representation: global indexing, local storage
# --------------------------------------------------------------------------


def _global_shape_block(M: CSR, lo: int, hi: int) -> CSR:
    """Rows ``[lo, hi)`` of ``M`` as a global-shape CSR (other rows empty)."""
    sl = slice(int(M.indptr[lo]), int(M.indptr[hi]))
    indptr = np.zeros(M.nrows + 1, dtype=np.int64)
    indptr[lo + 1: hi + 1] = M.indptr[lo + 1: hi + 1] - M.indptr[lo]
    indptr[hi + 1:] = indptr[hi]
    return CSR(M.shape, indptr, M.indices[sl].copy(), M.data[sl].copy())


class BlockMatrix:
    """A row-partitioned matrix that never exists as one global CSR.

    ``blocks[d]`` is a global-shape CSR holding exactly rank d's rows of the
    partition (global column ids, empty remote rows).  Implements the subset
    of the :class:`~repro_torch.amg.csr.CSR` protocol the analysis and lowering
    layers consume (``offproc_columns``, ``submatrix_rows``, ``indptr``,
    ``diagonal``, ``matvec``, ``to_dense``), each dispatching to — or
    reducing over — the per-rank blocks, so :func:`~repro_torch.amg.dist.
    matrix_comm_graph`, :func:`~repro_torch.amg.dist.rect_vector_graph` and
    :func:`~repro_torch.amg.dist_solve.DistHierarchy.from_partitioned` work
    on it
    unchanged.
    """

    def __init__(self, blocks: list[CSR], part: Partition):
        assert len(blocks) == part.topo.n_procs
        self.blocks = blocks
        self.part = part
        self.shape = blocks[0].shape

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return sum(b.nnz for b in self.blocks)

    @property
    def indptr(self) -> np.ndarray:
        # disjoint row sets ⇒ the union's indptr is the sum of the blocks'
        # (cumsum is linear in the per-row counts)
        out = np.zeros(self.nrows + 1, dtype=np.int64)
        for b in self.blocks:
            out += b.indptr
        return out

    def _owner_of_range(self, row_lo: int, row_hi: int) -> int:
        d = int(self.part.owner_of_rows(np.asarray([row_lo]))[0])
        lo, hi = self.part.local_range(d)
        assert lo <= row_lo and row_hi <= hi, \
            f"rows [{row_lo},{row_hi}) cross rank boundaries"
        return d

    def offproc_columns(self, lo: int, hi: int, row_lo: int,
                        row_hi: int) -> np.ndarray:
        if row_lo == row_hi:
            return np.zeros(0, dtype=np.int64)
        d = self._owner_of_range(row_lo, row_hi)
        return self.blocks[d].offproc_columns(lo, hi, row_lo, row_hi)

    def submatrix_rows(self, row_lo: int, row_hi: int) -> CSR:
        if row_lo == row_hi:
            return CSR((0, self.ncols), np.zeros(1, dtype=np.int64),
                       np.zeros(0, dtype=np.int64), np.zeros(0))
        d = self._owner_of_range(row_lo, row_hi)
        return self.blocks[d].submatrix_rows(row_lo, row_hi)

    def diagonal(self) -> np.ndarray:
        out = np.zeros(min(self.shape))
        for b in self.blocks:
            out += b.diagonal()
        return out

    def matvec(self, x: np.ndarray) -> np.ndarray:
        out = None
        for b in self.blocks:
            y = b.matvec(x)
            out = y if out is None else out + y
        return out

    def to_dense(self) -> np.ndarray:
        # only legitimate for the tiny coarsest level (dense pinv solve)
        out = np.zeros(self.shape)
        for b in self.blocks:
            out += b.to_dense()
        return out


def split_rows(A: CSR, part: Partition) -> BlockMatrix:
    """Partition a global CSR into per-rank row blocks (the fine-grid entry
    point — the one place a global level matrix is read)."""
    blocks = [_global_shape_block(A, *part.local_range(d))
              for d in range(part.topo.n_procs)]
    return BlockMatrix(blocks, part)


def transpose_blocks(M: BlockMatrix, out_part: Partition) -> BlockMatrix:
    """Rows of ``Mᵀ``, partitioned by ``out_part`` — the transpose exchange.

    Each source rank hands the entries of its rows, grouped by column owner,
    to that column's owner; concatenating contributions in rank order (==
    global row order) reproduces the host ``CSR.T`` per row exactly (sorted
    column ids, identical values).
    """
    D = out_part.topo.n_procs
    t = [blk.transpose() for blk in M.blocks]       # per-source, global rows
    out_blocks = []
    for r in range(D):
        lo, hi = out_part.local_range(r)
        acc = None
        for s in range(D):
            piece = _global_shape_block(t[s], lo, hi)
            if piece.nnz == 0 and acc is not None:
                continue
            acc = piece if acc is None else acc.add(piece)
        out_blocks.append(acc)
    return BlockMatrix(out_blocks, out_part)


def _rows_to_block(rows: dict[int, tuple[np.ndarray, np.ndarray]],
                   shape: tuple[int, int]) -> CSR:
    """Received halo rows ({global row: (cols, vals)}) as a global-shape CSR."""
    n = shape[0]
    indptr = np.zeros(n + 1, dtype=np.int64)
    if not rows:
        return CSR(shape, indptr, np.zeros(0, dtype=np.int64), np.zeros(0))
    idx = np.fromiter(sorted(rows), dtype=np.int64, count=len(rows))
    cols = np.concatenate([rows[int(i)][0] for i in idx])
    vals = np.concatenate([rows[int(i)][1] for i in idx])
    counts = np.zeros(n, dtype=np.int64)
    counts[idx] = [rows[int(i)][0].size for i in idx]
    np.cumsum(counts, out=indptr[1:])
    return CSR(shape, indptr, cols.astype(np.int64), vals.astype(np.float64))


def _gather(parts: list[np.ndarray], part: Partition,
            idx: np.ndarray) -> np.ndarray:
    """Vector halo gather: values of global indices ``idx`` from their
    owners' local slices (the setup phase's auxiliary vector communication —
    status/weight indicators, fine→coarse maps)."""
    out = np.empty(idx.shape, dtype=parts[0].dtype if parts else np.float64)
    if idx.size == 0:
        return out
    owners = part.owner_of_rows(idx)
    for o in np.unique(owners):
        o = int(o)
        lo, _ = part.local_range(o)
        m = owners == o
        out[m] = parts[o][idx[m] - lo]
    return out


# --------------------------------------------------------------------------
# The NAP matrix-row exchange + partitioned SpGEMM
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SetupCommRecord:
    """One setup-phase SpGEMM's communication: what the model chose and what
    the exchange measured (the per-level modeled-vs-measured benchmark row)."""

    level: int
    op: str                      # "spgemm_AP" | "spgemm_PtAP" | "spgemm_S2"
    strategy: str
    modeled: dict[str, float]    # modeled seconds per strategy ({} if forced)
    inter_msgs: int = 0
    inter_bytes: float = 0.0
    intra_msgs: int = 0
    intra_bytes: float = 0.0
    seconds: float = 0.0         # measured wall time of the row exchange
    n_halo_rows: int = 0         # total B rows communicated (all ranks)
    # on/off split of the local products: C_on = A·B_local runs while the
    # row exchange is in flight, C_off = A·B_halo lands after it
    on_nnz: int = 0              # nnz of all ranks' C_on
    off_nnz: int = 0             # nnz of all ranks' C_off
    on_seconds: float = 0.0      # measured wall time of the C_on products
    off_seconds: float = 0.0     # measured wall time of C_off + merge

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def dist_spgemm(Ab: BlockMatrix, Bb: BlockMatrix, *,
                params: MachineParams = TPU_V5E, strategy: str = "auto",
                strategies: tuple[str, ...] = SETUP_STRATEGIES,
                op: str = "spgemm", level: int = 0,
                records: list | None = None,
                plan_cache: dict | None = None) -> BlockMatrix:
    """``C = A·B`` with A, B and C row-partitioned.

    Overlapped structure: each rank's on-process product ``C_on = A·B_local``
    needs no remote data, so it runs *before* the halo rows land (an MPI
    code posts the sends, multiplies, then waits); the off-process
    correction ``C_off = A·B_halo`` and the merge follow the exchange.
    ``B_local`` and the halo rows are row-disjoint, so
    ``C_on + C_off == A·(B_local + B_halo)`` with the same sparsity pattern
    (values reassociated within fp round-off).

    ``plan_cache`` (keyed by ``op``) makes the product replayable for
    streaming value refreshes: on a miss the comm graph is built and the
    strategy selected as usual, then ``(strategy, plan)`` is stored; on a
    hit both are reused verbatim — no comm-graph rebuild, no model
    re-selection — which is sound exactly when the operand sparsity
    patterns are frozen (the plan is a pure function of them).
    """
    cached = plan_cache.get(op) if plan_cache is not None else None
    if cached is not None:
        strat, plan = cached
        times = {}
    else:
        g = matrix_comm_graph(Ab, Bb, Ab.part, b_part=Bb.part)
        if strategy == "auto":
            sel = select(g, params, strategies)
            strat, times = sel.strategy, dict(sel.times)
            plan = MatrixHaloPlan(strat, g, sel.schedule)
        else:
            strat, times = strategy, {}
            plan = build_matrix_halo_plan(g, strat)
        if plan_cache is not None:
            plan_cache[op] = (strat, plan)

    def get_row(rank: int, i: int):
        blk = Bb.blocks[rank]
        sl = slice(int(blk.indptr[i]), int(blk.indptr[i + 1]))
        return blk.indices[sl], blk.data[sl]

    D = Ab.part.topo.n_procs
    t0 = time.perf_counter()
    on_blocks = [Ab.blocks[d].spgemm(Bb.blocks[d]) for d in range(D)]
    on_seconds = time.perf_counter() - t0
    res = matrix_halo_exchange(plan, get_row)
    t0 = time.perf_counter()
    out_blocks = []
    off_nnz = 0
    for d in range(D):
        halo = _rows_to_block(res.halo[d], Bb.shape)
        if halo.nnz:
            C_off = Ab.blocks[d].spgemm(halo)
            off_nnz += C_off.nnz
            out_blocks.append(on_blocks[d].add(C_off))
        else:
            out_blocks.append(on_blocks[d])
    off_seconds = time.perf_counter() - t0
    if records is not None:
        records.append(SetupCommRecord(
            level=level, op=op, strategy=strat, modeled=times,
            inter_msgs=res.inter_msgs, inter_bytes=res.inter_bytes,
            intra_msgs=res.intra_msgs, intra_bytes=res.intra_bytes,
            seconds=res.seconds,
            n_halo_rows=sum(len(h) for h in res.halo),
            on_nnz=sum(b.nnz for b in on_blocks), off_nnz=off_nnz,
            on_seconds=on_seconds, off_seconds=off_seconds))
    return BlockMatrix(out_blocks, Ab.part)


# --------------------------------------------------------------------------
# Partitioned PMIS splitting (bit-for-bit the host iteration)
# --------------------------------------------------------------------------


def _sym_graph_blocks(Sb: BlockMatrix, Stb: BlockMatrix) -> BlockMatrix:
    """Per-rank ``drop_diag(S + Sᵀ)`` — the host ``_sym_graph`` on blocks."""
    return BlockMatrix([_drop_diag(s.add(t))
                        for s, t in zip(Sb.blocks, Stb.blocks)], Sb.part)


def _dist_pmis(Gb: BlockMatrix, w_parts: list[np.ndarray],
               part: Partition) -> list[np.ndarray]:
    """PMIS on a partitioned (symmetric) strength graph.

    Mirrors :func:`repro_torch.amg.splitting.pmis` exactly: per-rank full-length
    scratch vectors hold only local + halo entries (everything a rank's rows
    reference), refreshed each round by vector halo gathers; the numeric-tie
    fallback is a global arg-max reduction.  G's symmetry is what lets the
    "neighbors of new C points" update run with forward gathers only.
    """
    from .splitting import _row_max

    D = part.topo.n_procs
    n = Gb.nrows
    ranges = [part.local_range(d) for d in range(D)]
    need = [Gb.blocks[d].offproc_columns(*ranges[d], *ranges[d])
            for d in range(D)]
    # static: w at local + halo positions
    w_full = []
    for d in range(D):
        lo, hi = ranges[d]
        wf = np.zeros(n)
        wf[lo:hi] = w_parts[d]
        wf[need[d]] = _gather(w_parts, part, need[d])
        w_full.append(wf)
    status = []
    for d in range(D):
        lo, hi = ranges[d]
        st = np.full(hi - lo, UNASSIGNED, dtype=np.int64)
        st[np.diff(Gb.blocks[d].indptr)[lo:hi] == 0] = FPOINT  # isolated
        status.append(st)

    while any((st == UNASSIGNED).any() for st in status):
        unass_parts = [(st == UNASSIGNED) for st in status]
        new_c_parts = []
        for d in range(D):
            lo, hi = ranges[d]
            uf = np.zeros(n, dtype=bool)
            uf[lo:hi] = unass_parts[d]
            uf[need[d]] = _gather(unass_parts, part, need[d])
            nb_max = _row_max(Gb.blocks[d], w_full[d], uf)[lo:hi]
            new_c_parts.append(unass_parts[d] & (w_full[d][lo:hi] > nb_max))
        if not any(nc.any() for nc in new_c_parts):
            # numeric tie safety: global arg-max over unassigned (first
            # occurrence in global row order, as the host fallback picks)
            best_val, best = -np.inf, None
            for d in range(D):
                lo, _ = ranges[d]
                idx = np.flatnonzero(unass_parts[d])
                if idx.size == 0:
                    continue
                j = idx[np.argmax(w_parts[d][idx])]
                if w_parts[d][j] > best_val:
                    best_val, best = w_parts[d][j], (d, j)
            d, j = best
            new_c_parts[d][j] = True
        for d in range(D):
            status[d][new_c_parts[d]] = CPOINT
        for d in range(D):
            lo, hi = ranges[d]
            cf = np.zeros(n, dtype=bool)
            cf[lo:hi] = new_c_parts[d]
            cf[need[d]] = _gather(new_c_parts, part, need[d])
            blk = Gb.blocks[d]
            r = blk.rows_expanded()
            touched = np.zeros(n, dtype=bool)
            touched[r[cf[blk.indices]]] = True   # rows with a new-C neighbor
            upd = (status[d] == UNASSIGNED) & touched[lo:hi]
            status[d][upd] = FPOINT
    return status


# --------------------------------------------------------------------------
# The partitioned setup loop (Algorithm 1 over blocks)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PartitionedLevel:
    """Mirror of :class:`~repro_torch.amg.hierarchy.Level` with every operator a
    :class:`BlockMatrix` — a level that was born partitioned."""

    A: BlockMatrix
    P: BlockMatrix | None = None
    R: BlockMatrix | None = None
    AP: BlockMatrix | None = None
    setup_seconds: float = 0.0
    # NAP schedules of this level's Galerkin row exchanges, keyed by op
    # ("spgemm_AP"/"spgemm_PtAP" → (strategy, MatrixHaloPlan)) — retained
    # so streaming value refreshes replay the products through the
    # already-selected schedules without rebuilding any comm graph
    plans: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)


def dist_setup_partitioned(
        A: CSR, n_pods: int, lanes: int, *, solver: str = "rs",
        theta: float = 0.25, max_coarse: int = 100, max_levels: int = 25,
        aggressive: bool = False, prolongation_sweeps: int = 1,
        seed: int = 42, params: MachineParams = TPU_V5E,
        strategy: str = "auto",
        strategies: tuple[str, ...] = SETUP_STRATEGIES,
) -> tuple[list[PartitionedLevel], list[SetupCommRecord]]:
    """Algorithm 1, partitioned end-to-end (numpy only — no device mesh).

    Returns the per-level blocks plus one :class:`SetupCommRecord` per
    executed SpGEMM row exchange.  Matches :func:`repro_torch.amg.hierarchy.setup`
    sparsity and values exactly (same kernels, same per-row arithmetic).
    """
    from .interpolation import direct_interpolation

    if solver != "rs":
        raise ValueError(
            f"setup_backend='dist' supports solver='rs' (got {solver!r}); "
            "SA's MIS-2 aggregation has order-dependent host semantics — "
            "use the host setup for 'sa'")
    topo = Topology(n_nodes=n_pods, ppn=lanes)
    D = topo.n_procs
    part0 = Partition.balanced(A.nrows, topo)
    plevels = [PartitionedLevel(A=split_rows(A, part0))]
    records: list[SetupCommRecord] = []
    l = 0
    while plevels[l].A.nrows > max_coarse and l + 1 < max_levels:
        t0 = time.perf_counter()
        Ab = plevels[l].A
        part = Ab.part
        n = Ab.nrows
        ranges = [part.local_range(d) for d in range(D)]
        # -- strength: row-local, exact per block
        Sb = BlockMatrix([strength_stage(blk, solver, theta)
                          for blk in Ab.blocks], part)
        # -- splitting: symmetrize (transpose exchange), optional distance-2
        #    squaring (NAP matrix-row exchange), then the partitioned PMIS
        Stb = transpose_blocks(Sb, part)
        Gb = _sym_graph_blocks(Sb, Stb)
        if aggressive:
            GG = dist_spgemm(Gb, Gb, params=params, strategy=strategy,
                             strategies=strategies, op="spgemm_S2",
                             level=l, records=records,
                             plan_cache=plevels[l].plans)
            Gb = _sym_graph_blocks(GG, transpose_blocks(GG, part))
        # w = (#strong transpose connections) + replicated random tiebreak —
        # every rank draws the same deterministic stream, as an SPMD code
        # would, so the splitting matches the host bit-for-bit
        rng_w = np.random.default_rng(seed + l).random(n)
        w_parts = [np.diff(Stb.blocks[d].indptr)[lo:hi].astype(np.float64)
                   + rng_w[lo:hi] for d, (lo, hi) in enumerate(ranges)]
        status = _dist_pmis(Gb, w_parts, part)
        n_c = sum(int((st == CPOINT).sum()) for st in status)
        if n_c in (0, n):
            break  # coarsening stalled
        # -- interpolation: per-block direct interpolation; C/F status and
        #    the fine→coarse map at halo columns come from vector gathers
        c_counts = [int((st == CPOINT).sum()) for st in status]
        c_offsets = np.concatenate([[0], np.cumsum(c_counts)])[:-1]
        cmap_parts = [np.cumsum(st == CPOINT) - 1 + c_offsets[d]
                      for d, st in enumerate(status)]
        P_blocks = []
        for d, (lo, hi) in enumerate(ranges):
            halo = Sb.blocks[d].offproc_columns(lo, hi, lo, hi)
            row_status = np.full(n, FPOINT, dtype=np.int64)
            row_status[lo:hi] = status[d]
            col_status = np.full(n, FPOINT, dtype=np.int64)
            col_status[lo:hi] = status[d]
            col_status[halo] = _gather(status, part, halo)
            col_cmap = np.zeros(n, dtype=np.int64)
            col_cmap[lo:hi] = cmap_parts[d]
            col_cmap[halo] = _gather(cmap_parts, part, halo)
            P_blocks.append(direct_interpolation(
                Ab.blocks[d], Sb.blocks[d], row_status,
                col_status=col_status, cmap=col_cmap, nc=n_c))
        Pb = BlockMatrix(P_blocks, part)
        cpart = Partition.balanced(n_c, topo)
        Rb = transpose_blocks(Pb, cpart)
        # -- Galerkin triple product: the two NAP matrix-row exchanges
        APb = dist_spgemm(Ab, Pb, params=params, strategy=strategy,
                          strategies=strategies, op="spgemm_AP",
                          level=l, records=records,
                          plan_cache=plevels[l].plans)
        Acb = dist_spgemm(Rb, APb, params=params, strategy=strategy,
                          strategies=strategies, op="spgemm_PtAP",
                          level=l, records=records,
                          plan_cache=plevels[l].plans)
        Acb = BlockMatrix([blk.prune(1e-14) for blk in Acb.blocks], cpart)
        plevels[l].P, plevels[l].R, plevels[l].AP = Pb, Rb, APb
        plevels[l].setup_seconds = time.perf_counter() - t0
        plevels.append(PartitionedLevel(A=Acb))
        # the stall check above guarantees 0 < n_c < n, so the Galerkin
        # coarse grid strictly shrinks — no host-style no-progress pop
        l += 1
    return plevels, records


def refresh_partitioned_values(
        plevels: list[PartitionedLevel], A_new: CSR, *,
        records: list | None = None) -> None:
    """Value-only refresh of a born-partitioned hierarchy onto ``A_new``.

    The caller guarantees ``A_new`` shares the fine level's sparsity
    pattern.  Everything structural is frozen — splittings, interpolation
    operators (values included), comm graphs and the per-level NAP
    schedules cached in :attr:`PartitionedLevel.plans` — and only the
    Galerkin products are replayed numerically: the row exchanges run
    through the already-selected :class:`MatrixHaloPlan` s, and each
    coarse product is projected onto the next level's frozen (pruned)
    pattern so every downstream lowering stays valid.
    """
    from .hierarchy import project_pattern_values

    fine = plevels[0].A
    new_blocks = split_rows(A_new, fine.part)
    for old, new in zip(fine.blocks, new_blocks.blocks):
        if old.data.shape != new.data.shape:
            raise ValueError(f"value refresh needs {old.data.shape[0]} "
                             f"values per block, got {new.data.shape[0]}")
        old.data[...] = new.data
    for l, (plv, nxt) in enumerate(zip(plevels[:-1], plevels[1:])):
        APb = dist_spgemm(plv.A, plv.P, op="spgemm_AP", level=l,
                          records=records, plan_cache=plv.plans)
        Acb = dist_spgemm(plv.R, APb, op="spgemm_PtAP", level=l,
                          records=records, plan_cache=plv.plans)
        for old, new in zip(plv.AP.blocks, APb.blocks):
            old.data[...] = project_pattern_values(
                new, old.indptr, old.indices, old.nrows, old.ncols)
        for old, new in zip(nxt.A.blocks, Acb.blocks):
            old.data[...] = project_pattern_values(
                new, old.indptr, old.indices, old.nrows, old.ncols)


def dist_setup(A: CSR, n_pods: int = 1, lanes: int = 1, *,
               solver: str = "rs", theta: float = 0.25,
               max_coarse: int = 100, max_levels: int = 25,
               aggressive: bool = False, prolongation_sweeps: int = 1,
               seed: int = 42, params: MachineParams = TPU_V5E,
               strategy: str = "auto",
               strategies: tuple[str, ...] = SETUP_STRATEGIES,
               dtype=None, device="cuda", use_kernel: bool | None = None,
               reduce_strategy: str = "nap3", overlap: bool = True):
    """Partitioned setup → :class:`~repro_torch.amg.dist_solve.DistHierarchy`.

    The whole pipeline from the partitioned fine-grid A to the lowered,
    solvable hierarchy runs without ever assembling a level operator on the
    host; per-level setup-phase strategy selections land in the hierarchy's
    ``selection_table()`` / ``setup_records``.  ``dtype`` is a torch dtype
    (float32 when ``None``); ``device`` is ``"cuda"`` unless the caller asks
    for the CPU.
    """
    import torch

    from .dist_solve import DistHierarchy

    plevels, records = dist_setup_partitioned(
        A, n_pods, lanes, solver=solver, theta=theta, max_coarse=max_coarse,
        max_levels=max_levels, aggressive=aggressive,
        prolongation_sweeps=prolongation_sweeps, seed=seed, params=params,
        strategy=strategy, strategies=strategies)
    return DistHierarchy.from_partitioned(
        plevels, n_pods, lanes, setup_records=records, params=params,
        strategy=strategy, dtype=torch.float32 if dtype is None else dtype,
        device=device, use_kernel=use_kernel,
        reduce_strategy=reduce_strategy, overlap=overlap)
