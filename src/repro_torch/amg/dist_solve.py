"""Device-resident distributed AMG solve phase on rank-stacked tensors
(PyTorch port of :mod:`repro.amg.dist_solve`).

At :meth:`DistHierarchy.build` time, for every level ℓ and every solve-phase
operator — ``A_ℓ`` (smoother sweeps + residual), ``P_ℓ`` (interpolation) and
``R_ℓ`` (restriction) — the host lowering (a numpy copy of the reference's
``_lower_levels``) builds the operator's communication graph, picks
standard / NAP-2 / NAP-3 from the max-rate models of Eqs. (4)–(6), and builds
a :class:`~repro_torch.amg.dist_spmv.DistOperator` for the winner.  The level
arrays then move to the device once.  :meth:`DistHierarchy.from_partitioned`
lowers the born-partitioned levels of :mod:`repro_torch.amg.dist_setup` the
same way, straight from each rank's row block, with no host ``Hierarchy``.

Execution runs all D = ``n_pods × lanes`` ranks in one process with the rank
as the leading tensor dim (pod-major, the reference's device order).  The
reference's ten fused ``shard_map`` programs (``cycle``, ``vcycle``,
``pcg_init``, ``pcg_step``, ``resid_norm`` and their ``*_m`` multi-RHS twins)
have their eager bodies here as methods: every SpMV is one
:meth:`~repro_torch.amg.dist_spmv.DistOperator.apply` (halo exchange on a
side stream + one kernel launch for all ranks), dots and norms go through
:func:`~repro_torch.core.nap_collectives.hier_psum`, and the coarsest level
gathers its residual with ``hier_all_gather`` and applies the dense
pseudo-inverse with ``torch.matmul``.  The drivers run them through
:attr:`DistHierarchy.programs` (:mod:`.programs`): on the card each program
call is one replay of a captured CUDA graph over static buffers.  Only the
convergence check touches the host: one residual norm per outer iteration.

**One process per rank** (``AMGConfig(ranks="process")``,
:meth:`DistHierarchy.scattered`): rank 0 runs the host setup and the
lowering once and hands each process its ``[d:d+1]`` slice of every stacked
array (:meth:`DistLevel.rank_slice`); the hierarchy's ``ranks``, a
:class:`~repro_torch.core.nap_collectives.RankGroups`, takes the role of the
reference's ``mesh=`` and turns every exchange, dot and coarse gather into
collectives between the processes.  The same bodies run on a leading rank
dim of size 1, uncaptured (:mod:`.programs`).  The block smoothers, the
refresh and the partitioned setup are not ported to this mode yet
(ROADMAP item 12).

The block smoothers (``block_jacobi``, ``hybrid_gs``, ``hybrid_gs_sym``)
apply ``x + w·M⁻¹(b − A x)`` on the halo'd residual as the reference does,
but where the reference lowers ``M⁻¹`` to a dense ``[D, m, m]`` factor
(``DistLevel.smoother_minv``) the port keeps it sparse
(:meth:`DistLevel.smoother_factor`): the bs×bs block inverses, or each
rank's lower / upper triangle of its local square block, applied by the
``block_diag_apply`` and ``tri_solve`` kernels
(:mod:`repro_torch.kernels.smoother`).

The compute dtype is float64, float32 or bfloat16 (:data:`DTYPES`).  A
bfloat16 hierarchy lowers its value planes, ``dinv``, ``cinv`` and the
block smoothers' factors to bfloat16 as the reference's
``astype(jnp.bfloat16)`` does, and runs dots,
norms and the coarse ``cinv @ x`` in bfloat16; only the local products
and the block smoothers' applies sum in float32 (their kernels round once),
and ``tri_solve`` keeps its solution in float32 between level sets.  One
process per rank scatters the float32 staging of the lowering; each rank
rounds its slice on its own device.

:meth:`DistHierarchy.refresh_values` takes a value-only update beneath the
captured graphs: every value plane is copied into the tensor already in
place (the block smoothers' factors too), and only the Chebyshev programs,
which bake ρ in, are captured anew.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import Counter

import numpy as np
import torch

from ..core.nap_collectives import (PROCESS_TODO, gather_signature,
                                    halo_signature, hier_all_gather,
                                    hier_psum, reduce_signature)
from ..core.perf_model import (TPU_V5E, MachineParams, overlap_efficiency,
                               spmv_compute_times)
from ..core.selector import select
from ..core.topology import Partition, Topology
from ..device import resolve_device
from ..kernels.smoother.ops import place_factor
from ..kernels.spmv.ops import select_dist_kernel
from .csr import CSR
from .dist import rect_vector_graph, schedule_comm_stats
from .dist_spmv import (DistOperator, build_dist_operator,
                        build_dist_operator_from_blocks, copy_into,
                        local_square_block)
from .hierarchy import Hierarchy
from .interpolation import estimate_rho_DinvA
from .programs import ProgramCache
from .smoothers import chebyshev_coeffs, chebyshev_recurrence
from .solve import (CYCLE_CHILDREN, MultiSolveResult, SolveOptions,
                    SolveResult, level_visits)

SOLVE_STRATEGIES = ("standard", "nap2", "nap3")
# compute dtypes the kernels take, and the numpy dtype each lowers and
# stages with: numpy has no bfloat16, so a bfloat16 lowering stages its
# value planes in float32 and rounds them once on their way to the device
# (float64 -> float32 -> bfloat16, the conversion the reference's
# ``astype(jnp.bfloat16)`` makes too)
DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
          torch.bfloat16: np.float32}


@dataclasses.dataclass
class DistLevel:
    """Device form of one hierarchy level: operators + smoother data."""

    A: DistOperator
    dinv: np.ndarray                     # [D, rows_local] (0 on padded rows)
    P: DistOperator | None = None        # fine rows × coarse cols
    R: DistOperator | None = None        # coarse rows × fine cols
    rho: float = 1.0                     # ρ(D⁻¹A) for Chebyshev
    coarse_inv: np.ndarray | None = None  # [D, rows_local, D*rows_local]
    strategies: dict[str, str] = dataclasses.field(default_factory=dict)
    modeled: dict[str, dict[str, float]] = dataclasses.field(default_factory=dict)
    # local-kernel layout decision for A (select_dist_kernel dict)
    local_kernel: dict = dataclasses.field(default_factory=dict)
    # per-op modeled message/byte counts for the selected strategy
    comm_stats: dict[str, dict] = dataclasses.field(default_factory=dict)
    # on/off-process split of A (nnz counts, modeled t_on/t_off/t_comm)
    onoff: dict = dataclasses.field(default_factory=dict)
    # (A, row partition, rank count) the block smoothers' factors are cut
    # from (None on the coarsest level, which never smooths)
    local_src: tuple | None = None
    _local_A: list | None = dataclasses.field(default=None, repr=False)
    _factor_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def local_A(self) -> list[CSR]:
        """Per-rank diagonal square blocks of A (local column ids), the
        reference's ``local_A``; cut on first use, so a level no block
        smoother reads never pays for them."""
        if self._local_A is None:
            assert self.local_src is not None, "no local blocks on this level"
            self._local_A = _local_blocks(*self.local_src)
        return self._local_A

    def set_source(self, A, part: Partition, D: int,
                   local_A: list | None = None,
                   factors: dict | None = None) -> None:
        """Point the level's smoother factors at ``A`` (a refresh): the
        cached blocks and factors are dropped, or replaced by ``local_A``
        and ``factors`` ((kind, block size) -> host factor) already cut
        from it."""
        self.local_src = (A, part, D)
        self._local_A = local_A
        self._factor_cache = dict(factors or {})

    def rank_slice(self, d: int) -> "DistLevel":
        """Rank ``d``'s part of the level (one process per rank): its
        operators' :meth:`~repro_torch.amg.dist_spmv.DistOperator.rank_slice`,
        its ``[d:d+1]`` rows of ``dinv`` and ``coarse_inv``, the selection
        tables whole, and no source for the block smoothers' factors."""
        def op(o):
            return None if o is None else o.rank_slice(d)

        return dataclasses.replace(
            self, A=op(self.A), P=op(self.P), R=op(self.R),
            dinv=self.dinv[d:d + 1].copy(),
            coarse_inv=(None if self.coarse_inv is None
                        else self.coarse_inv[d:d + 1].copy()),
            local_src=None, _local_A=None, _factor_cache={})

    def smoother_factor(self, kind: str, block_size: int = 0) -> dict:
        """The sparse smoother factor of ``kind`` on the host (numpy; the
        counterpart of the reference's dense ``smoother_minv``, cached the
        same way).

        ``kind="bj"``: ``binv`` ``[D, nb, bs, bs]``, the inverses of the
        ``block_size`` diagonal blocks of each rank's local block (the grid
        restarting at the rank's first row; padded rows an identity block).
        ``kind="gs"`` / ``"gsu"``: the local (D + L) / (D + U) factor, its
        strict triangle in ELL (``cols`` int32 / ``vals`` ``[D, m, K]``,
        columns ascending, -1 padding) and its diagonal ``diag`` ``[D, m]``.
        Zero or padded diagonals become 1 in every kind, as in the
        reference.
        """
        key = (kind, block_size)
        got = self._factor_cache.get(key)
        if got is None:
            got = _host_factor(self.local_A, self.A.rows_local, kind,
                               block_size)
            self._factor_cache[key] = got
        return got


class FactorPatternChanged(ValueError):
    """A refreshed smoother factor's pattern differs from the one placed
    (and captured): its values cannot be copied in place."""


def _local_blocks(A, part: Partition, D: int) -> list[CSR]:
    return [local_square_block(A, part, q) for q in range(D)]


def _host_factor(blocks: list[CSR], m: int, kind: str,
                 block_size: int) -> dict:
    """The host factor of ``kind`` over the rank blocks ``blocks``."""
    if kind == "bj":
        return {"kind": kind, "binv": _block_inverses(blocks, m, block_size)}
    if kind in ("gs", "gsu"):
        return {"kind": kind, "upper": kind == "gsu",
                **_triangle(blocks, m, upper=kind == "gsu")}
    raise ValueError(f"unknown smoother factor kind {kind!r}")


def _block_inverses(blocks: list[CSR], m: int, bs: int) -> np.ndarray:
    """``[D, ceil(m / bs), bs, bs]`` inverses of each rank's bs×bs diagonal
    blocks (float64); a zero diagonal (padded rows, rows past ``m`` in the
    last block) becomes 1."""
    nb = -(-m // bs)
    dense = np.zeros((len(blocks), nb, bs, bs))
    for d, blk in enumerate(blocks):
        r, c = blk.rows_expanded(), blk.indices
        same = r // bs == c // bs
        r, c = r[same], c[same]
        dense[d, r // bs, r % bs, c % bs] = blk.data[same]
    ii = np.arange(bs)
    diag = dense[..., ii, ii]
    dense[..., ii, ii] = np.where(diag == 0, 1.0, diag)
    return np.linalg.inv(dense)


def _triangle(blocks: list[CSR], m: int, upper: bool) -> dict:
    """Each rank's strict lower (upper) triangle as rank-stacked ELL, its
    columns ascending within a row, and its diagonal (1 where it is 0 or
    the row is padding)."""
    D = len(blocks)
    diag = np.ones((D, m))
    parts = []
    for d, blk in enumerate(blocks):
        r, c, v = blk.rows_expanded(), blk.indices, blk.data
        on = r == c
        diag[d, r[on]] = np.where(v[on] == 0, 1.0, v[on])
        keep = c > r if upper else c < r
        parts.append((r[keep], c[keep], v[keep]))
    K = max((int(np.bincount(r).max(initial=0)) for r, _, _ in parts),
            default=0)
    cols = np.full((D, m, K), -1, dtype=np.int32)
    vals = np.zeros((D, m, K))
    for d, (r, c, v) in enumerate(parts):
        # CSR order: rows ascending, columns ascending within a row
        start = np.searchsorted(r, r, side="left")
        slot = np.arange(r.size) - start
        cols[d, r, slot] = c
        vals[d, r, slot] = v
    return {"cols": cols, "vals": vals, "diag": diag}


# the sparse factors each block smoother applies: run-array name -> kind
_FACTOR_ARRS = {"bj": (("minv", "bj"),),
                "gs": (("minv", "gs"),),
                "gs_sym": (("minv", "gs"), ("minv_u", "gsu"))}


def smoother_arrays_key(opts) -> tuple | None:
    """Key of the factors ``opts``'s smoother reads (the reference's
    ``_smoother_arrs_key``; a key of :data:`_FACTOR_ARRS` and a block
    size): ``None`` for Jacobi and Chebyshev, which run on the base arrays;
    ``block_size`` counts for block-Jacobi only."""
    if opts.smoother == "block_jacobi":
        return ("bj", opts.block_size)
    if opts.smoother == "hybrid_gs":
        return ("gs", 0)
    if opts.smoother == "hybrid_gs_sym":
        return ("gs_sym", 0)
    return None


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"dtype {dtype} is not ported yet; the kernels take "
            f"torch.float32, torch.float64 and torch.bfloat16")


def _staged(host: dict, dtype: torch.dtype) -> dict:
    """The host smoother factor ``host`` with its float64 values in
    ``dtype``'s staging type (:data:`DTYPES`), the rounding the value planes
    take: a bfloat16 factor's values go float64 -> float32 -> bfloat16."""
    return {k: (v.astype(DTYPES[dtype]) if getattr(v, "dtype", None)
                == np.float64 else v) for k, v in host.items()}


def _rank_dinv(A, part: Partition, D: int) -> np.ndarray:
    """``1 / diag(A)`` (1 where the diagonal is 0) as ``[D, rows_local]``,
    0 on padded rows.  ``A`` is a global CSR or a born-partitioned
    :class:`~repro_torch.amg.dist_setup.BlockMatrix`."""
    d = A.diagonal()
    dinv = 1.0 / np.where(d == 0, 1.0, d)
    out = np.zeros((D, part.max_local_size), dtype=np.float64)
    for q in range(D):
        lo, hi = part.local_range(q)
        out[q, : hi - lo] = dinv[lo:hi]
    return out


def _rank_pinv(A, part: Partition, D: int) -> np.ndarray:
    """The coarsest level's dense pseudo-inverse, each rank's rows against
    the rank-stacked gathered vector: ``[D, rows_local, D * rows_local]``."""
    pinv = np.linalg.pinv(A.to_dense())
    m = part.max_local_size
    cinv = np.zeros((D, m, D * m), dtype=np.float64)
    for q in range(D):
        lo, hi = part.local_range(q)
        for e in range(D):
            elo, ehi = part.local_range(e)
            cinv[q, : hi - lo, e * m: e * m + ehi - elo] = pinv[lo:hi, elo:ehi]
    return cinv


class DistHierarchy:
    """An AMG hierarchy lowered onto a (pods × lanes) rank grid, its arrays
    resident on one device.  Built once per hierarchy and reusable across
    any number of :func:`dist_solve` / :func:`dist_pcg` calls.

    ``comm_log``: set it to a list to record, in order, the canonical name
    of every collective step the programs run (``None``, the default,
    records nothing).

    ``programs`` holds the compiled form of the ten programs
    (:class:`~repro_torch.amg.programs.ProgramCache`); ``lock`` serialises
    the solves on this hierarchy, whose programs share static buffers.

    ``ranks`` (one process per rank, :meth:`scattered`) is this process's
    :class:`~repro_torch.core.nap_collectives.RankGroups`; ``levels`` then
    hold its own rank's slices and every tensor a leading rank dim of 1.
    """

    def __init__(self, h: Hierarchy | None, n_pods: int, lanes: int,
                 levels: list[DistLevel], dtype: torch.dtype,
                 device: torch.device, use_kernel: bool,
                 reduce_strategy: str, overlap: bool, ranks=None):
        # ``h`` is None when the hierarchy was born partitioned
        # (:mod:`repro_torch.amg.dist_setup`): no host Hierarchy ever existed
        self.h = h
        # the partitioned setup's SpGEMM exchange records (from_partitioned)
        self.setup_records: list = []
        self.n_pods, self.lanes = n_pods, lanes
        self.levels = levels
        self.dtype = dtype
        self.device = device
        self.use_kernel = use_kernel
        self.reduce_strategy = reduce_strategy
        # True: every apply is A_on·x + A_off·halo; False: the fused serial
        # form A·[x | halo]
        self.overlap = overlap
        self.ranks = ranks
        self.comm_log: list | None = None
        # each operator's tally label: (level, "A" | "P" | "R")
        self._tags = {id(op): (l, name) for l, dl in enumerate(levels)
                      for name in ("A", "P", "R")
                      if (op := getattr(dl, name)) is not None}
        # seconds of the one-process-per-rank setup (see scattered)
        self.timings: dict[str, float] = {}
        # level arrays, moved to the device once at build time; a refresh
        # copies into these tensors, never rebinds them
        self._arrs = [self._level_arrays(lv) for lv in levels]
        # the block smoothers' device factors by (level, kind, block size),
        # placed on first use and shared by every option set that reads
        # them; the per-level run arrays of each smoother key
        self._factors: dict[tuple, object] = {}
        self._arrs_ex: dict[tuple, list[dict]] = {}
        # the stream each split apply's halo exchange runs on (card only;
        # not one process per rank, where a host-staged collective
        # synchronises anyway)
        self._side = (torch.cuda.Stream(device)
                      if device.type == "cuda" and ranks is None else None)
        self.programs = ProgramCache(self)
        self.lock = threading.RLock()

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, h: Hierarchy, n_pods: int, lanes: int, *,
              params: MachineParams = TPU_V5E,
              strategy: str = "auto",
              strategies: tuple[str, ...] = SOLVE_STRATEGIES,
              dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cuda",
              use_kernel: bool | None = None,
              reduce_strategy: str = "nap3",
              overlap: bool = True) -> "DistHierarchy":
        """Lower ``h`` onto the rank grid, selecting each operator's strategy.

        ``strategy="auto"`` picks per level and per operator from the
        performance models; any explicit strategy name forces it everywhere.
        ``use_kernel=None``/``True`` routes every local product through the
        kernel wrappers (the CUDA kernels on a CUDA device, their plain
        versions on the CPU); ``False`` takes the plain versions explicitly.
        """
        return cls._lowered(h, h.levels, n_pods, lanes, params=params,
                            strategy=strategy, strategies=strategies,
                            dtype=dtype, device=device, use_kernel=use_kernel,
                            reduce_strategy=reduce_strategy, overlap=overlap)

    @classmethod
    def from_partitioned(cls, plevels, n_pods: int, lanes: int, *,
                         setup_records=None,
                         params: MachineParams = TPU_V5E,
                         strategy: str = "auto",
                         strategies: tuple[str, ...] = SOLVE_STRATEGIES,
                         dtype: torch.dtype = torch.float32,
                         device: str | torch.device = "cuda",
                         use_kernel: bool | None = None,
                         reduce_strategy: str = "nap3",
                         overlap: bool = True) -> "DistHierarchy":
        """Lower levels that are **already partitioned** (born on the rank
        grid; port of the reference's).

        ``plevels`` mirror :class:`~repro_torch.amg.hierarchy.Level` but each
        operator is a :class:`~repro_torch.amg.dist_setup.BlockMatrix`
        (per-rank global-shape row blocks), the output of the partitioned
        setup.  No host gather/re-scatter happens between setup and solve;
        ``setup_records`` (per-level SpGEMM strategy selections and measured
        exchange counters) are merged into the selection table and kept as
        :attr:`setup_records`.
        """
        self = cls._lowered(None, plevels, n_pods, lanes, params=params,
                            strategy=strategy, strategies=strategies,
                            dtype=dtype, device=device, use_kernel=use_kernel,
                            reduce_strategy=reduce_strategy, overlap=overlap)
        for rec in setup_records or ():
            self.levels[rec.level].strategies[rec.op] = rec.strategy
            self.levels[rec.level].modeled[rec.op] = dict(rec.modeled)
        self.setup_records = list(setup_records or ())
        return self

    @classmethod
    def scattered(cls, h: Hierarchy | None, ranks, *,
                  params: MachineParams = TPU_V5E,
                  strategy: str = "auto",
                  strategies: tuple[str, ...] = SOLVE_STRATEGIES,
                  dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda",
                  use_kernel: bool | None = None,
                  reduce_strategy: str = "nap3",
                  overlap: bool = True) -> "DistHierarchy":
        """One process per rank: rank 0 lowers ``h`` (``None`` on the other
        ranks) once, as :meth:`build` does, and every rank receives its own
        slice of the lowering through ``ranks``; the arrays then move to
        this rank's device (:meth:`RankGroups.device
        <repro_torch.core.nap_collectives.RankGroups.device>`).  The slices
        travel in their numpy staging type (:data:`DTYPES`: float32 for a
        bfloat16 lowering, which numpy lacks) and each rank rounds its own
        on its device, as a stacked lowering does.
        :attr:`timings` holds rank 0's ``lower_s`` and this rank's
        ``scatter_s`` (on the other ranks the wait for rank 0 included)."""
        _check_dtype(dtype)
        n_pods, lanes = ranks.n_pods, ranks.lanes
        device = ranks.device(device)
        t0 = time.perf_counter()
        slices = None
        if ranks.rank == 0:
            levels = cls._lower_levels(h.levels, n_pods, lanes, params=params,
                                       strategy=strategy,
                                       strategies=strategies,
                                       dtype=DTYPES[dtype])
            slices = [[lv.rank_slice(d) for lv in levels]
                      for d in range(ranks.size)]
        t1 = time.perf_counter()
        mine = ranks.scatter_objects(slices)
        t2 = time.perf_counter()
        self = cls(None, n_pods, lanes, mine, dtype, device,
                   True if use_kernel is None else bool(use_kernel),
                   reduce_strategy, bool(overlap), ranks=ranks)
        self.timings = {"lower_s": t1 - t0, "scatter_s": t2 - t1}
        return self

    @classmethod
    def _lowered(cls, h, src_levels, n_pods: int, lanes: int, *, params,
                 strategy, strategies, dtype, device, use_kernel,
                 reduce_strategy, overlap) -> "DistHierarchy":
        """:meth:`build` and :meth:`from_partitioned`'s shared tail: lower
        ``src_levels`` and place them on ``device``."""
        _check_dtype(dtype)
        device = resolve_device(device)
        levels = cls._lower_levels(src_levels, n_pods, lanes, params=params,
                                   strategy=strategy, strategies=strategies,
                                   dtype=DTYPES[dtype])
        return cls(h, n_pods, lanes, levels, dtype, device,
                   True if use_kernel is None else bool(use_kernel),
                   reduce_strategy, bool(overlap))

    @classmethod
    def _lower_levels(cls, src_levels, n_pods: int, lanes: int, *, params,
                      strategy, strategies, dtype) -> list[DistLevel]:
        """Per-level lowering (numpy copy of the reference's), shared by
        :meth:`build` (host ``Level`` s with global CSRs) and
        :meth:`from_partitioned` (``BlockMatrix`` levels): comm graphs,
        strategy selection, halo plans, ELL blocks, optional BCSR."""
        topo = Topology(n_nodes=n_pods, ppn=lanes)
        D = topo.n_procs

        def choose(graph, op_name, compute=(0.0, 0.0)):
            # ``compute=(t_on, t_off)`` makes the ranking overlap-aware:
            # max(T_comm, T_on) + T_off — zero (the default, and always when
            # params.Rf is unset) reduces to the serial comm-only model
            if strategy != "auto":
                return strategy, {}, {}
            sel = select(graph, params, strategies, compute=compute)
            return sel.strategy, dict(sel.times), dict(sel.comm_times)

        def make_op(M, strat, row_part, col_part, graph):
            blocks = getattr(M, "blocks", None)
            if blocks is not None:
                return build_dist_operator_from_blocks(
                    blocks, n_pods, lanes, strat, row_part=row_part,
                    col_part=col_part, graph=graph, dtype=dtype)
            return build_dist_operator(M, n_pods, lanes, strat,
                                       row_part=row_part, col_part=col_part,
                                       graph=graph, dtype=dtype)

        def part_of(lv):
            # a BlockMatrix level carries the partition its blocks were
            # built on — reuse it rather than assuming balanced rows
            p = getattr(lv.A, "part", None)
            if p is not None:
                assert p.topo == topo, (p.topo, topo)
                return p
            return Partition.balanced(lv.A.nrows, topo)

        def onoff_compute(M, row_part, col_part):
            """Per-device max on/off nnz → modeled (t_on, t_off) split."""
            on_max = off_max = 0
            for q in range(D):
                rlo, rhi = row_part.local_range(q)
                clo, chi = col_part.local_range(q)
                sub = M.submatrix_rows(rlo, rhi)
                on = int(((sub.indices >= clo) & (sub.indices < chi)).sum())
                on_max = max(on_max, on)
                off_max = max(off_max, sub.nnz - on)
            return spmv_compute_times(params, on_max, off_max)

        parts = [part_of(lv) for lv in src_levels]
        levels: list[DistLevel] = []
        for l, lv in enumerate(src_levels):
            part = parts[l]
            gA = rect_vector_graph(lv.A, part, part)
            compA = onoff_compute(lv.A, part, part)
            sA, tA, cA = choose(gA, "spmv_A", compA)
            Aop = make_op(lv.A, sA, part, part, gA)
            # per-level local-kernel layout: ELL gather vs dense-block BCSR
            # (A only; the coarsest A never runs a SpMV, its solve is dense)
            sel = select_dist_kernel(Aop.ell_cols)
            if sel["kernel"] == "bcsr" and l + 1 < len(src_levels):
                Aop.lower_bcsr(sel["block_size"])
            else:
                sel = dict(sel, kernel="ell", block_size=0)
            dl = DistLevel(A=Aop, dinv=_rank_dinv(lv.A, part, D),
                           strategies={"spmv_A": sA},
                           modeled={"spmv_A": tA},
                           local_kernel=sel)
            dl.comm_stats["spmv_A"] = schedule_comm_stats(gA, sA)
            nnz = Aop.onoff_nnz()
            t_on, t_off = compA
            t_comm = cA.get(sA, 0.0)
            dl.onoff = {**nnz, "local_nnz": nnz["on_nnz"] + nnz["off_nnz"],
                        "halo_empty": Aop.halo_empty,
                        "t_on": t_on, "t_off": t_off, "t_comm": t_comm,
                        "eff_modeled": overlap_efficiency(t_comm, t_on, t_off)}
            if lv.P is not None and l + 1 < len(src_levels):
                cpart = parts[l + 1]
                gP = rect_vector_graph(lv.P, part, cpart)
                sP, tP, _ = choose(gP, "interp",
                                   onoff_compute(lv.P, part, cpart))
                dl.P = make_op(lv.P, sP, part, cpart, gP)
                gR = rect_vector_graph(lv.R, cpart, part)
                sR, tR, _ = choose(gR, "restrict",
                                   onoff_compute(lv.R, cpart, part))
                dl.R = make_op(lv.R, sR, cpart, part, gR)
                dl.rho = estimate_rho_DinvA(lv.A)
                dl.strategies.update(interp=sP, restrict=sR)
                dl.modeled.update(interp=tP, restrict=tR)
                dl.comm_stats["interp"] = schedule_comm_stats(gP, sP)
                dl.comm_stats["restrict"] = schedule_comm_stats(gR, sR)
                dl.set_source(lv.A, part, D)
            else:
                if lv.P is not None:
                    raise ValueError(
                        f"level {l} has P but no coarser level (coarsening "
                        f"stalled); refusing the dense coarse solve at "
                        f"n={lv.A.nrows}")
                # coarsest: distributed dense pseudo-inverse solve
                dl.coarse_inv = _rank_pinv(lv.A, part, D)
            levels.append(dl)
        return levels

    # ------------------------------------------------------------- reporting
    def selection_table(self) -> list[dict]:
        """One row per (level, op): chosen strategy + modeled seconds."""
        rows = []
        for l, dl in enumerate(self.levels):
            for op, s in dl.strategies.items():
                rows.append({"level": l, "op": op, "strategy": s,
                             "modeled": dict(dl.modeled.get(op, {}))})
        return rows

    def kernel_table(self) -> list[dict]:
        """One row per level: the local-kernel layout that runs for A."""
        return [{"level": l, "kernel": dl.A.local_kernel,
                 "block_size": dl.A.block_size,
                 "rows_local": dl.A.rows_local,
                 "halo_empty": dl.A.halo_empty}
                for l, dl in enumerate(self.levels)]

    @property
    def local_ranks(self) -> int:
        """The ranks this process holds: all D stacked, or its own one."""
        return 1 if self.ranks is not None else self.n_pods * self.lanes

    @property
    def nbytes(self) -> int:
        """Device bytes this lowering holds: its level tensors, the block
        smoothers' factors placed so far, the programs' state buffers and
        the captured graphs' memory pool."""
        levels = sum(t.numel() * t.element_size()
                     for a in self._arrs for v in a.values()
                     for t in (v.values() if isinstance(v, dict) else (v,)))
        return int(levels + self.factor_bytes() + self.programs.state_bytes()
                   + self.programs.pool_bytes())

    def factor_bytes(self) -> int:
        """Device bytes of the block smoothers' factors placed so far."""
        return sum(t.numel() * t.element_size()
                   for f in self._factors.values() for t in f.tensors())

    # ----------------------------------------------------- streaming refresh
    def refresh_values(self, src_levels) -> None:
        """Value-only refresh onto the frozen lowered layouts (port of the
        reference's, dist_solve.py:437-501).

        ``src_levels`` are the refreshed source levels — host ``Level`` s or
        partitioned ``BlockMatrix`` levels, the two shapes
        :meth:`_lower_levels` takes — whose sparsity patterns must match what
        this hierarchy was lowered from.  Every
        structural artifact — comm graphs, strategies, halo plans, ELL/BCSR
        column maps — is reused; value planes, diagonals, Chebyshev bounds
        and the coarse pseudo-inverse are recomputed on the host and copied
        into the device tensors already in place, so captured graphs read
        the new values on their next replay.  The Chebyshev programs bake
        ``chebyshev_coeffs(rho)`` in as constants and are dropped, as the
        reference drops its Chebyshev programs; the Jacobi ones and the
        block smoothers' stay, the factors placed so far recomputed on the
        host and copied into the placed tensors (the reference's
        ``_arrs_ex`` refresh, dist_solve.py:470-500).  A triangle whose
        pattern moved raises :class:`FactorPatternChanged` before anything
        is copied; the session escalates to a re-setup.
        """
        def block_of(M):
            blocks = getattr(M, "blocks", None)
            if blocks is not None:
                return lambda d: blocks[d]
            return lambda d: M

        if self.ranks is not None:
            raise NotImplementedError(f"the value refresh {PROCESS_TODO}")
        D = self.n_pods * self.lanes
        src_levels = list(src_levels)
        with self.lock:
            # the placed factors' new values, cut before anything changes
            # (only levels with a placed factor cut their local blocks): a
            # triangle whose pattern moved cannot be copied in place
            blocks: dict[int, list] = {}
            fresh: dict[int, dict] = {}
            for (l, kind, bs), f in self._factors.items():
                dl = self.levels[l]
                if l not in blocks:
                    blocks[l] = _local_blocks(src_levels[l].A,
                                              dl.A.row_part, D)
                host = _host_factor(blocks[l], dl.A.rows_local, kind, bs)
                if "cols" in host and not np.array_equal(host["cols"],
                                                         f.host_cols):
                    raise FactorPatternChanged(
                        f"level {l}'s {kind} triangle changed its pattern")
                fresh.setdefault(l, {})[(kind, bs)] = host
            for l, (lv, dl) in enumerate(zip(src_levels, self.levels)):
                part = dl.A.row_part
                dl.A.refresh_values(block_of(lv.A))
                dl.dinv = _rank_dinv(lv.A, part, D)
                if dl.P is not None:
                    dl.P.refresh_values(block_of(lv.P))
                    dl.R.refresh_values(block_of(lv.R))
                    dl.rho = estimate_rho_DinvA(lv.A)
                    dl.set_source(lv.A, part, D, blocks.get(l), fresh.get(l))
                else:
                    dl.coarse_inv = _rank_pinv(lv.A, part, D)
            for dl, a in zip(self.levels, self._arrs):
                dl.A.copy_values(a["A"], self.dtype)
                copy_into(a["dinv"], dl.dinv, self.dtype, "dinv")
                if dl.P is not None:
                    dl.P.copy_values(a["P"], self.dtype)
                    dl.R.copy_values(a["R"], self.dtype)
                if dl.coarse_inv is not None:
                    copy_into(a["cinv"], dl.coarse_inv, self.dtype, "cinv")
            for (l, kind, bs), f in self._factors.items():
                host = fresh[l][(kind, bs)]
                for name in f.VALUES:
                    copy_into(getattr(f, name),
                              host[name].astype(DTYPES[self.dtype]),
                              self.dtype, name)
                f.sync_values()
            self.programs.drop(lambda key: key.smoother == "chebyshev")

    # ----------------------------------------------------------- host layout
    def scatter(self, x: np.ndarray, level: int = 0) -> torch.Tensor:
        """Global ``[n(, k)]`` → rank-stacked ``[D, local(, k)]`` on device
        (one process per rank: its own ``[1, local(, k)]``)."""
        arr = self.levels[level].A.scatter_x(np.asarray(x),
                                             dtype=DTYPES[self.dtype])
        return torch.from_numpy(arr).to(device=self.device, dtype=self.dtype)

    def gather(self, x_dev: torch.Tensor, level: int = 0) -> np.ndarray:
        """Rank-stacked ``[D, local(, k)]`` → global ``[n(, k)]``; one
        process per rank gathers every rank's rows first, so every rank
        returns the whole vector."""
        if self.ranks is not None:
            x_dev = self.ranks.all_gather(x_dev[0], "world", tag=("gather",))
        return self.levels[level].A.gather_y(_numpy(x_dev))

    def load(self, buf: torch.Tensor, x: np.ndarray) -> None:
        """Global ``[n(, k)]`` → the rank-stacked buffer ``buf`` in place
        (one host-to-device copy)."""
        buf.copy_(torch.from_numpy(self.levels[0].A.scatter_x(
            np.asarray(x), dtype=DTYPES[self.dtype])))

    # --------------------------------------------------------- device pieces
    def _level_arrays(self, dl: DistLevel) -> dict:
        dev, dt = self.device, self.dtype
        a = {"A": dl.A.to_device(dev, dt),
             "dinv": torch.as_tensor(dl.dinv).to(device=dev, dtype=dt)}
        if dl.P is not None:
            a["P"] = dl.P.to_device(dev, dt)
            a["R"] = dl.R.to_device(dev, dt)
        if dl.coarse_inv is not None:
            a["cinv"] = torch.as_tensor(dl.coarse_inv).to(device=dev, dtype=dt)
        return a

    def _factor(self, level: int, kind: str, block_size: int):
        """The device factor of ``kind`` at ``level``, placed on first use."""
        key = (level, kind, block_size)
        f = self._factors.get(key)
        if f is None:
            f = place_factor(_staged(self.levels[level].smoother_factor(
                kind, block_size), self.dtype), self.device, self.dtype)
            self._factors[key] = f
        return f

    smoother_arrays_key = staticmethod(smoother_arrays_key)

    def run_arrays(self, opts) -> list[dict]:
        """Per-level device arrays for one option set (the reference's
        ``run_arrays``).

        Jacobi and Chebyshev run on the base arrays; a block smoother's are
        the base dicts extended with its sparse factors (``minv``, and
        ``minv_u`` for the backward half-sweep), each placed once per
        (level, kind, block size) and shared by reference across option
        sets, as the base tensors are.
        """
        key = smoother_arrays_key(opts)
        if key is None:
            return self._arrs
        if self.ranks is not None:
            raise NotImplementedError(f"smoother {opts.smoother!r} "
                                      f"{PROCESS_TODO}")
        got = self._arrs_ex.get(key)
        if got is None:
            got = []
            for l, (dl, base) in enumerate(zip(self.levels, self._arrs)):
                a = dict(base)
                if dl.coarse_inv is None:
                    for name, kind in _FACTOR_ARRS[key[0]]:
                        a[name] = self._factor(l, kind, key[1])
                got.append(a)
            self._arrs_ex[key] = got
        return got

    def _between_ranks(self, tag) -> dict:
        """The keywords that run a collective between the processes, with
        ``tag`` labelling its tally (none on stacked ranks, whose calls
        stay as they were)."""
        return {} if self.ranks is None else {"ranks": self.ranks, "tag": tag}

    def _spmv(self, op: DistOperator, arrs: dict, x: torch.Tensor):
        return op.apply(arrs, x, use_kernel=self.use_kernel,
                        overlap=self.overlap, log=self.comm_log,
                        side=self._side,
                        **self._between_ranks(self._tags.get(id(op))))

    def _pdot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per-rank replicated dot: ``[D]`` for ``[D, n]`` operands, per
        column ``[D, k]`` for ``[D, n, k]``."""
        return hier_psum((a * b).sum(dim=1), self.n_pods, self.lanes,
                         strategy=self.reduce_strategy, log=self.comm_log,
                         **self._between_ranks(("dot",)))

    def _pnorm(self, r: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self._pdot(r, r))

    def _relax(self, dl: DistLevel, arrs: dict, x, b, opts, sweeps: int):
        if sweeps == 0:
            return x
        aA = arrs["A"]
        dinv = arrs["dinv"]
        if x.ndim == 3:                  # [D, local, k]: broadcast over RHS
            dinv = dinv[..., None]
        if opts.smoother == "jacobi":
            for _ in range(sweeps):
                x = x + opts.omega * dinv * (b - self._spmv(dl.A, aA, x))
            return x
        if opts.smoother in ("block_jacobi", "hybrid_gs"):
            # x += w · M⁻¹ (b − A x): the halo'd residual carries every
            # off-rank coupling, the local factor does the rest
            minv = arrs["minv"]
            w = opts.omega if opts.smoother == "block_jacobi" else 1.0
            for _ in range(sweeps):
                x = minv.apply(b - self._spmv(dl.A, aA, x), x, w,
                               self.use_kernel)
            return x
        if opts.smoother == "hybrid_gs_sym":
            # forward (D+L)⁻¹ then backward (D+U)⁻¹ half-sweep, each on a
            # freshly halo'd residual: 2 SpMVs a sweep
            minv, minv_u = arrs["minv"], arrs["minv_u"]
            for _ in range(sweeps):
                x = minv.apply(b - self._spmv(dl.A, aA, x), x, 1.0,
                               self.use_kernel)
                x = minv_u.apply(b - self._spmv(dl.A, aA, x), x, 1.0,
                                 self.use_kernel)
            return x
        # Chebyshev: the recurrence shared with the host backend, its matvec
        # swapped for the level's distributed SpMV
        degree = opts.cheby_degree * sweeps
        theta, delta, sigma = chebyshev_coeffs(dl.rho)
        return chebyshev_recurrence(
            lambda v: self._spmv(dl.A, aA, v), dinv, x, b, degree,
            theta, delta, sigma)

    def _cycle_dev(self, b, x, opts, level: int = 0,
                   shape: str | None = None):
        """One cycle of ``shape`` (default ``opts.cycle``) on the device; the
        per-shape coarse revisits of
        :data:`~repro_torch.amg.solve.CYCLE_CHILDREN` recurse in Python."""
        shape = shape or opts.cycle
        dl = self.levels[level]
        a = self.run_arrays(opts)[level]
        if dl.coarse_inv is not None:                 # coarsest: direct solve
            full = hier_all_gather(b, self.n_pods, self.lanes,
                                   log=self.comm_log,  # [D, D*rows(,k)]
                                   **self._between_ranks((level, "coarse")))
            if b.ndim == 2:
                return torch.matmul(a["cinv"], full.unsqueeze(-1)).squeeze(-1)
            return torch.matmul(a["cinv"], full)
        if x is None:
            x = torch.zeros_like(b)
        x = self._relax(dl, a, x, b, opts, opts.presweeps)
        r = b - self._spmv(dl.A, a["A"], x)
        rc = self._spmv(dl.R, a["R"], r)
        ec = None
        for child in CYCLE_CHILDREN[shape]:           # coarse-grid solve(s)
            ec = self._cycle_dev(rc, ec, opts, level + 1, shape=child)
        x = x + self._spmv(dl.P, a["P"], ec)
        x = self._relax(dl, a, x, b, opts, opts.postsweeps)
        return x

    # ------------------------------------------------------------- programs
    # The bodies of the reference's ten fused programs, run eagerly when
    # called directly and through .programs by the drivers.  Vectors are
    # [D, local] (single RHS) or [D, local, k] (the *_m twins: every SpMV a
    # native SpMM, one halo exchange for all k columns); norms and dots come
    # back per rank, [D] or [D, k], every rank holding the same value.

    def _spmv0(self, x):
        return self._spmv(self.levels[0].A, self._arrs[0]["A"], x)

    def resid_norm(self, x, b, opts):
        return self._pnorm(b - self._spmv0(x))

    def cycle(self, x, b, opts):
        x = self._cycle_dev(b, x, opts)
        return x, self._pnorm(b - self._spmv0(x))

    def vcycle(self, b, opts):
        return self._cycle_dev(b, None, opts)

    def pcg_init(self, x, b, opts):
        r = b - self._spmv0(x)                      # x0 warm start
        z = self._cycle_dev(r, None, opts)
        return r, z, self._pdot(r, z), self._pnorm(r)

    def pcg_step(self, x, r, p, rz, opts):
        Ap = self._spmv0(p)
        alpha = (rz / self._pdot(p, Ap)).unsqueeze(1)
        x = x + alpha * p
        r = r - alpha * Ap
        rnorm = self._pnorm(r)
        z = self._cycle_dev(r, None, opts)
        rz_new = self._pdot(r, z)
        p = z + (rz_new / rz).unsqueeze(1) * p
        return x, r, p, rz_new, rnorm

    # the multi-RHS twins of the first four are the same computation on
    # [D, local, k] operands (per-column dots come out of _pdot as [D, k])
    resid_norm_m = resid_norm
    cycle_m = cycle
    vcycle_m = vcycle
    pcg_init_m = pcg_init

    def pcg_step_m(self, x, r, p, rz, opts):
        Ap = self._spmv0(p)
        # columns that already converged exactly (rz = pAp = 0, e.g. a zero
        # RHS) must not poison the batch with 0/0 NaNs: guard the divisions
        # so such columns step by exactly zero
        den = self._pdot(p, Ap)
        alpha = (rz / torch.where(den == 0, 1.0, den)).unsqueeze(1)
        x = x + alpha * p
        r = r - alpha * Ap
        rnorm = self._pnorm(r)
        z = self._cycle_dev(r, None, opts)
        rz_new = self._pdot(r, z)
        p = z + (rz_new / torch.where(rz == 0, 1.0, rz)).unsqueeze(1) * p
        return x, r, p, rz_new, rnorm

    # ------------------------------------------------------- the count model
    # What repro_torch.analysis audits: the collective log of one apply or
    # one program call, and the log the selected strategies predict for it
    # (the reference's static-analysis hooks, dist_solve.py:804-899, with a
    # collective log in place of a traced jaxpr).

    def expected_apply_signature(self, level: int,
                                 op: str = "A") -> tuple[str, ...]:
        """Ordered collectives ONE apply of ``levels[level].<op>`` logs (the
        operator's selected halo-exchange strategy; empty on an empty-halo
        level)."""
        return getattr(self.levels[level], op).expected_signature

    def trace_apply(self, level: int, op: str = "A", *,
                    overlap: bool | None = None,
                    k: int | None = None) -> list[str]:
        """The collective log of one apply of ``levels[level].<op>`` on zero
        operands (``k`` adds a trailing multi-RHS axis)."""
        overlap = self.overlap if overlap is None else overlap
        dop = getattr(self.levels[level], op)
        shape = (self.local_ranks, dop.plan.local_n) + (() if k is None
                                                         else (k,))
        x = torch.zeros(shape, dtype=self.dtype, device=self.device)
        log: list[str] = []
        with self.lock:
            dop.apply(self._arrs[level][op], x, use_kernel=self.use_kernel,
                      overlap=overlap, log=log, side=self._side,
                      **self._between_ranks((level, op)))
        return log

    def trace_program(self, name: str, opts=None, k: int = 2) -> list[str]:
        """The collective log of one call of the program ``name`` for
        ``opts`` through :attr:`programs`, on zeroed state buffers (``k`` is
        the width of the ``*_m`` programs).  On the card the call is a
        replay, which logs what the capture recorded."""
        opts = opts or SolveOptions()
        width = k if name.endswith("_m") else None
        with self.lock:
            for t in self.programs.state(width).values():
                t.zero_()
            saved, self.comm_log = self.comm_log, []
            try:
                self.programs.run(name, opts, width)
                return self.comm_log
            finally:
                self.comm_log = saved

    def _cycle_collectives(self, opts) -> Counter:
        """Per-primitive collective counts ONE cycle of ``opts`` predicts:
        the same visits × (sweeps + residual + restrict + interpolate)
        arithmetic as :func:`cycle_comm_stats`, counting each selected
        strategy's primitives instead of modeled messages."""
        visits = level_visits(len(self.levels), opts.cycle)
        sweep_spmvs = opts.spmvs_per_sweep() * (opts.presweeps
                                                + opts.postsweeps)
        cnt: Counter = Counter()

        def add(sig, times=1):
            for p in sig:
                cnt[p] += times

        for l, dl in enumerate(self.levels):
            if dl.coarse_inv is not None:
                # coarsest: hier_all_gather of the residual (NAP-3 lowering)
                add(gather_signature("nap3"), visits[l])
            else:
                add(halo_signature(dl.A.plan), (sweep_spmvs + 1) * visits[l])
                add(halo_signature(dl.R.plan), visits[l])
                add(halo_signature(dl.P.plan), visits[l])
        return cnt

    def expected_collectives(self, opts=None,
                             name: str = "cycle") -> dict[str, int]:
        """Per-primitive collective counts one call of the program ``name``
        must log: the cycle structure plus the program's own top-level
        SpMV and all-reduce calls.  The ``*_m`` twins log the same: one
        exchange carries all k columns."""
        opts = opts or SolveOptions()
        base = name[:-2] if name.endswith("_m") else name
        total: Counter = Counter()

        def add(sig, times=1):
            for p in sig:
                total[p] += times

        if base in ("cycle", "vcycle", "pcg_init", "pcg_step"):
            total += self._cycle_collectives(opts)
        if base in ("resid_norm", "cycle", "pcg_init", "pcg_step"):
            add(halo_signature(self.levels[0].A.plan))   # top-level residual
        add(reduce_signature(self.reduce_strategy),
            {"resid_norm": 1, "cycle": 1, "vcycle": 0,
             "pcg_init": 2, "pcg_step": 3}[base])
        return {p: c for p, c in total.items() if c}


# --------------------------------------------------------------------------
# Solver drivers (host loop = convergence check only)
# --------------------------------------------------------------------------

# defaults of DistHierarchy.build, used to normalize cache keys so kwargs
# dicts that spell a default explicitly hit the same entry
_BUILD_DEFAULTS = dict(params=TPU_V5E, strategy="auto",
                       strategies=SOLVE_STRATEGIES, dtype=torch.float32,
                       device="cuda", use_kernel=None,
                       reduce_strategy="nap3", overlap=True)
DIST_CACHE_SIZE = 8


def _freeze_kwargs(kw: dict) -> tuple | None:
    """Hashable cache key for a DistHierarchy.build kwargs dict (normalized
    against the build defaults), or ``None`` when any value is unhashable."""
    items = []
    for k, v in sorted({**_BUILD_DEFAULTS, **kw}.items()):
        try:
            hash(v)
        except TypeError:
            return None
        items.append((k, v))
    return tuple(items)


def _ensure_dist(h, dist, **build_kwargs) -> DistHierarchy:
    """Resolve ``dist=`` (a prebuilt DistHierarchy or a build-kwargs dict)
    to a DistHierarchy; kwargs dicts go through the per-hierarchy
    ``dist_cache`` so repeated calls reuse ONE lowering."""
    if isinstance(h, DistHierarchy):
        return h
    if isinstance(dist, DistHierarchy):
        return dist
    if dist is None:
        raise ValueError(
            "backend='torch' needs dist=: pass a prebuilt DistHierarchy "
            "(reused across calls) or a DistHierarchy.build kwargs dict "
            "with at least n_pods and lanes")
    kw = dict(dist)
    kw.update(build_kwargs)
    key = _freeze_kwargs(kw)
    cache = getattr(h, "dist_cache", None)
    if cache is not None and key is not None and key in cache:
        return cache[key]
    try:
        n_pods, lanes = kw.pop("n_pods"), kw.pop("lanes")
    except KeyError as e:
        raise ValueError(f"dist= kwargs dict must set {e.args[0]!r}") from None
    dh = DistHierarchy.build(h, n_pods, lanes, **kw)
    if cache is not None and key is not None:
        cache[key] = dh
        while len(cache) > DIST_CACHE_SIZE:      # oldest-first eviction
            cache.pop(next(iter(cache)))
    return dh


def _norms(b: np.ndarray):
    """Per-column norms of b as a denominator: [k] for [n, k], scalar else."""
    nb = np.linalg.norm(b, axis=0)
    return np.where(nb == 0, 1.0, nb)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy; bfloat16, which numpy lacks, as the
    float32 of the same values."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _host(v: torch.Tensor):
    """Rank 0's copy of a replicated norm: a float, or a float64 [k] array."""
    v = v[0]
    return float(v) if v.ndim == 0 else _numpy(v).astype(np.float64)


def cycle_comm_stats(dh: DistHierarchy, opts=None) -> dict:
    """Modeled communication of ONE cycle of ``opts``'s shape + smoother:
    each level's per-op message/byte counts times the SpMVs a visit costs
    times the cycle shape's per-level visit counts.  ``coarse_*`` totals
    cover levels ≥ 1."""
    opts = opts or SolveOptions()
    visits = level_visits(len(dh.levels), opts.cycle)
    sweep_spmvs = opts.spmvs_per_sweep() * (opts.presweeps + opts.postsweeps)
    keys = ("inter_msgs", "inter_bytes", "intra_msgs", "intra_bytes")
    per_level = []
    totals = dict.fromkeys(keys, 0)
    coarse = {"coarse_inter_msgs": 0, "coarse_intra_msgs": 0}
    for l, dl in enumerate(dh.levels):
        row = dict.fromkeys(keys, 0)
        if dl.coarse_inv is None and "spmv_A" in dl.comm_stats:
            n_spmv = sweep_spmvs + 1                  # sweeps + residual
            for k in keys:
                row[k] += n_spmv * dl.comm_stats["spmv_A"][k]
            for op in ("interp", "restrict"):
                if op in dl.comm_stats:
                    for k in keys:
                        row[k] += dl.comm_stats[op][k]
        entry = {"level": l, "visits": visits[l]}
        for k in keys:
            entry[k] = row[k] * visits[l]
            totals[k] += entry[k]
        if l > 0:
            coarse["coarse_inter_msgs"] += entry["inter_msgs"]
            coarse["coarse_intra_msgs"] += entry["intra_msgs"]
        per_level.append(entry)
    return {"cycle": opts.cycle, "smoother": opts.smoother,
            "per_level": per_level, **totals, **coarse}


def _start(dh: DistHierarchy, b: np.ndarray, x0) -> tuple:
    """Copy ``b`` and ``x0`` (zeros when ``None``) into the state buffers of
    ``b``'s width; returns (width k, program suffix, buffers).  The caller
    holds ``dh.lock``."""
    k = None if b.ndim == 1 else b.shape[1]
    st = dh.programs.state(k)
    dh.load(st["b"], b)
    if x0 is None:
        st["x"].zero_()
    else:
        dh.load(st["x"], np.asarray(x0))
    return k, ("" if k is None else "_m"), st


def dist_vcycle(dh: DistHierarchy, b: np.ndarray, opts=None) -> np.ndarray:
    """One device-resident cycle (``opts.cycle`` shape) from a zero initial
    guess (``b``: [n] or [n, k])."""
    opts = opts or SolveOptions()
    b = np.asarray(b)
    with dh.lock:
        k, m, st = _start(dh, b, None)
        dh.programs.run("vcycle" + m, opts, k)
        return dh.gather(st["x"])


def _column_results(X, res, nb, tol):
    """Slice a batched solve into per-column SolveResults: each column
    reports the iteration at which IT first converged and a residual
    history truncated there, as the host backend does."""
    k = X.shape[1]
    cols = []
    for j in range(k):
        hist = [float(r[j]) for r in res]
        nbj = float(nb[j])
        it = next((i for i, r in enumerate(hist) if r / nbj < tol), None)
        if it is None:
            cols.append(SolveResult(X[:, j], hist, len(hist) - 1, False))
        else:
            cols.append(SolveResult(X[:, j], hist[: it + 1], it, True))
    return MultiSolveResult(X, cols)


def _iterate(dh, first: str, step: str, opts, b, x0, tol, maxiter):
    """The host loop of both drivers: one ``first`` program, then one
    ``step`` program per iteration until the norms in ``rnorm`` reach
    ``tol`` (every column, for ``b`` ``[n, k]``); each program call reads
    ``rnorm`` back once.  Holds ``dh.lock`` from the copy-in to the
    gather of ``x``."""
    b = np.asarray(b)
    with dh.lock:
        k, m, st = _start(dh, b, x0)
        dh.programs.run(first + m, opts, k)
        res = [_host(st["rnorm"])]
        if k is not None:
            nb = _norms(b)
            for _ in range(maxiter):
                if (res[-1] / nb < tol).all():
                    break
                dh.programs.run(step + m, opts, k)
                res.append(_host(st["rnorm"]))
            return _column_results(dh.gather(st["x"]), res, nb, tol)
        nb = float(np.linalg.norm(b)) or 1.0
        for it in range(maxiter):
            if res[-1] / nb < tol:
                return SolveResult(dh.gather(st["x"]), res, it, True)
            dh.programs.run(step, opts, k)
            res.append(_host(st["rnorm"]))
        return SolveResult(dh.gather(st["x"]), res, maxiter,
                           res[-1] / nb < tol)


def dist_solve(dh: DistHierarchy, b: np.ndarray, tol: float = 1e-8,
               maxiter: int = 100, opts=None, x0: np.ndarray | None = None):
    """Stationary AMG iteration x ← x + cycle(b − Ax) on the device.

    ``b`` may be ``[n]`` or ``[n, k]``; the multi-RHS form batches all k
    systems and iterates until every column converges.
    """
    return _iterate(dh, "resid_norm", "cycle", opts or SolveOptions(), b, x0,
                    tol, maxiter)


def dist_pcg(dh: DistHierarchy, b: np.ndarray, tol: float = 1e-8,
             maxiter: int = 200, opts=None, x0: np.ndarray | None = None):
    """AMG-preconditioned CG, preconditioner + operator on the device.

    Supports ``x0=`` warm starts and multi-RHS ``b`` of shape ``[n, k]``.
    """
    return _iterate(dh, "pcg_init", "pcg_step", opts or SolveOptions(), b, x0,
                    tol, maxiter)
