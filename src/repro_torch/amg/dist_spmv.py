"""Distributed SpMV on rank-stacked tensors: the paper's solve-phase hot loop
(PyTorch port of :mod:`repro.amg.dist_spmv`).

Setup (host numpy, once per level and operator — copied from the reference
so the lowered arrays are bit-identical):
  * row-partition the operator over the (pods × lanes) rank grid,
  * convert each rank's rows to padded ELL with columns remapped to
    [local | halo] positions, and split them into the on-process part
    (local columns) and the off-process part (halo columns),
  * build a :class:`~repro_torch.core.nap_collectives.HaloPlan` for the
    selected strategy (standard / nap2 / nap3),
  * optionally re-tile the blocks into dense bs×bs BCSR blocks.

An operator born partitioned (per-rank row blocks, no global CSR) lowers
through :func:`build_dist_operator_from_blocks` to the same arrays.

Operators may be rectangular (restriction R and interpolation P).

Execute (device, every smoother sweep / residual / restrict / interpolate):
:meth:`DistOperator.apply` = halo exchange on the stacked ranks → one local
kernel launch for all ranks (ELL SpMV/SpMM, or BCSR).  In the split form on
the card the exchange runs on a side stream while ``A_on·x`` runs on the
current one; captured into a CUDA graph, the two become parallel branches.

Refresh (streaming updates): :meth:`DistOperator.refresh_values` re-lowers
new values onto the frozen layouts (numpy copy of the reference) and
:meth:`DistOperator.copy_values` writes the value planes into the device
tensors already in place, which captured graphs keep reading.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.comm_graph import CommGraph
from ..core.nap_collectives import (HaloPlan, build_halo_plan, halo_exchange,
                                    halo_signature)
from ..core.topology import Partition, Topology
from ..kernels.spmv.ops import bcsr, spmm, spmv
from .csr import CSR, csr_to_bcsr
from .dist import rect_vector_graph


def _ell_block(M: CSR, row_part: Partition, col_part: Partition, d: int,
               need_sorted: np.ndarray, rows_local: int, x_local: int, K: int):
    """One device's ELL block with columns remapped to [local | halo]."""
    rlo, rhi = row_part.local_range(d)
    clo, chi = col_part.local_range(d)
    sub = M.submatrix_rows(rlo, rhi)
    cols = np.full((rows_local, K), -1, dtype=np.int32)
    vals = np.zeros((rows_local, K), dtype=np.float64)
    if sub.nnz:
        lens = np.diff(sub.indptr)
        rows = np.repeat(np.arange(sub.nrows, dtype=np.int64), lens)
        k = np.arange(sub.nnz, dtype=np.int64) - np.repeat(sub.indptr[:-1], lens)
        c = sub.indices
        local = (c >= clo) & (c < chi)
        halo_pos = np.searchsorted(need_sorted, c)
        pos = np.where(local, c - clo, x_local + halo_pos).astype(np.int32)
        cols[rows, k] = pos
        vals[rows, k] = sub.data
    return cols, vals


def _split_ell_stacked(cols: np.ndarray, vals: np.ndarray, x_local: int):
    """Split fused [D, rows, K] ELL arrays into the on-process part (columns
    < ``x_local``, kept as local ids) and the off-process part (halo columns,
    rebased to index the halo buffer directly).

    Within each row the relative nonzero order is preserved, so
    ``A_on·x + A_off·halo`` partitions the fused contraction term-for-term.
    """
    D, R, K = cols.shape

    def pack(mask, offset):
        m2 = mask.reshape(D * R, K)
        width = int(m2.sum(axis=1).max(initial=0)) or 1
        oc = np.full((D * R, width), -1, dtype=np.int32)
        ov = np.zeros((D * R, width), dtype=vals.dtype)
        rows, _ = np.nonzero(m2)
        if rows.size:
            counts = m2.sum(axis=1)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            slot = np.arange(rows.size) - np.repeat(starts, counts)
            oc[rows, slot] = cols.reshape(D * R, K)[m2] - offset
            ov[rows, slot] = vals.reshape(D * R, K)[m2]
        return oc.reshape(D, R, width), ov.reshape(D, R, width)

    on = pack((cols >= 0) & (cols < x_local), 0)
    off = pack(cols >= x_local, x_local)
    return on, off


# device dtype of each array of DistOperator.device_arrays(): ELL/BCSR
# column ids stay int32 (the kernels' layout), the exchange's index arrays
# become int64 (torch's gather index type), values take the compute dtype
INDEX32 = ("cols", "on_cols", "off_cols", "bcols", "on_bcols")
INDEX64 = ("send", "recv", "psel")
VALUE_PLANES = ("vals", "on_vals", "off_vals", "bvals", "on_bvals")


def copy_into(dst: torch.Tensor, src: np.ndarray, dtype: torch.dtype,
              what: str) -> None:
    """Write the host array ``src`` into the device tensor ``dst`` in place
    (converted as :meth:`DistOperator.to_device` converts), after checking
    that ``dst`` has ``src``'s shape and the compute ``dtype``: a captured
    graph holds ``dst``'s address, so it must never be rebound."""
    if tuple(dst.shape) != src.shape or dst.dtype != dtype:
        raise ValueError(f"refresh of {what}: the device tensor is "
                         f"{dst.dtype}{tuple(dst.shape)}, the new values "
                         f"{dtype}{src.shape}")
    dst.copy_(torch.as_tensor(np.ascontiguousarray(src)).to(dtype))


@dataclasses.dataclass
class DistOperator:
    """Host-side container for one distributed (possibly rectangular) operator.

    Rank-stacked numpy arrays carry a leading ``n_devices`` dim; the
    :class:`HaloPlan` and partitions are static setup-time metadata.
    :meth:`to_device` turns :meth:`device_arrays` into the tensors that
    :meth:`apply` reads.
    """

    strategy: str
    plan: HaloPlan               # halo plan in x-space (col_part layout)
    row_part: Partition          # layout of y (output)
    col_part: Partition          # layout of x (input)
    rows_local: int              # padded local row count per device
    ell_cols: np.ndarray         # [D, rows_local, K] int32 into [local|halo], -1 pad
    ell_vals: np.ndarray         # [D, rows_local, K]
    send_idx: np.ndarray         # per-device slices of the plan arrays
    recv_sel: np.ndarray
    pool_sel: np.ndarray         # zeros placeholder when plan.pool_sel is None
    # on/off split of the same block: A_on holds the halo-free columns (local
    # ids), A_off the halo columns rebased to halo-buffer ids.  The fused
    # arrays above stay authoritative for the serial form.
    on_cols: np.ndarray | None = None    # [D, rows_local, K_on] int32, -1 pad
    on_vals: np.ndarray | None = None
    off_cols: np.ndarray | None = None   # [D, rows_local, K_off] into halo
    off_vals: np.ndarray | None = None
    # optional BCSR lowering (see lower_bcsr): dense bs×bs blocks
    bcsr_bcols: np.ndarray | None = None   # [D, mb, Kb] int32, -1 pad
    bcsr_bvals: np.ndarray | None = None   # [D, mb, Kb, bs, bs]
    bcsr_on_bcols: np.ndarray | None = None  # on-part lowering (A_off stays ELL)
    bcsr_on_bvals: np.ndarray | None = None
    block_size: int = 0                    # 0 = ELL layout
    # one process per rank: the one rank whose [d:d+1] rows every stacked
    # array above holds (None: all D ranks stacked)
    rank: int | None = None

    @property
    def n_devices(self) -> int:
        return self.plan.n_devices

    @property
    def halo_empty(self) -> bool:
        """True when the plan moves zero entries (halo_len is floored to 1
        for static shapes, so emptiness must be read from total_halo)."""
        return self.plan.total_halo == 0

    @property
    def local_kernel(self) -> str:
        """Layout label for reporting: 'bcsr' once lowered, else 'ell'."""
        return "bcsr" if self.bcsr_bcols is not None else "ell"

    @property
    def expected_signature(self) -> tuple[str, ...]:
        """Ordered collective primitives ONE apply of this operator logs —
        the selected strategy's halo signature, empty when the halo is."""
        return halo_signature(self.plan)

    def onoff_nnz(self) -> dict[str, int]:
        """Total and per-device-max nnz of the on/off split."""
        on = (self.on_cols >= 0).sum(axis=(1, 2))
        off = (self.off_cols >= 0).sum(axis=(1, 2))
        return {"on_nnz": int(on.sum()), "off_nnz": int(off.sum()),
                "max_on_nnz": int(on.max(initial=0)),
                "max_off_nnz": int(off.max(initial=0))}

    def device_arrays(self) -> dict[str, np.ndarray]:
        """The rank-stacked arrays one apply needs (numpy)."""
        arrs = {"cols": self.ell_cols, "vals": self.ell_vals,
                "send": self.send_idx, "recv": self.recv_sel,
                "psel": self.pool_sel,
                "on_cols": self.on_cols, "on_vals": self.on_vals,
                "off_cols": self.off_cols, "off_vals": self.off_vals}
        if self.bcsr_bcols is not None:
            arrs["bcols"] = self.bcsr_bcols
            arrs["bvals"] = self.bcsr_bvals
            arrs["on_bcols"] = self.bcsr_on_bcols
            arrs["on_bvals"] = self.bcsr_on_bvals
        return arrs

    def rank_slice(self, d: int) -> "DistOperator":
        """Rank ``d``'s part of this operator: every rank-stacked array cut
        to its ``[d:d+1]`` rows (copies, so a pickled slice carries no other
        rank's data), the plan's index arrays likewise.  The widths are the
        stacked maxima, so the slice is bit-equal to row ``d``."""
        def cut(a):
            return None if a is None else a[d:d + 1].copy()

        plan = dataclasses.replace(self.plan, send_idx=cut(self.plan.send_idx),
                                   recv_sel=cut(self.plan.recv_sel),
                                   pool_sel=cut(self.plan.pool_sel))
        return dataclasses.replace(
            self, plan=plan, rank=d,
            **{f: cut(getattr(self, f)) for f in (
                "ell_cols", "ell_vals", "send_idx", "recv_sel", "pool_sel",
                "on_cols", "on_vals", "off_cols", "off_vals", "bcsr_bcols",
                "bcsr_bvals", "bcsr_on_bcols", "bcsr_on_bvals")})

    def to_device(self, device: torch.device,
                  dtype: torch.dtype) -> dict[str, torch.Tensor]:
        """:meth:`device_arrays` as contiguous tensors on ``device``: value
        planes in ``dtype``, ELL/BCSR column ids int32, exchange indices
        int64."""
        out = {}
        for name, a in self.device_arrays().items():
            t = (torch.int32 if name in INDEX32 else
                 torch.int64 if name in INDEX64 else dtype)
            out[name] = torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=t).contiguous()
        return out

    def lower_bcsr(self, block_size: int) -> None:
        """Lower this operator's per-device ELL blocks to block-ELL BCSR.

        Each device's (rows_local × [local|halo]) sparse block is re-tiled
        into dense ``bs×bs`` blocks; block-row padding never mixes devices
        because each device is lowered independently.  Once lowered,
        :meth:`apply` routes through the BCSR kernel instead of the ELL one.
        """
        D = self.n_devices

        def lower(ell_cols, ell_vals, width):
            per = []
            for d in range(D):
                cols = ell_cols[d]
                keep = cols >= 0
                r = np.broadcast_to(
                    np.arange(self.rows_local, dtype=np.int64)[:, None],
                    cols.shape)[keep]
                per.append(csr_to_bcsr(
                    CSR.from_coo(r, cols[keep], ell_vals[d][keep],
                                 (self.rows_local, width)), block_size))
            mb = per[0].bcols.shape[0] if per else 0
            Kb = max((b.bcols.shape[1] for b in per), default=0)
            bcols = np.full((D, mb, Kb), -1, dtype=np.int32)
            bvals = np.zeros((D, mb, Kb, block_size, block_size),
                             dtype=ell_vals.dtype)
            for d, b in enumerate(per):
                kb = b.bcols.shape[1]
                bcols[d, :, :kb] = b.bcols
                bvals[d, :, :kb] = b.bvals
            return bcols, bvals

        xfull_len = self.plan.local_n + self.plan.halo_len
        self.bcsr_bcols, self.bcsr_bvals = lower(
            self.ell_cols, self.ell_vals, xfull_len)
        # on-part only: the off-part stays ELL — its rows are halo-width
        # gathers that would shred into mostly-empty bs×bs blocks.
        self.bcsr_on_bcols, self.bcsr_on_bvals = lower(
            self.on_cols, self.on_vals, self.plan.local_n)
        self.block_size = int(block_size)

    def refresh_values(self, block_of) -> None:
        """Value-only re-lowering onto the frozen layouts (numpy copy of the
        reference's).

        ``block_of(d)`` returns the CSR device ``d`` reads its rows from —
        same contract as the build — whose sparsity pattern must match the
        one this operator was lowered from.  The ELL fill order is a pure
        function of ``indptr``/``indices`` (see :func:`_ell_block`), so with
        a frozen pattern the column maps, halo plan and on/off split
        layouts are all reproduced exactly; only the value planes change.
        BCSR lowerings are re-tiled at the same ``block_size``.
        """
        vals = np.zeros(self.ell_cols.shape, dtype=np.float64)
        for d in range(self.n_devices):
            rlo, rhi = self.row_part.local_range(d)
            sub = block_of(d).submatrix_rows(rlo, rhi)
            if sub.nnz:
                lens = np.diff(sub.indptr)
                rows = np.repeat(np.arange(sub.nrows, dtype=np.int64), lens)
                k = np.arange(sub.nnz, dtype=np.int64) \
                    - np.repeat(sub.indptr[:-1], lens)
                vals[d][rows, k] = sub.data
        self.ell_vals = vals.astype(self.ell_vals.dtype)
        (on_cols, on_vals), (off_cols, off_vals) = _split_ell_stacked(
            self.ell_cols, self.ell_vals, self.plan.local_n)
        # the split is deterministic given cols: layouts come back identical
        self.on_cols, self.on_vals = on_cols, on_vals
        self.off_cols, self.off_vals = off_cols, off_vals
        if self.block_size:
            self.lower_bcsr(self.block_size)

    def copy_values(self, arrs: dict[str, torch.Tensor],
                    dtype: torch.dtype) -> None:
        """Copy the value planes into :meth:`to_device`'s tensors ``arrs``
        in place (the index arrays are the build's and stay)."""
        for name, a in self.device_arrays().items():
            if name in VALUE_PLANES:
                copy_into(arrs[name], a, dtype, name)

    # ------------------------------------------------------------ execution
    @staticmethod
    def _ell_product(cols, vals, src, use_kernel: bool):
        """ELL contraction of one split part against ``src`` ``[D, n(, k)]``."""
        fn = spmm if src.ndim == 3 else spmv
        return fn(cols, vals, src, use_kernel=use_kernel)

    def _bcsr_product(self, bcols, bvals, src, use_kernel: bool):
        """Block-ELL contraction against ``src``: the true rows only, in one
        launch on the card (no pad of ``src``, no slice of the result)."""
        return bcsr(bcols, bvals, src, rows=self.rows_local,
                    use_kernel=use_kernel)

    def _on_product(self, arrs, x, use_kernel: bool):
        """``A_on · x`` — the halo-free product."""
        if "on_bcols" in arrs:
            return self._bcsr_product(arrs["on_bcols"], arrs["on_bvals"], x,
                                      use_kernel)
        return self._ell_product(arrs["on_cols"], arrs["on_vals"], x,
                                 use_kernel)

    def apply(self, arrs: dict[str, torch.Tensor], x: torch.Tensor,
              use_kernel: bool = True, overlap: bool = True,
              log: list | None = None,
              side: torch.cuda.Stream | None = None,
              ranks=None, tag=None) -> torch.Tensor:
        """Halo exchange + local SpMV/SpMM for all ranks at once.

        ``arrs`` holds :meth:`to_device`'s tensors; ``x`` is ``[D, local]``
        (one RHS) or ``[D, local, k]`` (multi-RHS: the halo is exchanged once
        with the RHS axis riding along).  Routing: the BCSR kernel when this
        operator was :meth:`lower_bcsr`'d, else the ELL kernels;
        ``use_kernel=False`` takes the plain versions instead.

        ``overlap=True`` (default) computes ``A_on·x + A_off·halo``, the split
        form whose on-process product does not wait for the exchange;
        ``overlap=False`` keeps the fused serial form ``A·[x | halo]``.  A plan
        that moves zero entries runs no exchange at all in either mode.
        ``log`` collects the exchange's collective names.

        ``side`` (a stream on ``x``'s card) runs the split form's exchange
        concurrently with ``A_on·x``: it forks from the current stream, the
        exchange runs on it while the current stream computes ``A_on·x``,
        and the two join before ``A_off·halo``.  The sum is the same in the
        same order, so the result is bit-equal to the one-stream form.

        ``ranks`` (a :class:`~repro_torch.core.nap_collectives.RankGroups`)
        runs the exchange between processes on this rank's slice
        (:meth:`rank_slice`); ``tag`` labels its tally.
        """
        if self.halo_empty:
            return self._on_product(arrs, x, use_kernel)
        psel = None if self.plan.pool_sel is None else arrs["psel"]

        def exchange():
            return halo_exchange(x, self.plan, arrs["send"], arrs["recv"],
                                 psel, log=log, ranks=ranks, tag=tag)

        if overlap:
            if side is None:
                halo = exchange()
                y = self._on_product(arrs, x, use_kernel)
            else:
                main = torch.cuda.current_stream(x.device)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    halo = exchange()
                y = self._on_product(arrs, x, use_kernel)
                main.wait_stream(side)
                # halo was made on the side stream and is read on this one
                halo.record_stream(main)
            return y + self._ell_product(arrs["off_cols"], arrs["off_vals"],
                                         halo, use_kernel)
        halo = exchange()
        xfull = torch.cat([x, halo], dim=1)     # one buffer for all RHS
        if "bcols" in arrs:
            return self._bcsr_product(arrs["bcols"], arrs["bvals"], xfull,
                                      use_kernel)
        return self._ell_product(arrs["cols"], arrs["vals"], xfull, use_kernel)

    # ------------------------------------------------------- host-side layout
    def scatter_x(self, x: np.ndarray, dtype=None) -> np.ndarray:
        """Global x (col_part layout) -> [D, x_local(, k)] device layout.

        ``x`` may be ``[n]`` or ``[n, k]`` (multi-RHS block); the trailing
        RHS axis is carried through unsharded.  A :meth:`rank_slice` takes
        its own rank's rows only: ``[1, x_local(, k)]``.
        """
        x = np.asarray(x)
        if x.ndim not in (1, 2) or x.shape[0] != self.col_part.n:
            raise ValueError(f"expected x of shape ({self.col_part.n},) or "
                             f"({self.col_part.n}, k), got {x.shape}")
        held = range(self.n_devices) if self.rank is None else (self.rank,)
        dtype = dtype or self.ell_vals.dtype
        out = np.zeros((len(held), self.plan.local_n) + x.shape[1:],
                       dtype=dtype)
        for i, d in enumerate(held):
            lo, hi = self.col_part.local_range(d)
            out[i, : hi - lo] = x[lo:hi]
        return out

    def gather_y(self, y_dev: np.ndarray) -> np.ndarray:
        """[D, rows_local(, k)] device layout -> global y (row_part layout)."""
        y_dev = np.asarray(y_dev)
        out = np.zeros((self.row_part.n,) + y_dev.shape[2:], dtype=y_dev.dtype)
        for d in range(self.n_devices):
            lo, hi = self.row_part.local_range(d)
            out[lo:hi] = y_dev[d, : hi - lo]
        return out


def local_square_block(M, part: Partition, d: int) -> CSR:
    """Device d's diagonal square block of ``M`` (rows AND columns in
    ``part.local_range(d)``, columns shifted to local 0-based ids)."""
    lo, hi = part.local_range(d)
    sub = M.submatrix_rows(lo, hi)
    r, c = sub.rows_expanded(), sub.indices
    keep = (c >= lo) & (c < hi)
    return CSR.from_coo(r[keep], c[keep] - lo, sub.data[keep],
                        (hi - lo, hi - lo))


def _assemble_operator(block_of, K: int, n_pods: int, lanes: int,
                       strategy: str, row_part: Partition,
                       col_part: Partition, graph: CommGraph,
                       dtype) -> DistOperator:
    """Shared tail: halo plan + per-device ELL lowering.

    ``block_of(d)`` returns the CSR each device reads its rows from — the
    whole matrix on the from-global path, device d's own row block on the
    from-blocks path.  ``K`` is the global max row length.
    """
    D = n_pods * lanes
    plan = build_halo_plan(graph, n_pods, lanes, strategy)
    need_sorted = [np.sort(graph.need[d]) for d in range(D)]
    rows_local = row_part.max_local_size
    x_local = plan.local_n
    cols = np.zeros((D, rows_local, K), dtype=np.int32)
    vals = np.zeros((D, rows_local, K), dtype=np.float64)
    for d in range(D):
        cols[d], vals[d] = _ell_block(block_of(d), row_part, col_part, d,
                                      need_sorted[d], rows_local, x_local, K)
    psel = plan.pool_sel if plan.pool_sel is not None else np.zeros(
        (D, 1), dtype=np.int32)
    vals = vals.astype(dtype)
    (on_cols, on_vals), (off_cols, off_vals) = _split_ell_stacked(
        cols, vals, x_local)
    return DistOperator(strategy=strategy, plan=plan, row_part=row_part,
                        col_part=col_part, rows_local=rows_local,
                        ell_cols=cols, ell_vals=vals,
                        send_idx=plan.send_idx, recv_sel=plan.recv_sel,
                        pool_sel=psel, on_cols=on_cols, on_vals=on_vals,
                        off_cols=off_cols, off_vals=off_vals)


def build_dist_operator(M: CSR, n_pods: int, lanes: int, strategy: str,
                        row_part: Partition | None = None,
                        col_part: Partition | None = None,
                        graph: CommGraph | None = None,
                        dtype=np.float32) -> DistOperator:
    """Build the rank-stacked form of ``M`` (square or rectangular) for one
    strategy.  ``graph`` may be passed in when the caller already built it
    (it must be ``rect_vector_graph(M, row_part, col_part)``); ``dtype`` is
    the numpy dtype of the value planes."""
    topo = Topology(n_nodes=n_pods, ppn=lanes)
    row_part = row_part or Partition.balanced(M.nrows, topo)
    col_part = col_part or Partition.balanced(M.ncols, topo)
    if graph is None:
        graph = rect_vector_graph(M, row_part, col_part)
    K = int(np.diff(M.indptr).max(initial=1)) or 1
    return _assemble_operator(lambda d: M, K, n_pods, lanes, strategy,
                              row_part, col_part, graph, dtype)


def build_dist_operator_from_blocks(blocks: list[CSR], n_pods: int,
                                    lanes: int, strategy: str, *,
                                    row_part: Partition,
                                    col_part: Partition,
                                    graph: CommGraph | None = None,
                                    dtype=np.float32) -> DistOperator:
    """Rank-stacked form of an operator that exists only as per-rank row
    blocks (numpy copy of the reference's).

    ``blocks[d]`` is a *global-shape* CSR holding exactly rank d's rows
    (rows outside ``row_part.local_range(d)`` empty, global column ids) —
    the :mod:`repro_torch.amg.dist_setup` representation, where each level
    is born partitioned and no global CSR is ever assembled.
    """
    D = n_pods * lanes
    assert len(blocks) == D, (len(blocks), D)
    if graph is None:
        offp = []
        for p in range(D):
            rlo, rhi = row_part.local_range(p)
            clo, chi = col_part.local_range(p)
            offp.append(blocks[p].offproc_columns(clo, chi, rlo, rhi))
        graph = CommGraph.from_offproc_columns(col_part, offp)
    K = max(int(np.diff(b.indptr).max(initial=0)) for b in blocks) or 1
    return _assemble_operator(lambda d: blocks[d], K, n_pods, lanes, strategy,
                              row_part, col_part, graph, dtype)
