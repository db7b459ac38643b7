"""Plain PyTorch versions of the three local sparse kernels.

Each takes the rank-stacked operands of the distributed solve (a leading
rank dim D) and computes what one launch of the matching CUDA kernel
computes, so the CPU tests and ``chip_smoke.py`` hold the kernels against
them.  They follow the Pallas kernels' oracles in
``repro/kernels/spmv/ref.py`` and ``repro/kernels/spmv/bcsr.py``
(``bcsr_apply_ref``); summation order may differ from the kernels.

bfloat16 operands follow one rule in all three: the gather is in bfloat16,
the operands are widened to float32, products and row sums are float32,
and the result is rounded to bfloat16 once.  (The reference's Pallas
kernels round along the row in bfloat16; a float32 sum rounded once is
closer to the exact sum of the same products.)  float32 and float64
compute in their own type.
"""
from __future__ import annotations

import torch


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[d][max(idx[d], 0)]`` per rank: ``x`` ``[D, m] + ext``, ``idx``
    ``[D, ...]`` → ``idx.shape + ext``."""
    D = x.shape[0]
    ext = tuple(x.shape[2:])
    flat = idx.reshape(D, -1).clamp_min(0).long()
    flat = flat.reshape((D, flat.shape[1]) + (1,) * len(ext))
    g = torch.gather(x, 1, flat.expand((D, flat.shape[1]) + ext))
    return g.reshape(tuple(idx.shape) + ext)


def wide(t: torch.Tensor) -> torch.Tensor:
    """The type products and sums are taken in: float32 for bfloat16
    operands, the operands' own type otherwise."""
    return t.float() if t.dtype == torch.bfloat16 else t


def ell_spmv_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``y[d, i] = Σ_k vals[d, i, k] · x[d, cols[d, i, k]]`` (``cols == -1``
    is padding).  cols/vals ``[D, n, K]``, x ``[D, m]`` → ``[D, n]``."""
    D, n, K = cols.shape
    if n == 0 or K == 0 or x.shape[1] == 0:
        return torch.zeros((D, n), dtype=vals.dtype, device=vals.device)
    contrib = torch.where(cols >= 0,
                          wide(vals) * wide(_gather_rows(x, cols)), 0.0)
    return contrib.sum(dim=2).to(vals.dtype)


def ell_spmm_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``Y[d, i, :] = Σ_k vals[d, i, k] · X[d, cols[d, i, k], :]``.
    cols/vals ``[D, n, K]``, X ``[D, m, k]`` → ``[D, n, k]``."""
    D, n, K = cols.shape
    k = x.shape[2]
    if n == 0 or K == 0 or x.shape[1] == 0 or k == 0:
        return torch.zeros((D, n, k), dtype=vals.dtype, device=vals.device)
    g = _gather_rows(x, cols)                             # [D, n, K, k]
    contrib = torch.where((cols >= 0)[..., None],
                          wide(vals)[..., None] * wide(g), 0.0)
    return contrib.sum(dim=2).to(vals.dtype)


def block_x(x: torch.Tensor, bs: int) -> torch.Tensor:
    """``[D, m(, k)]`` → ``[D, nb, bs, k]`` zero-padded blocked source
    (k = 1 for vectors); a view when ``m`` is a multiple of ``bs``."""
    if x.ndim == 2:
        x = x[..., None]
    D, m, k = x.shape
    pad = (-m) % bs
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x.reshape(D, -1, bs, k)


def block_rows(rows: int | None, mb: int, bs: int) -> int:
    """The output row count of a block-ELL product: ``rows`` (default all
    ``mb·bs``), checked to lie in ``0..mb·bs``."""
    rows = mb * bs if rows is None else int(rows)
    if not 0 <= rows <= mb * bs:
        raise ValueError(f"bcsr: rows = {rows} outside 0..{mb * bs}")
    return rows


def bcsr_apply_ref(bcols: torch.Tensor, bvals: torch.Tensor,
                   x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """Block-ELL product: block row r = ``Σ_s bvals[d, r, s] @
    Xb[d, bcols[d, r, s]]``.  bcols ``[D, mb, Kb]`` (-1 pad), bvals
    ``[D, mb, Kb, bs, bs]``, x ``[D, m]`` or ``[D, m, k]`` → the first
    ``rows`` rows (default all ``mb·bs``): ``[D, rows]`` or
    ``[D, rows, k]``."""
    single = x.ndim == 2
    D, mb, Kb = bcols.shape
    bs = bvals.shape[-1]
    rows = block_rows(rows, mb, bs)
    k = 1 if single else x.shape[2]
    if mb == 0 or Kb == 0 or x.shape[1] == 0 or k == 0:
        y = torch.zeros((D, rows, k), dtype=bvals.dtype, device=bvals.device)
    else:
        g = _gather_rows(block_x(x, bs), bcols)           # [D, mb, Kb, bs, k]
        g = torch.where((bcols >= 0)[..., None, None], g, 0.0)
        y = torch.matmul(wide(bvals), wide(g)).sum(dim=2)
        y = y.to(bvals.dtype).reshape(D, mb * bs, k)[:, :rows].contiguous()
    return y[..., 0] if single else y
