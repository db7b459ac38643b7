"""Block-ELL (BCSR) SpMM / SpMV on rank-stacked operands: the wrapper of the
hand-written CUDA kernel ``csrc/bcsr_spmm.cu``.

It replaces the Pallas kernel ``bcsr_spmm`` of ``repro/kernels/spmv/bcsr.py``
and its k = 1 wrapper ``bcsr_spmv``.  Layout (from :func:`~repro_torch.amg.
csr.csr_to_bcsr`, stacked over ranks): ``bcols`` ``[D, mb, Kb]`` int32
block-column ids (-1 pad), ``bvals`` ``[D, mb, Kb, bs, bs]`` dense blocks with
bs in :data:`BLOCK_SIZES`, in float32, float64 or bfloat16 (summed in
float32, rounded once).  The source ``[D, m, k]`` goes to the kernel as
it is (rows past ``m`` read as zero); the result has the first ``rows`` rows
of the ``mb·bs``-row product (all of them by default), so a caller with
fewer true rows than whole blocks asks for those and needs no slice.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.  ``bcsr_spmm.launches`` counts the launches
the device ran, replays of a captured CUDA graph included.
"""
from __future__ import annotations

import torch

from ..build import kernel
from ..launches import note
from .ref import bcsr_apply_ref, block_rows
from .spmv import DTYPE_CODES, check_operands, raise_on_error

BLOCK_SIZES = (8, 16)


def bcsr_spmm(bcols: torch.Tensor, bvals: torch.Tensor, x: torch.Tensor,
              rows: int | None = None) -> torch.Tensor:
    """``Y = A·X`` with A in block-ELL form and ``x`` ``[D, m, k]`` →
    ``[D, rows, k]`` (``rows`` ≤ ``mb·bs``, default ``mb·bs``)."""
    if not check_operands("bcsr_spmm", bcols, bvals, x, 3, 5, (3,)):
        return bcsr_apply_ref(bcols, bvals, x, rows)
    D, mb, Kb = bcols.shape
    bs = bvals.shape[-1]
    rows = block_rows(rows, mb, bs)
    if bs not in BLOCK_SIZES or bvals.shape[-2] != bs:
        raise ValueError(f"bcsr_spmm: block size must be one of "
                         f"{BLOCK_SIZES}, got {tuple(bvals.shape[-2:])}")
    m, k = x.shape[1:]
    if D == 0 or rows == 0 or Kb == 0 or m == 0 or k == 0:
        return torch.zeros((D, rows, k), dtype=bvals.dtype, device=x.device)
    y = torch.empty((D, rows, k), dtype=bvals.dtype, device=x.device)
    rc = kernel("bcsr_spmm")(bcols.data_ptr(), bvals.data_ptr(), x.data_ptr(),
                             y.data_ptr(), D, mb, Kb, m, bs, k, rows,
                             DTYPE_CODES[bvals.dtype],
                             torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("bcsr_spmm", rc)
    note(bcsr_spmm)
    return y


def bcsr_spmv(bcols: torch.Tensor, bvals: torch.Tensor, x: torch.Tensor,
              rows: int | None = None) -> torch.Tensor:
    """``y = A·x`` (one RHS, ``x`` ``[D, m]``) through the same kernel →
    ``[D, rows]``."""
    return bcsr_spmm(bcols, bvals, x[..., None], rows)[..., 0]


bcsr_spmm.launches = 0
