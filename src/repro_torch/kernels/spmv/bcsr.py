"""Block-ELL (BCSR) SpMM / SpMV on rank-stacked operands: the wrapper of the
hand-written CUDA kernel ``csrc/bcsr_spmm.cu``.

It replaces the Pallas kernel ``bcsr_spmm`` of ``repro/kernels/spmv/bcsr.py``
and its k = 1 wrapper ``bcsr_spmv``.  Layout (from :func:`~repro_torch.amg.
csr.csr_to_bcsr`, stacked over ranks): ``bcols`` ``[D, mb, Kb]`` int32
block-column ids (-1 pad), ``bvals`` ``[D, mb, Kb, bs, bs]`` dense blocks with
bs in :data:`BLOCK_SIZES`.  The source is blocked to ``[D, nb, bs, k]``
(zero-padded to a multiple of bs); the result has ``mb·bs`` rows, which
callers slice back to the true row count.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.  ``bcsr_spmm.launches`` counts launches.
"""
from __future__ import annotations

import torch

from ..build import kernel
from .ref import bcsr_apply_ref, block_x
from .spmv import check_operands, raise_on_error

BLOCK_SIZES = (8, 16)


def bcsr_spmm(bcols: torch.Tensor, bvals: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """``Y = A·X`` with A in block-ELL form and ``x`` ``[D, m, k]`` →
    ``[D, mb·bs, k]``."""
    if not check_operands("bcsr_spmm", bcols, bvals, x, 3, 5, (3,)):
        return bcsr_apply_ref(bcols, bvals, x)
    D, mb, Kb = bcols.shape
    bs = bvals.shape[-1]
    if bs not in BLOCK_SIZES or bvals.shape[-2] != bs:
        raise ValueError(f"bcsr_spmm: block size must be one of "
                         f"{BLOCK_SIZES}, got {tuple(bvals.shape[-2:])}")
    k = x.shape[2]
    if D == 0 or mb == 0 or Kb == 0 or x.shape[1] == 0 or k == 0:
        return torch.zeros((D, mb * bs, k), dtype=bvals.dtype, device=x.device)
    xb = block_x(x, bs)
    y = torch.empty((D, mb * bs, k), dtype=bvals.dtype, device=x.device)
    rc = kernel("bcsr_spmm")(bcols.data_ptr(), bvals.data_ptr(), xb.data_ptr(),
                             y.data_ptr(), D, mb, Kb, xb.shape[1], bs, k,
                             int(bvals.dtype == torch.float64),
                             torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("bcsr_spmm", rc)
    bcsr_spmm.launches += 1
    return y


def bcsr_spmv(bcols: torch.Tensor, bvals: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """``y = A·x`` (one RHS, ``x`` ``[D, m]``) through the same kernel."""
    return bcsr_spmm(bcols, bvals, x[..., None])[..., 0]


bcsr_spmm.launches = 0
