"""ELL SpMV / native multi-RHS SpMM on rank-stacked operands: the wrappers of
the hand-written CUDA kernels ``csrc/ell_spmv.cu`` and ``csrc/ell_spmm.cu``.

They replace the Pallas kernels ``ell_spmv`` / ``ell_spmm`` of
``repro/kernels/spmv/spmv.py``.  Operands carry the distributed solve's rank
dim in front, so one launch serves every rank: ``cols``/``vals``
``[D, n, K]`` (``cols == -1`` is padding) against ``x`` ``[D, m]`` or
``X`` ``[D, m, k]``, in float32, float64 or bfloat16 (loaded in bfloat16,
summed in float32, rounded once).

A wrapper takes the plain version (:mod:`.ref`) only for tensors that lie on
the CPU; for CUDA tensors it launches its kernel on the current stream or
raises.  ``<wrapper>.launches`` counts the launches of its kernel that the
device ran, replays of a captured CUDA graph included (:mod:`..launches`).
"""
from __future__ import annotations

import torch

from ..build import kernel
from ..launches import note
from .ref import ell_spmm_ref, ell_spmv_ref

# the value types the sparse and block-smoother kernels take, and the code
# each C entry point reads for one (0 float32, 1 float64, 2 bfloat16:
# float32 sums, one rounding); FLOAT_DTYPES, the two full-precision ones,
# are what the ERT kernels take
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
FLOAT_DTYPES = (torch.float32, torch.float64)


def check_operands(name: str, idx: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor, idx_ndim: int, vals_ndim: int,
                   x_ndims: tuple[int, ...]) -> bool:
    """Validate a kernel's operands; True when they lie on a CUDA device
    (the kernel runs), False when on the CPU (the plain version runs)."""
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: column ids must be int32, got {idx.dtype}")
    if vals.dtype not in DTYPE_CODES or x.dtype != vals.dtype:
        raise TypeError(f"{name}: values and source must share float32, "
                        f"float64 or bfloat16, got {vals.dtype} and "
                        f"{x.dtype}")
    if idx.ndim != idx_ndim or vals.ndim != vals_ndim or x.ndim not in x_ndims:
        raise ValueError(f"{name}: bad ranks {idx.ndim}/{vals.ndim}/{x.ndim}")
    if vals.shape[:3] != idx.shape or x.shape[0] != idx.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(idx.shape)}, "
                         f"{tuple(vals.shape)}, {tuple(x.shape)} disagree")
    dev = x.device
    if idx.device != dev or vals.device != dev:
        raise ValueError(f"{name}: operands lie on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not (idx.is_contiguous() and vals.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: CUDA operands must be contiguous")
    return True


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y[d, i] = Σ_k vals[d, i, k] · x[d, cols[d, i, k]]`` → ``[D, n]``."""
    if not check_operands("ell_spmv", cols, vals, x, 3, 3, (2,)):
        return ell_spmv_ref(cols, vals, x)
    D, n, K = cols.shape
    m = x.shape[1]
    if D == 0 or n == 0 or K == 0 or m == 0:
        return torch.zeros((D, n), dtype=vals.dtype, device=x.device)
    y = torch.empty((D, n), dtype=vals.dtype, device=x.device)
    rc = kernel("ell_spmv")(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                            y.data_ptr(), D, n, K, m,
                            DTYPE_CODES[vals.dtype],
                            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("ell_spmv", rc)
    note(ell_spmv)
    return y


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``Y[d, i, :] = Σ_k vals[d, i, k] · X[d, cols[d, i, k], :]`` →
    ``[D, n, k]``; one pass over A's slots serves all k columns."""
    if not check_operands("ell_spmm", cols, vals, x, 3, 3, (3,)):
        return ell_spmm_ref(cols, vals, x)
    D, n, K = cols.shape
    m, k = x.shape[1:]
    if D == 0 or n == 0 or K == 0 or m == 0 or k == 0:
        return torch.zeros((D, n, k), dtype=vals.dtype, device=x.device)
    y = torch.empty((D, n, k), dtype=vals.dtype, device=x.device)
    rc = kernel("ell_spmm")(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                            y.data_ptr(), D, n, K, m, k,
                            DTYPE_CODES[vals.dtype],
                            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("ell_spmm", rc)
    note(ell_spmm)
    return y


ell_spmv.launches = 0
ell_spmm.launches = 0
