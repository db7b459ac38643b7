"""Wrappers of the ERT micro-kernels (``csrc/ert.cu``): on a CUDA tensor
they launch the kernel on the current stream (or raise), on a CPU tensor
they run the plain version (:mod:`.ref`).  ``<wrapper>.launches`` counts
the launches (:mod:`..launches`)."""
from __future__ import annotations

import torch

from ..build import kernel
from ..launches import note
from ..spmv.spmv import FLOAT_DTYPES, raise_on_error
from .ref import ert_gather_ref, ert_stream_ref


def _check(name: str, x: torch.Tensor, *others: torch.Tensor) -> bool:
    if x.dtype not in FLOAT_DTYPES or x.ndim != 1:
        raise TypeError(f"{name}: a 1-D float32 or float64 tensor, got "
                        f"{x.dtype}{tuple(x.shape)}")
    if any(t.device != x.device for t in others):
        raise ValueError(f"{name}: operands lie on different devices")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, *others)):
        raise ValueError(f"{name}: CUDA operands must be contiguous")
    return True


def ert_stream(x: torch.Tensor, t: int, a: float = 1.0000001,
               c: float = 0.5) -> torch.Tensor:
    """``t`` fused multiply-adds ``y = y a + c`` on every element of ``x``
    (2t FLOPs, one read and one write an element)."""
    if t < 1:
        raise ValueError(f"ert_stream: t = {t} < 1")
    if not _check("ert_stream", x):
        return ert_stream_ref(x, t, a, c)
    y = torch.empty_like(x)
    rc = kernel("ert_stream")(
        x.data_ptr(), y.data_ptr(), x.numel(), int(t), float(a), float(c),
        int(x.dtype == torch.float64),
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("ert_stream", rc)
    note(ert_stream)
    return y


def ert_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``y[i] = x[idx[i]]`` (``idx`` int32, values in ``[0, len(x))``)."""
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise TypeError(f"ert_gather: idx must be 1-D int32, got "
                        f"{idx.dtype}{tuple(idx.shape)}")
    if not _check("ert_gather", x, idx):
        return ert_gather_ref(x, idx)
    y = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    rc = kernel("ert_gather")(
        x.data_ptr(), idx.data_ptr(), y.data_ptr(), idx.numel(),
        int(x.dtype == torch.float64),
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("ert_gather", rc)
    note(ert_gather)
    return y


ert_stream.launches = 0
ert_gather.launches = 0
