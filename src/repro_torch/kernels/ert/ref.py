"""Plain PyTorch versions of the ERT micro-kernels (``csrc/ert.cu``): the
CPU path of their wrappers and what the card's results are held to."""
from __future__ import annotations

import torch


def ert_stream_ref(x: torch.Tensor, t: int, a: float, c: float) -> torch.Tensor:
    """``y = x``, then ``y = y a + c`` ``t`` times (one kernel a step in
    eager PyTorch; the kernel fuses each step into one FMA)."""
    y = x.clone()
    for _ in range(t):
        y = torch.addcmul(torch.full_like(y, c), y, torch.full_like(y, a))
    return y


def ert_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``y[i] = x[idx[i]]``."""
    return x[idx.long()]
