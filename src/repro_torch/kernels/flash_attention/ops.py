"""Attention in the models' time-major layout, dispatching to the kernel
wrapper or the plain version (port of
``repro/kernels/flash_attention/ops.py``)."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .ref import attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              use_kernel: bool = True) -> torch.Tensor:
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] (time-major like the models).

    Returns [B, S, Hq, D].  ``use_kernel=True`` goes through the kernel
    wrapper (the CUDA kernel for CUDA tensors, reading the time-major
    tensors in place); ``False`` runs the plain version.
    """
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if use_kernel:
        out = flash_attention(qt, kt, vt, causal=causal, window=window)
    else:
        out = attention_ref(qt, kt, vt, causal=causal, window=window)
    return out.transpose(1, 2)
