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

    The kernel has no backward, as the reference's Pallas kernel has no
    VJP (``jax.grad`` through it fails): with grad mode on and an operand
    that requires grad, ``use_kernel=True`` raises on either device rather
    than return an output that autograd cannot see through.  Training runs
    with ``use_kernel=False``, as the reference's ``TrainOptions`` does.
    """
    if use_kernel and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention: the kernel has no backward (nor has the "
            "reference's Pallas kernel a VJP); call with use_kernel=False "
            "to differentiate, or under torch.no_grad() to serve")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if use_kernel:
        out = flash_attention(qt, kt, vt, causal=causal, window=window)
    else:
        out = attention_ref(qt, kt, vt, causal=causal, window=window)
    return out.transpose(1, 2)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: int | None) -> torch.Tensor:
    """:func:`attention` through the kernel (causal) as a custom operator,
    so that a trace under ``FakeTensorMode`` (the dry-run) sees one opaque
    op with a registered fake instead of the wrapper's launch."""
    return attention(q, k, v, causal=True, window=window,
                     use_kernel=True).contiguous()


@flash_op.register_fake
def _flash_op_fake(q, k, v, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)
