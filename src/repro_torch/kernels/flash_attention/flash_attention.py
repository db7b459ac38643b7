"""Causal GQA flash attention: the wrapper of the hand-written CUDA kernels
``csrc/flash_attention.cu`` (``mma.sync``: float32 as 3xTF32 at head dims 64
and 128), ``csrc/flash_attention_tf32.cu`` (float32 as 3xTF32 on ``wgmma``
fed by TMA, warp-specialised, at head dims 96 and 256) and
``csrc/flash_attention_wgmma.cu`` (bfloat16: ``wgmma`` fed by TMA,
warp-specialised), one C signature for all three.

They replace the Pallas kernel ``flash_attention`` of
``repro/kernels/flash_attention/flash_attention.py``.  Layout
``[B, H, S, D]``: q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Skv, D]`` with
``Hq % Hkv == 0``; queries are right-aligned at Skv.  The operands may be
strided views (the models' time-major ``[B, S, H, D]`` tensors transposed)
as long as the D dim is contiguous; the output has q's strides.

:data:`ROUTE` says which kernel serves a (dtype, head dim).  The wrapper
takes the plain version (:mod:`.ref`) only for tensors that lie on the CPU;
for CUDA tensors it launches the routed kernel on the current stream or
raises (no fallback to the other kernel).  ``flash_attention.launches``
counts the launches the device ran, and ``flash_attention.by_kernel[name]
.launches`` those of each kernel.
"""
from __future__ import annotations

import torch

from ..build import kernel
from ..launches import note
from .ref import attention_ref

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 96, 128, 256)
# The kernel (its name in ``build.KERNELS``) that serves each (dtype, head
# dim).  float32 runs 3xTF32: on mma.sync at head dims 64 and 128, on the
# Hopper design at 96 and 256 (phi-3-vision-4.2b's and recurrentgemma-9b's
# heads; PERF.md has both designs' times); bfloat16 runs the Hopper design at
# every head dim: an H100 ran it 1.7-2.5x faster than the bfloat16 mma.sync
# instances it replaced, at each served shape (PERF.md).
TF32_HEAD_DIMS = (96, 256)
ROUTE = {**{(torch.float32, d): "flash_attention_tf32" if d in TF32_HEAD_DIMS
            else "flash_attention" for d in HEAD_DIMS},
         **{(torch.bfloat16, d): "flash_attention_wgmma" for d in HEAD_DIMS}}


class KernelLaunches:
    """The launch count of one of the wrapper's kernels (``.launches``,
    counted by :func:`..launches.note` as a wrapper's is), so that a run
    shows which kernel served it."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves ``dtype`` at ``head_dim``; a head dim outside
    :data:`HEAD_DIMS` goes to ``flash_attention``, whose C side refuses it."""
    return ROUTE.get((dtype, head_dim), "flash_attention")


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int | None) -> bool:
    """Validate the operands; True when they lie on a CUDA device (the
    kernel runs), False when on the CPU (the plain version runs)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}; want q "
                         f"[B, Hq, Sq, D] and k = v [B, Hkv, Skv, D]")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree (Hq % Hkv must be 0)")
    if Sq > Skv:
        # queries are right-aligned at Skv, so a row i < Sq - Skv would see
        # no key at all; the Pallas kernel and attention_ref disagree on
        # such rows, and the models never make them
        raise ValueError(f"flash_attention: Sq = {Sq} > Skv = {Skv}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window = {window} < 1 hides "
                         f"every key")
    if q.dtype != k.dtype or v.dtype != k.dtype:
        raise TypeError(f"flash_attention: q, k, v types differ: {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: operands lie on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{HEAD_DIMS}, got {D}")
    # rows are read in 16-byte pieces (float32 loads; bfloat16 by TMA, whose
    # strides and base address must be multiples of 16 bytes), so every row
    # must start 16-byte aligned
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must have a contiguous, "
                             f"16-byte aligned D dim and strides that are "
                             f"multiples of {vec} ({q.dtype}), got strides "
                             f"{t.stride()}")
    if B * Hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {B * Hq} > 65535")
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] → [B, Hq, Sq, D]."""
    if not check_operands(q, k, v, window):
        return attention_ref(q, k, v, causal=causal, window=window)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)          # q's strides (dense, non-overlapping)
    if B == 0 or Hq == 0 or Sq == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    name = route(q.dtype, D)
    rc = kernel(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, Sq, Skv, D, *strides, int(causal),
        -1 if window is None else int(window), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: {name} launch failed with CUDA "
                           f"error {rc}")
    note(flash_attention)
    note(flash_attention.by_kernel[name])
    return out


flash_attention.launches = 0
flash_attention.by_kernel = {n: KernelLaunches(n) for n in sorted(set(ROUTE.values()))}
