"""Plain PyTorch version of blockwise causal GQA attention (+ sliding
window): the port of ``repro/kernels/flash_attention/ref.py``
``attention_ref``, and what the CUDA kernel is held against."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; Hq % Hkv == 0.

    Returns [B, Hq, Sq, D] in q's type.  Scores are float32 and masked with
    -1e30 (not -inf); queries are right-aligned at Skv (the decode case).
    ``window``: attend only to keys with 0 <= q_pos - k_pos < window.
    """
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    group = q.shape[1] // k.shape[1]
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))   # in float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)


def attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int | None = None) -> torch.Tensor:
    """``attention_ref``'s function in float64 throughout, returned in
    float64: the truth a float32 result is measured against where float32
    scores are themselves inexact (keys far from zero put the scores in the
    hundreds, their differences between keys in the units)."""
    group = q.shape[1] // k.shape[1]
    q = q.double()
    k, v = (t.double().repeat_interleave(group, dim=1) for t in (k, v))
    sq, skv = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return torch.softmax(torch.where(mask, s, -torch.inf), dim=-1) @ v


def rel_err_rows(got: torch.Tensor, want: torch.Tensor) -> float:
    """The error the kernel is held to: the largest over rows (the last dim)
    of max|got - want| over the row's own max|want|.  A causal prefill's
    first rows average a few keys and hold the largest values; a row that
    averages n random keys is about sqrt(1/n) of them, so a scale taken over
    the whole output would let most rows be wrong by as much as they are
    large.  A row whose max|want| is 0 must match exactly."""
    got, want = got.double(), want.double()
    err = (got - want).abs().amax(dim=-1)
    scale = want.abs().amax(dim=-1)
    rel = torch.where(scale > 0, err / torch.where(scale > 0, scale, 1.0),
                      torch.where(err > 0, float("inf"), 0.0))
    return float(rel.max()) if rel.numel() else 0.0
