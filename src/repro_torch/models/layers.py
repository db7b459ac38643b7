"""Shared layers of the LM stack (port of ``repro/models/layers.py``):
norms, rotary embeddings, the MLP, and parameter initialisation at the
reference's scales from an explicit :class:`torch.Generator`."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- init
def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """Standard normals drawn in float32, times ``scale``, cast to ``dtype``
    (the reference's ``normal_init``; the draws themselves differ)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def dense_init(gen: torch.Generator, fan_in: int, shape, dtype,
               device) -> torch.Tensor:
    return normal_init(gen, shape, fan_in ** -0.5, dtype, device)


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the arithmetic type the reference widens to: float32 for
    bfloat16 and float32, float64 for float64 (so the same code gives a
    float64 truth)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# ---------------------------------------------------------------- norms
def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = wide(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(xf.dtype)).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = wide(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].to(xf.dtype) + p["bias"].to(xf.dtype)
    return out.to(x.dtype)


def norm_params(kind: str, d: int, dtype, device) -> dict[str, torch.Tensor]:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def make_norm(kind: str):
    return rmsnorm if kind == "rmsnorm" else layernorm


# ----------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """In float64, as the reference computes them; callers cast to float32."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`rope_freqs` as ``dtype`` (float32, or float64 for a float64
    model) on ``device``, made once: a copy from the host per call would
    stall every decode step on the card.  Always a real tensor, also when
    first asked for under ``FakeTensorMode`` (a traced dry-run)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    f = rope_freqs(head_dim, theta)
    if dtype == torch.float32:
        f = f.astype(np.float32)
    with unset_fake_temporarily():
        return torch.as_tensor(f, dtype=dtype, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (or [S]).  Half-split rotation."""
    xf = wide(x)
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device, xf.dtype)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(xf.dtype) * freqs          # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ mlp
def mlp_params(gen, d_model: int, d_ff: int, act: str, dtype,
               device) -> dict[str, torch.Tensor]:
    p = {"down": dense_init(gen, d_ff, (d_ff, d_model), dtype, device),
         "up": dense_init(gen, d_model, (d_model, d_ff), dtype, device)}
    if act in ("silu", "geglu"):   # gated: two up projections
        p["gate"] = dense_init(gen, d_model, (d_model, d_ff), dtype, device)
    return p


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated (silu / geglu) or plain gelu MLP; ``mlp_bias`` is ignored, as in
    the reference.  gelu is the tanh approximation (``jax.nn.gelu``'s
    default)."""
    if act in ("silu", "geglu"):
        g = x @ p["gate"]
        u = x @ p["up"]
        h = (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * u
    else:
        h = F.gelu(x @ p["up"], approximate="tanh")
    return h @ p["down"]
