"""GQA attention block of the LM stack (port of ``repro/models/attention.py``):
QKV projection with bias and per-head qk-norm, RoPE, sliding window, and the
full-sequence (prefill) attention through the flash-attention kernel.

``chunked_attention`` and the unused ``attn_decode`` of the reference are
not ported; decoding goes through :func:`repro_torch.models.model.
attn_decode_cached`."""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import attention
from .layers import apply_rope, dense_init, norm_params, rmsnorm


def attn_params(gen, cfg, dtype, device) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, (d, hq * dh), dtype, device),
        "wk": dense_init(gen, d, (d, hkv * dh), dtype, device),
        "wv": dense_init(gen, d, (d, hkv * dh), dtype, device),
        "wo": dense_init(gen, hq * dh, (hq * dh, d), dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = norm_params("rmsnorm", dh, dtype, device)
        p["k_norm"] = norm_params("rmsnorm", dh, dtype, device)
    return p


def _project_qkv(p, cfg, x: torch.Tensor):
    """x: [B, S, d] → q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh]: bias, then the
    per-head qk-norm after the reshape."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    return q, k, v


def attn_forward(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                 window: int | None = None, use_kernel: bool = True):
    """Full-sequence attention (prefill).  x: [B, S, d].  Returns
    (out [B, S, d], (k, v)) with k/v the post-RoPE keys and values
    ``[B, S, Hkv, Dh]`` for the cache.  ``use_kernel=False`` runs the plain
    version of the same function."""
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    win = window if window is not None else cfg.window
    out = attention(q, k, v, causal=True, window=win, use_kernel=use_kernel)
    b, s = x.shape[:2]
    return out.reshape(b, s, -1) @ p["wo"], (k, v)
