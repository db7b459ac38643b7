"""GQA attention block of the LM stack (port of ``repro/models/attention.py``):
QKV projection with bias and per-head qk-norm, RoPE, sliding window, and the
full-sequence attention, dispatched three ways as in the reference: the
flash-attention kernel (``use_kernel``, prefill), :func:`chunked_attention`
(the online softmax over key chunks, for sequences longer than a chunk:
training and long plain prefills) or the plain version.

:func:`attn_decode` is the reference's static-cache decode (the serving
path decodes through :func:`repro_torch.models.model.attn_decode_cached`,
the ring buffer)."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention.ops import attention
from ..kernels.flash_attention.ref import attention_ref
from .layers import apply_rope, dense_init, norm_params, rmsnorm, wide

NEG_INF = -1e30
CHUNK = 1024


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


def _chunk_step(acc, m, l, qf, kch, vch, k0: int, s: int, causal: bool,
                window, group: int, scale: float):
    """One key chunk of the online softmax: keys ``k0 ..`` of ``kch``/``vch``
    ``[B, Hkv, ck, D]`` folded into (acc ``[B, Hq, S, D]``, m, l ``[B, Hq,
    S]``, in the arithmetic type)."""
    ck = kch.shape[2]
    kch = kch.to(qf.dtype).repeat_interleave(group, dim=1)
    vch = vch.to(qf.dtype).repeat_interleave(group, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", qf, kch) * scale
    qpos = torch.arange(s, device=qf.device)[:, None]
    kpos = k0 + torch.arange(ck, device=qf.device)[None, :]
    mask = kpos < s
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    sc = torch.where(mask, sc, NEG_INF)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    pexp = torch.exp(sc - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + pexp.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", pexp, vch)
    return acc, m_new, l


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int | None = None,
                      chunk: int = CHUNK) -> torch.Tensor:
    """Attention as an online softmax over key chunks, in plain torch (the
    reference's, not a kernel): the S x S scores never exist at once, the
    largest transient is ``[B, Hq, S, chunk]``.  q: ``[B, S, Hq, D]``, k/v
    ``[B, S, Hkv, D]`` time-major → ``[B, S, Hq, D]`` in q's type.  Keys are
    zero-padded to a multiple of the chunk and masked; every chunk step
    runs under ``torch.utils.checkpoint`` when grad mode is on (the
    reference's ``jax.checkpoint``: the backward recomputes a chunk's scores
    instead of keeping all of them)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    ck = min(chunk, s)
    pad = (-s) % ck
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = d ** -0.5
    qf = wide(q).transpose(1, 2)                              # [B, Hq, S, D]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)             # [B, Hkv, S', D]
    acc = torch.zeros((b, hq, s, d), dtype=qf.dtype, device=q.device)
    m = torch.full((b, hq, s), NEG_INF, dtype=qf.dtype, device=q.device)
    l = torch.zeros((b, hq, s), dtype=qf.dtype, device=q.device)
    remat = torch.is_grad_enabled()
    for c in range((s + pad) // ck):
        args = (acc, m, l, qf, kt[:, :, c * ck:(c + 1) * ck],
                vt[:, :, c * ck:(c + 1) * ck], c * ck, s, causal, window,
                group, scale)
        acc, m, l = (checkpoint(_chunk_step, *args, use_reentrant=False)
                     if remat else _chunk_step(*args))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attn_forward(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                 window: int | None = None, use_kernel: bool = True,
                 chunk: int = CHUNK):
    """Full-sequence attention (train / prefill).  x: [B, S, d].  Returns
    (out [B, S, d], (k, v)) with k/v the post-RoPE keys and values
    ``[B, S, Hkv, Dh]`` for the cache.  As the reference: the kernel when
    ``use_kernel``, else :func:`chunked_attention` when S > ``chunk``, else
    the plain version."""
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    win = window if window is not None else cfg.window
    b, s = x.shape[:2]
    if use_kernel:
        out = attention(q, k, v, causal=True, window=win, use_kernel=True)
    elif s > chunk:
        out = chunked_attention(q, k, v, causal=True, window=win, chunk=chunk)
    else:
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True,
                            window=win).transpose(1, 2)
    return out.reshape(b, s, -1) @ p["wo"], (k, v)


def attn_decode(p, cfg, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: int):
    """One-token decode with a static-shape KV cache (the reference's
    ``attn_decode``; functional: the caches come back as new tensors).
    x: [B, 1, d]; cache_k/v: [B, S_max, Hkv, Dh]; pos: tokens so far.
    Returns (out [B, 1, d], new cache_k, new cache_v)."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    posn = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posn, cfg.rope_theta)
    k = apply_rope(k, posn, cfg.rope_theta)
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    s_max = cache_k.shape[1]
    group = cfg.n_heads // cfg.n_kv_heads
    kx = cache_k.repeat_interleave(group, dim=2).float()      # [B, S, Hq, Dh]
    vx = cache_v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * cfg.head_dim ** -0.5
    kpos = torch.arange(s_max, device=x.device)
    mask = kpos <= pos
    if cfg.window is not None:
        mask = mask & (kpos > pos - cfg.window)
    s = torch.where(mask, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", pr, vx)
    out = out.to(x.dtype).reshape(b, 1, -1)
    return out @ p["wo"], cache_k, cache_v
