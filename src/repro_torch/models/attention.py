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
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..core.nap_collectives import local_region, summed_grad
from ..kernels.flash_attention.ops import attention, flash_op
from ..kernels.flash_attention.ref import attention_ref
from .act_sharding import constrain_kv, constrain_out, constrain_q
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


def _chunk_step(acc, m, l, qf, kch, vch, k0: int, skv: int, causal: bool,
                window, group: int, scale: float, q0: int = 0):
    """One key chunk of the online softmax: keys ``k0 ..`` of ``kch``/``vch``
    ``[B, Hkv, ck, D]`` folded into (acc ``[B, Hq, Sq, D]``, m, l ``[B, Hq,
    Sq]``, in the arithmetic type); query ``i`` sits at position ``q0 + i``
    of the ``skv`` keys."""
    ck = kch.shape[2]
    kch = kch.to(qf.dtype).repeat_interleave(group, dim=1)
    vch = vch.to(qf.dtype).repeat_interleave(group, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", qf, kch) * scale
    qpos = q0 + torch.arange(qf.shape[2], device=qf.device)[:, None]
    kpos = k0 + torch.arange(ck, device=qf.device)[None, :]
    mask = kpos < skv
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
                      chunk: int = CHUNK, q_offset: int = 0) -> torch.Tensor:
    """Attention as an online softmax over key chunks, in plain torch (the
    reference's, not a kernel): the S x S scores never exist at once, the
    largest transient is ``[B, Hq, S, chunk]``.  q: ``[B, S, Hq, D]``, k/v
    ``[B, S, Hkv, D]`` time-major → ``[B, S, Hq, D]`` in q's type.  Keys are
    zero-padded to a multiple of the chunk and masked; every chunk step
    runs under ``torch.utils.checkpoint`` when grad mode is on (the
    reference's ``jax.checkpoint``: the backward recomputes a chunk's scores
    instead of keeping all of them).  ``q_offset``: the queries are the keys'
    positions ``q_offset ..`` (a sequence-parallel rank's query block; k/v
    may then be longer than q)."""
    b, s, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    ck = min(chunk, skv)
    pad = (-skv) % ck
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
    for c in range((skv + pad) // ck):
        args = (acc, m, l, qf, kt[:, :, c * ck:(c + 1) * ck],
                vt[:, :, c * ck:(c + 1) * ck], c * ck, skv, causal, window,
                group, scale, q_offset)
        acc, m, l = (checkpoint(_chunk_step, *args, use_reentrant=False)
                     if remat else _chunk_step(*args))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _core(q, k, v, win, use_kernel: bool, chunk: int, q_offset: int = 0):
    """The attention of time-major q ``[B, Sq, Hq, D]`` over k/v ``[B, Skv,
    Hkv, D]``, dispatched as :func:`attn_forward` says."""
    s = q.shape[1]
    if use_kernel:
        return flash_op(q, k, v, win)
    if s > chunk or q_offset or k.shape[1] != s:
        return chunked_attention(q, k, v, causal=True, window=win, chunk=chunk,
                                 q_offset=q_offset)
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=True,
                         window=win).transpose(1, 2)


def sharded_attention(q, k, v, win, use_kernel: bool, chunk: int = CHUNK):
    """:func:`_core` on DTensor q/k/v, one rank's share at a time (a
    ``local_map`` region: the attention of one (batch, head) row needs no
    other rank's data once each rank holds its rows).  q's placements are
    kept: batch over dp, heads over model (or, sequence-parallel, the query
    positions over model against whole k/v).  Where q's heads are sharded
    and k/v's replicated, a rank takes the kv heads of its own query heads;
    a rank's query positions start at its model coordinate times the
    block."""
    from torch.distributed.tensor import Shard

    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    qp, kp = tuple(q.placements), tuple(k.placements)
    if tuple(v.placements) != kp:
        raise ValueError(f"sharded_attention: k {kp} and v {v.placements}")
    group = q.shape[2] // k.shape[2]

    def coord_of(dim):   # this rank's index along the mesh dims sharding dim
        idx, n = 0, 1
        for i, p in enumerate(qp):
            if isinstance(p, Shard) and p.dim == dim:
                size = mesh.size(i)
                idx, n = idx * size + mesh.get_local_rank(names[i]), n * size
        return idx, n

    def body(ql, kl, vl):
        h_idx, h_n = coord_of(2)
        if h_n > 1 and kl.shape[2] == k.shape[2]:   # kv heads whole here
            hq_l = ql.shape[2]
            heads = (h_idx * hq_l + torch.arange(hq_l, device=ql.device)) \
                // group
            kl, vl = kl[:, :, heads], vl[:, :, heads]
        s_idx, _ = coord_of(1)
        out = _core(ql, kl, vl, win, use_kernel, chunk,
                    q_offset=s_idx * ql.shape[1])
        return out.reshape(out.shape[0], out.shape[1], -1)

    # [B, S, Hq, D] → [B, S, Hq·D] rank by rank: a rank's heads are one
    # contiguous block of the flattened dim, so a head sharding stays a
    # Shard(2) (DTensor's own reshape would gather the heads first)
    # k/v whole over a dim that shards q: each rank's gradient is its share
    kg = summed_grad(kp, qp)
    return local_region(body, list(qp), (qp, kp, kp), mesh,
                        in_grad_placements=(qp, kg, kg))(q, k, v)


def attn_forward(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                 window: int | None = None, use_kernel: bool = True,
                 chunk: int = CHUNK):
    """Full-sequence attention (train / prefill).  x: [B, S, d].  Returns
    (out [B, S, d], (k, v)) with k/v the post-RoPE keys and values
    ``[B, S, Hkv, Dh]`` for the cache.  As the reference: the kernel when
    ``use_kernel``, else :func:`chunked_attention` when S > ``chunk``, else
    the plain version.  On DTensor activations q/k/v take the
    activation-sharding context's specs and the attention runs rank by rank
    (:func:`sharded_attention`)."""
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain_q(q)              # sequence-parallel attention (optional)
    k, v = constrain_kv(k, v)
    win = window if window is not None else cfg.window
    b, s = x.shape[:2]
    if isinstance(q, DTensor):      # [B, S, Hq·D] already
        out = sharded_attention(q, k, v, win, use_kernel, chunk)
    elif use_kernel:
        out = attention(q, k, v, causal=True, window=win, use_kernel=True)
    else:
        out = _core(q, k, v, win, False, chunk)
    out = constrain_out(out.reshape(b, s, -1))
    return out @ p["wo"], (k, v)


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
