"""Mixture-of-Experts block (port of ``repro/models/moe.py``).

Routing: full softmax over the experts in float32 → top-k → renormalise
(qwen-style).  Each expert takes at most ``cap = max(int(T · k / E ·
capacity_factor), 1)`` tokens; a token past that is dropped in token order
(its combine weight is zero), as in the reference.

* :func:`moe_ffn_tp` — every expert on this card, tokens stay put: the
  single-card path of :class:`~repro_torch.models.model.LM`.
* :func:`moe_ffn_ep` — expert parallel over rank-stacked tensors (or one
  process per rank): each rank holds ``E / D`` experts, and its tokens go to
  the experts' ranks and back through
  :func:`~repro_torch.core.nap_collectives.hier_all_to_all` — the paper's
  NAP-3 applied to MoE dispatch when ``nap`` is set.

The experts' three batched products are ``torch.matmul`` (the reference's
are ``jnp.einsum`` outside any Pallas kernel).  The training-time sharding
of the reference (``moe_ep_shardmap`` with d_ff sharded over a TP axis, the
``act_sharding`` constraints) is not ported (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.nap_collectives import hier_all_to_all
from .layers import dense_init


def moe_params(gen, cfg, dtype, device) -> dict:
    """The router stays float32 whatever ``dtype`` is: a rounded router
    picks other experts."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    return {"router": dense_init(gen, d, (d, e), torch.float32, device),
            "gate": dense_init(gen, d, (e, d, f), dtype, device),
            "up": dense_init(gen, d, (e, d, f), dtype, device),
            "down": dense_init(gen, f, (e, f, d), dtype, device)}


def _route(x2: torch.Tensor, router: torch.Tensor, top_k: int):
    """x2: [T, d] → (probs [T, k] float32, sel [T, k] int64)."""
    probs = torch.softmax(x2.float() @ router, dim=-1)
    pv, sel = torch.topk(probs, top_k, dim=-1)
    return pv / pv.sum(-1, keepdim=True).clamp_min(1e-9), sel


def _dispatch_indices(sel: torch.Tensor, n_experts: int, capacity: int):
    """Per (token, slot): expert id and position within the expert's queue
    (``>= capacity`` if dropped), by a stable sort over the experts: no
    ``[T, E, C]`` tensor.  A token picks an expert once, so a position
    depends on the token order only, not on the order of the k slots."""
    T, k = sel.shape
    flat_e = sel.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(sorted_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * k, device=sel.device) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return flat_e.reshape(T, k), pos.reshape(T, k)


def _expert_ffn(w, h: torch.Tensor, act: str) -> torch.Tensor:
    """Batched expert FFN: h ``[..., e, c, d]`` with ``w``'s slabs ``[...,
    e, d, f]`` / ``[..., e, f, d]``."""
    g = torch.matmul(h, w["gate"])
    u = torch.matmul(h, w["up"])
    gated = (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * u
    return torch.matmul(gated, w["down"])


def _capacity(T: int, cfg) -> int:
    return max(int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)


def _scatter(x2, e_id, pos, cap: int, n_slabs: int, top_k: int):
    """Tokens into ``[n_slabs, cap, d]`` (each kept (token, slot) at its
    expert's position); dropped entries add exact zeros into slot
    ``cap - 1``, as the reference's scatter-add does.  Returns the buffer,
    the clamped positions and the keep mask."""
    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap - 1)
    buf = torch.zeros((n_slabs, cap, x2.shape[-1]), dtype=x2.dtype,
                      device=x2.device)
    src = torch.where(keep.reshape(-1, 1),
                      x2.repeat_interleave(top_k, dim=0), 0)
    buf.index_put_((e_id.reshape(-1), safe_pos.reshape(-1)), src,
                   accumulate=True)
    return buf, safe_pos, keep


def _combine(out_buf, e_id, safe_pos, keep, probs, top_k: int):
    """Each (token, slot)'s expert output back, weighted and summed over
    the k slots: ``[T, d]``."""
    y = out_buf[e_id.reshape(-1), safe_pos.reshape(-1)]
    y = y * (probs.reshape(-1, 1) * keep.reshape(-1, 1)).to(y.dtype)
    return y.reshape(-1, top_k, y.shape[-1]).sum(dim=1)


def moe_ffn_tp(p, cfg, x: torch.Tensor, stats: dict | None = None):
    """All experts on this card.  x: [B, S, d] → [B, S, d].  ``stats``, when
    given, gains the (token, slot) selections (``"selected"``) and the ones
    the capacity dropped (``"dropped"``)."""
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    probs, sel = _route(x2, p["router"], cfg.top_k)
    cap = _capacity(x2.shape[0], cfg)
    e_id, pos = _dispatch_indices(sel, cfg.n_experts, cap)
    buf, safe_pos, keep = _scatter(x2, e_id, pos, cap, cfg.n_experts,
                                   cfg.top_k)
    if stats is not None:     # the dropped count stays on the device
        stats["selected"] = stats.get("selected", 0) + keep.numel()
        stats["dropped"] = stats.get("dropped", 0) + (~keep).sum()
    out_buf = _expert_ffn(p, buf, cfg.act)
    return _combine(out_buf, e_id, safe_pos, keep, probs,
                    cfg.top_k).reshape(b, s, d)


def moe_ffn_ep(p, cfg, x: torch.Tensor, mesh: tuple[int, ...],
               nap: bool = False, tp_axis=None, log: list | None = None,
               ranks=None) -> torch.Tensor:
    """Expert parallel over the ranks of ``mesh`` (one or two axis sizes,
    pod-major: ``(n_pods, lanes)`` or ``(D,)``).

    ``x``: the ranks' token blocks ``[D, T_loc, d]``; ``p``: the router
    ``[d, E]`` (every rank's) and the local expert slabs ``[D, e_loc, d,
    f]`` / ``[D, e_loc, f, d]`` (rank ``r`` holds experts ``r·e_loc`` to
    ``(r+1)·e_loc - 1``).  Each rank routes its tokens with a capacity from
    ``T_loc``, packs ``[E, cap, d]`` and sends each expert's rows to its
    rank through :func:`hier_all_to_all` (two axes: ``"nap3"`` when ``nap``,
    else ``"flat"``; one axis: one all-to-all); the outputs come back the
    same way.  ``log`` gains both shuffles' steps.  With ``ranks`` (one
    process per rank), ``x`` and the slabs are this process's ``[1, ...]``
    and the shuffles run between the processes."""
    if tp_axis is not None:
        raise NotImplementedError(
            "moe_ffn_ep: d_ff sharded over a TP axis inside EP "
            "(moe_ep_shardmap's tp_axis) is not ported yet (ROADMAP queue 1 "
            "item 13)")
    if len(mesh) == 2:
        (n_pods, lanes), strategy = mesh, ("nap3" if nap else "flat")
    elif len(mesh) == 1:
        # a single expert-parallel axis: nothing hierarchical to route
        n_pods, lanes, strategy = 1, mesh[0], "flat"
    else:
        raise ValueError(f"moe_ffn_ep: mesh {mesh} has {len(mesh)} axes")
    m = math.prod(mesh)
    if ranks is not None and (ranks.size != m or len(mesh) == 2 and tuple(
            mesh) != (ranks.n_pods, ranks.lanes)):
        raise ValueError(f"moe_ffn_ep: mesh {mesh} over the ranks' "
                         f"{ranks.n_pods} x {ranks.lanes} grid")
    R, T, d = x.shape                  # R = m stacked, or 1 in a process
    E = cfg.n_experts
    if E % m:
        raise ValueError(f"moe_ffn_ep: {E} experts over {m} ranks")
    e_loc = E // m
    probs, sel = _route(x.reshape(-1, d), p["router"], cfg.top_k)
    cap = _capacity(T, cfg)
    # one dispatch over all R ranks' tokens: expert ids offset by the rank,
    # so each (rank, expert) queue holds that rank's tokens in their order
    rank_of = torch.arange(R, device=x.device).repeat_interleave(T)[:, None]
    e_id, pos = _dispatch_indices(sel + E * rank_of, R * E, cap)
    send, safe_pos, keep = _scatter(x.reshape(-1, d), e_id, pos, cap, R * E,
                                    cfg.top_k)

    def shuffle(buf):
        return hier_all_to_all(buf.reshape(R, m, -1), n_pods, lanes,
                               strategy, log=log, ranks=ranks)

    recv = shuffle(send).reshape(R, m, e_loc, cap, d)    # [.., peers, e_loc]
    h = recv.transpose(1, 2).reshape(R, e_loc, m * cap, d)
    y = _expert_ffn(p, h, cfg.act)                      # [R, e_loc, m*cap, d]
    y = y.reshape(R, e_loc, m, cap, d).transpose(1, 2)
    back = shuffle(y).reshape(R * E, cap, d)            # the send layout
    return _combine(back, e_id, safe_pos, keep, probs,
                    cfg.top_k).reshape(R, T, d)
