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

* :func:`moe_ep_shardmap` — the reference's ``shard_map`` region on a
  :class:`~torch.distributed.device_mesh.DeviceMesh`: a ``local_map``
  around :func:`moe_ffn_ep` on DTensor activations and weights, experts
  over the EP axes, d_ff over the TP axis (the down projection's partial
  sums all-reduced over it).

The experts' three batched products are ``torch.matmul`` (the reference's
are ``jnp.einsum`` outside any Pallas kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..core.nap_collectives import (RankGroups, from_local, hier_all_to_all,
                                    local_region, replicate, summed_grad)
from .act_sharding import (constrain, constrain_moe_buf, current,
                           placements_of)
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
    # bincount's length depends on the data; a scatter-add of ones into
    # n_experts slots counts the same with a static shape (a traced dry-run
    # needs one)
    counts = torch.zeros(n_experts, dtype=sorted_e.dtype,
                         device=sel.device).scatter_add_(
        0, sorted_e, torch.ones_like(sorted_e))
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


def _moe_tp_sharded(p, cfg, x):
    """:func:`moe_ffn_tp` on DTensors (the reference's TP regime under
    GSPMD).  The dispatch is over the global token order (its capacity
    from all T tokens, as the reference's), and DTensor has no rule for
    its stable sort and scatter-add, so every rank gathers the tokens and
    builds the ``[E, cap, d]`` buffer alike; then, as the reference's
    ``constrain_moe_buf`` lays it out, each rank runs the experts on its
    share of the capacity dim (over dp) with d_ff over the model axis (the
    weights' FSDP ``data`` sharding gathered at use), the down projection's
    partial sums are reduce-scattered over d, and the buffer is gathered
    back for each rank's combine of its own rows."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    rep = [replicate()] * mesh.ndim
    b, s, d = x.shape
    x_all = x.redistribute(mesh, rep).to_local().reshape(-1, d)
    router = p["router"].redistribute(mesh, rep).to_local()
    probs, sel = _route(x_all, router, cfg.top_k)
    cap = _capacity(x_all.shape[0], cfg)
    e_id, pos = _dispatch_indices(sel, cfg.n_experts, cap)
    buf, safe_pos, keep = _scatter(x_all, e_id, pos, cap, cfg.n_experts,
                                   cfg.top_k)
    spec = current("moe_buf_spec")
    buf = from_local(buf, mesh, rep)
    if spec is not None:   # the capacity dim over dp (d stays whole here)
        buf = constrain(buf, (spec[0], spec[1], None))

    def keep_f(w, f_dim):
        return w.redistribute(mesh, [
            pl if isinstance(pl, Shard) and pl.dim == f_dim else replicate()
            for pl in w.placements])

    w = {"gate": keep_f(p["gate"], 2), "up": keep_f(p["up"], 2),
         "down": keep_f(p["down"], 1)}
    out_buf = constrain_moe_buf(_expert_ffn(w, buf, cfg.act))
    out_buf = out_buf.redistribute(mesh, rep).to_local()
    y = _combine(out_buf, e_id, safe_pos, keep, probs, cfg.top_k)
    y = from_local(y.reshape(b, s, d), mesh, rep)
    return y.redistribute(mesh, x.placements)


def moe_ffn_tp(p, cfg, x: torch.Tensor, stats: dict | None = None):
    """All experts on this card.  x: [B, S, d] → [B, S, d].  ``stats``, when
    given, gains the (token, slot) selections (``"selected"``) and the ones
    the capacity dropped (``"dropped"``).  DTensor operands: see
    :func:`_moe_tp_sharded`."""
    if isinstance(x, DTensor):
        return _moe_tp_sharded(p, cfg, x)
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
    buf = constrain_moe_buf(buf)        # keep the capacity dim dp-sharded
    out_buf = constrain_moe_buf(_expert_ffn(p, buf, cfg.act))
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
    and the shuffles run between the processes.  ``tp_axis``: the
    :class:`~repro_torch.core.nap_collectives.RankGroups` of a TP group
    over which this rank's slabs hold a share of d_ff (one process per
    rank); the down projection's partial sums are all-reduced over it,
    and the gradient of the slabs' input likewise in the backward."""
    if tp_axis is not None and ranks is None:
        raise ValueError("moe_ffn_ep: tp_axis (d_ff over a TP group) needs "
                         "ranks= (one process per rank)")
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
    if tp_axis is not None:     # each member's gradient: its d_ff slice's
        h = tp_axis.grad_sum(h, "world")
    y = _expert_ffn(p, h, cfg.act)                      # [R, e_loc, m*cap, d]
    if tp_axis is not None:     # one axis: the flat sum is the strategy
        y = tp_axis.all_reduce(y, "world", log=log)
    y = y.reshape(R, e_loc, m, cap, d).transpose(1, 2)
    back = shuffle(y).reshape(R * E, cap, d)            # the send layout
    return _combine(back, e_id, safe_pos, keep, probs,
                    cfg.top_k).reshape(R, T, d)


def moe_ep_shardmap(p, cfg, x, mesh, dp_axes=("data",), ep_axes=("data",),
                    tp_axis="model", nap: bool = False, seq_axis=None):
    """Expert-parallel MoE as a ``local_map`` region (the reference's
    ``shard_map`` production path) on a
    :class:`~torch.distributed.device_mesh.DeviceMesh`.  Experts are
    sharded over ``ep_axes`` (by default the intra-pod "data" axis: the
    dispatch never crosses pods), d_ff over ``tp_axis``; x ``[B, S, d]``
    has its batch over ``dp_axes`` (and S over ``seq_axis``).  Inside, each
    rank runs :func:`moe_ffn_ep` on its tokens with its slabs, the shuffles
    between the ranks of its EP group
    (:meth:`~repro_torch.core.nap_collectives.RankGroups.from_mesh`)."""

    B, S, d = x.shape
    ep = ep_axes if len(ep_axes) > 1 else ep_axes[0]
    x_pl = placements_of(mesh, (dp_axes if dp_axes else None, seq_axis, None))
    w_pl = placements_of(mesh, (ep, None, tp_axis))
    wd_pl = placements_of(mesh, (ep, tp_axis, None))
    ranks = RankGroups.from_mesh(mesh, ep_axes)
    tp = RankGroups.from_mesh(mesh, (tp_axis,)) if tp_axis else None
    ep_mesh = (ranks.n_pods, ranks.lanes) if len(ep_axes) == 2 else \
        (ranks.lanes,)

    def body(xl, router, gate, up, down):
        pl = {"router": router, "gate": gate[None], "up": up[None],
              "down": down[None]}
        out = moe_ffn_ep(pl, cfg, xl.reshape(1, -1, d), ep_mesh, nap=nap,
                         tp_axis=tp, ranks=ranks)
        return out.reshape(xl.shape)

    rep = placements_of(mesh, ())
    ins = (x_pl, rep, w_pl, w_pl, wd_pl)
    # a weight whole over a dim that shards the tokens: summed gradients
    return local_region(body, list(x_pl), ins, mesh, redistribute_inputs=True,
                        in_grad_placements=tuple(summed_grad(pl, x_pl)
                                                 for pl in ins))(
        x, p["router"], p["gate"], p["up"], p["down"])
