"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
``repro/train/optimizer.py``): float32 moments whatever the parameters'
type, the update computed in float32 and written back in the parameters'
type (float64 throughout for float64 parameters and moments: the truth a
float32 step is held to).

Parameters, gradients and moments are dicts keyed by the parameter's name
(an :class:`~repro_torch.models.model.LM`'s ``named_parameters()``).  The
reference decays a leaf when its array has two dims or more, and its
arrays are stacked: a layer inside a pattern group carries a leading group
dim, so a grouped layer's norm scale ``[n_groups, d]`` is decayed while a
remainder layer's ``[d]`` and ``final_norm`` are not.  The port keeps one
tensor per layer, so :func:`decay_mask` applies that rule to the shape the
reference would see (:func:`reference_ndim`), not to the tensor's own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..core.nap_collectives import group_reduce, implicit_replication
from ..models.layers import wide
from ..models.model import layer_slot


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step`` (float32 arithmetic, as the
    reference's): linear warmup, then cosine down to ``min_lr_ratio``."""
    f = np.float32
    step = f(step)
    warm = step / f(max(cfg.warmup_steps, 1))
    prog = (step - f(cfg.warmup_steps)) / f(max(cfg.total_steps
                                                - cfg.warmup_steps, 1))
    prog = np.clip(prog, f(0.0), f(1.0))
    cos = f(cfg.min_lr_ratio) + (f(1) - f(cfg.min_lr_ratio)) * f(0.5) * (
        f(1) + np.cos(f(math.pi) * prog))
    return float(f(cfg.lr) * (warm if step < cfg.warmup_steps else cos))


def reference_ndim(cfg, name: str, t: torch.Tensor) -> int:
    """The number of dims the reference's array for the LM parameter
    ``name`` has: one more than ``t``'s for a layer inside a pattern group
    (stacked over the groups, :func:`~repro_torch.models.model.layer_slot`),
    ``t``'s own otherwise."""
    if name.startswith("layers."):
        g, _ = layer_slot(cfg, int(name.split(".")[1]))
        if g is not None:
            return t.ndim + 1
    return t.ndim


def decay_mask(cfg, params: dict) -> dict[str, bool]:
    """The reference's decay rule (``p.ndim >= 2``) on the reference's
    stacked shapes, by name."""
    return {n: reference_ndim(cfg, n, p) >= 2 for n, p in params.items()}


def init_opt_state(params: dict, moment_dtype=torch.float32) -> dict:
    """``{"m", "v"}``: zeros like each parameter in ``moment_dtype``
    (bfloat16 halves the moments' memory; the update still runs in
    float32), ``"count"``: the steps taken, a 0-d int32 CPU tensor."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (float64 for
    float64 leaves).  DTensor leaves are summed rank by rank (a leaf's
    local sum divided by the ranks it is replicated over) and the total is
    reduced once over the whole group: one all-reduce for the whole tree,
    a plain 0-d tensor on every rank."""
    leaves = list(tree.values())
    if not any(isinstance(t, DTensor) for t in leaves):
        return torch.sqrt(sum(torch.sum(wide(t) ** 2) for t in leaves))
    total = None
    for t in leaves:
        loc = torch.sum(wide(t.to_local()) ** 2)
        reps = math.prod(t.device_mesh.size(i) for i, p in
                         enumerate(t.placements) if p.is_replicate())
        loc = loc / reps
        total = loc if total is None else total + loc
    return torch.sqrt(group_reduce(total, "sum"))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict,
                 decay: dict[str, bool] | None = None):
    """One AdamW step.  ``params`` are updated in place (the reference
    returns new arrays); ``decay`` says which parameters decay (default:
    the reference's ``ndim >= 2`` on each tensor's own shape; an LM's
    parameters need :func:`decay_mask`).  Returns (params, new state,
    ``{"grad_norm", "lr"}``).

    DTensor leaves: each parameter is updated where its moments live (the
    gradient and the parameter redistributed to the moments' placements: a
    local slice where ZeRO shards the moments) and gathered back to its
    own placements."""
    count = int(state["count"]) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, count)
    f = np.float32
    c1 = float(f(1) - f(cfg.b1) ** f(count))
    c2 = float(f(1) - f(cfg.b2) ** f(count))
    new_m, new_v = {}, {}
    sharded = any(isinstance(p, DTensor) for p in params.values())
    with implicit_replication() if sharded else contextlib.nullcontext():
        for name, p in params.items():
            m, v = state["m"][name], state["v"][name]
            pw = p.to(torch.promote_types(wide(p).dtype, m.dtype))
            g = grads[name]
            if isinstance(m, DTensor):     # where the moments live
                pw = pw.redistribute(m.device_mesh, m.placements)
                g = g.redistribute(m.device_mesh, m.placements)
            g = g.to(pw.dtype) * scale.to(pw.dtype)
            m32 = cfg.b1 * m.to(pw.dtype) + (1 - cfg.b1) * g
            v32 = cfg.b2 * v.to(pw.dtype) + (1 - cfg.b2) * g * g
            step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
            decays = p.ndim >= 2 if decay is None else decay[name]
            if decays:
                step = step + cfg.weight_decay * pw
            new_p = (pw - lr * step).to(p.dtype)
            if isinstance(new_p, DTensor):
                new_p = new_p.redistribute(p.device_mesh, p.placements)
            p.copy_(new_p)
            new_m[name], new_v[name] = m32.to(m.dtype), v32.to(v.dtype)
    new_state = {"m": new_m, "v": new_v,
                 "count": torch.tensor(count, dtype=torch.int32)}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
