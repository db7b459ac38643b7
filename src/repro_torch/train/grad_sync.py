"""Hierarchical (node-aware) gradient sync (port of
``repro/train/grad_sync.py``): the paper's NAP-3 applied to data-parallel
gradients, with optional int8 compression and error feedback on the
pod-crossing leg.

reduce-scatter (fast) → [quantize] all-reduce or int8 all-gather (slow) →
all-gather (fast).  Against a flat all-reduce over (pods × lanes), the slow
group carries 1/|fast| of the elements, and with int8 each of those is one
byte instead of four.  Error feedback adds each quantization's residual to
the next step's piece, so compression does not move the fixed point.

Gradients are trees (dicts / tuples / lists) of per-rank tensors, as the
port's collectives take them: rank-stacked ``[D, ...]`` (D = ``n_pods *
lanes``, pod-major), or with ``ranks`` (one process per rank,
:class:`~repro_torch.core.nap_collectives.RankGroups`) this process's
``[1, ...]``, the legs then collectives between the processes.  Each leg
appends its canonical name to ``log`` as the reference's legs lower:
``psum`` (flat), ``psum_scatter``, ``psum``, ``all_gather`` (nap3), and
``psum_scatter``, ``all_gather`` x 3 (int8: the codes and the scales over
the slow group, the sums over the fast one).  Over ranks each leg's
elements are tallied under the tag ``"grad"``, the int8 codes under
``"grad_int8"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.nap_collectives import (fast_all_gather, fast_reduce_scatter,
                                    hier_psum, slow_all_gather)

INT8_TAG = "grad_int8"


def quantize_int8(x: torch.Tensor, dim: int = -1):
    """Symmetric int8 over ``dim`` (per rank's piece).  Returns (q, scale)
    with ``scale`` keeping ``dim`` as size 1."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in tree for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _piece_len(numel: int, lanes: int) -> int:
    return (numel + (-numel) % lanes) // lanes


def init_error_feedback(grads, lanes: int):
    """Zeros for each leaf's slow-leg piece: ``[D, ceil(n / lanes)]`` per
    stacked leaf ``[D, ...]`` (``[1, ..]`` over ranks), n the elements a
    rank holds."""
    return _unflatten(grads, [
        torch.zeros((g.shape[0], _piece_len(g[0].numel(), lanes)),
                    dtype=torch.float32, device=g.device)
        for g in _leaves(grads)])


def _int8_leaf(g, ef, n_pods: int, lanes: int, log, ranks):
    """One leaf's NAP-3 with an int8 slow leg, per rank (``g`` ``[R, ...]``:
    R = D stacked, 1 over ranks): the synced sum ``[R, n]`` and the new
    error feedback ``[R, n_piece]``."""
    flat = g.float().reshape(g.shape[0], -1)
    n = flat.shape[1]
    pad = (-n) % lanes
    if pad:
        flat = F.pad(flat, (0, pad))
    piece = fast_reduce_scatter(flat, n_pods, lanes, log, ranks, "grad") + ef
    q, scale = quantize_int8(piece)
    residual = piece - dequantize_int8(q, scale)
    # int8 codes (and one float32 scale a rank) cross the slow group: 4x
    # fewer bytes than a float32 all-reduce; each rank sums the pods' terms
    qg = slow_all_gather(q, n_pods, lanes, log, ranks, INT8_TAG)
    sg = slow_all_gather(scale, n_pods, lanes, log, ranks, "grad")
    summed = (qg.float() * sg).sum(dim=1)
    full = fast_all_gather(summed, n_pods, lanes, log, ranks, "grad")
    return full[:, :n], residual


def hier_grad_sync(grads, n_pods: int, lanes: int, strategy: str = "nap3",
                   compress_slow: bool = False, error_feedback=None,
                   log: list | None = None, ranks=None):
    """Mean of a gradient tree over the (n_pods × lanes) data-parallel
    ranks, in float32.  Returns (synced grads, new error feedback): the
    feedback comes back as given unless ``compress_slow`` with ``nap3``,
    when it is each rank's quantization residual (zeros are assumed where
    ``error_feedback`` is None)."""
    denom = float(n_pods * lanes)
    if strategy == "flat" or not compress_slow:
        synced = _unflatten(grads, [
            hier_psum(g.float(), n_pods, lanes, strategy, log=log,
                      ranks=ranks, tag="grad") / denom
            for g in _leaves(grads)])
        return synced, error_feedback
    if strategy != "nap3":
        raise ValueError(f"hier_grad_sync: unknown strategy {strategy!r}")
    leaves = _leaves(grads)
    efs = (_leaves(error_feedback) if error_feedback is not None else
           _leaves(init_error_feedback(grads, lanes)))
    out, res = [], []
    for g, ef in zip(leaves, efs):
        full, r = _int8_leaf(g, ef, n_pods, lanes, log, ranks)
        out.append(full.reshape(g.shape) / denom)
        res.append(r)
    return _unflatten(grads, out), _unflatten(grads, res)
