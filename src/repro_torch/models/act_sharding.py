"""Trace-time activation sharding (port of ``repro/models/act_sharding.py``).

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry a
tensor dim, each ``None`` (not sharded), a mesh axis name, or a tuple of
axis names (sharded over their product, in mesh order).  :func:`placements_of`
turns one into DTensor placements on a mesh: ``Shard(d)`` for each mesh dim
that names tensor dim ``d``, ``Replicate()`` for the others.

The ``constrain_*`` functions are the reference's ``with_sharding_constraint``
calls at the same places of the model: on a DTensor they
``redistribute`` it to the context's spec, on a plain tensor (one device,
or inside a ``local_map`` region) they do nothing.  Used as::

    with activation_sharding(qkv_spec=(dp, "model", None, None),
                             kv_spec=(dp, None, None, None),
                             out_spec=(dp, None, None)):
        loss = loss_fn(model, cfg, batch)      # DTensor parameters
"""
from __future__ import annotations

import contextlib

from torch.distributed.tensor import DTensor

from ..core.nap_collectives import replicate, shard

_CTX: dict = {"qkv_spec": None, "kv_spec": None, "out_spec": None,
              "scores_spec": None, "q5_spec": None, "moe_ep": None,
              "residual_spec": None, "moe_buf_spec": None}


@contextlib.contextmanager
def activation_sharding(**kw):
    old = dict(_CTX)
    unknown = set(kw) - set(_CTX)
    if unknown:
        raise KeyError(f"activation_sharding: unknown keys {sorted(unknown)}")
    _CTX.update(kw)
    try:
        yield
    finally:
        _CTX.clear()
        _CTX.update(old)


def current(key: str):
    return _CTX[key]


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements_of(mesh, spec) -> tuple:
    """DTensor placements on ``mesh`` for the spec tuple ``spec``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if name in _names(e)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec}: axis {name!r} on two dims")
        out.append(shard(dims[0]) if dims else replicate())
    return tuple(out)


def constrain(x, spec):
    """``x`` redistributed to ``spec`` when it is a DTensor and ``spec`` is
    set; ``x`` itself otherwise."""
    if spec is None or not isinstance(x, DTensor):
        return x
    want = placements_of(x.device_mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def settle(x):
    """``x`` with its pending sums taken: a DTensor's Partial placements
    (a row-parallel product's output) made Replicate by an all-reduce, as
    Megatron-style tensor parallelism reduces a block's output before the
    residual add; anything else as it is."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [replicate() if p.is_partial() else p
                                          for p in x.placements])


def settle_heads(q):
    """A DTensor ``[B, S, H, D]`` with its head dim made whole (a head
    sharding gathered); anything else as it is."""
    if not isinstance(q, DTensor):
        return q
    return q.redistribute(q.device_mesh, [
        replicate() if getattr(p, "dim", None) == 2 else p
        for p in q.placements])


def constrain_q(q):
    return constrain(q, _CTX["qkv_spec"])


def constrain_kv(k, v):
    return constrain(k, _CTX["kv_spec"]), constrain(v, _CTX["kv_spec"])


def constrain_out(x):
    return constrain(x, _CTX["out_spec"])


def constrain_moe_buf(buf):
    """TP-MoE dispatch buffer [E, cap, d]: the capacity dim over dp, so the
    buffer never replicates across the data axis."""
    return constrain(buf, _CTX["moe_buf_spec"])


def constrain_residual(x):
    """Residual stream between blocks [B, S, d]: S over the model axis
    (Megatron-SP) shrinks what the backward keeps per layer."""
    return constrain(x, _CTX["residual_spec"])


def constrain_q5(q5):
    """Decode query [B, 1, Hkv, g, dh]: to the cache's head_dim sharding,
    so the large cache operand never moves."""
    return constrain(q5, _CTX["q5_spec"])


def constrain_scores(s):
    """Decode scores [B, Hkv, g, 1, S]: replicated over the model axis, so
    the dh contraction completes with a sum instead of gathering the
    cache."""
    return constrain(s, _CTX["scores_spec"])
