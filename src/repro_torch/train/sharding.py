"""Parameter, batch, optimizer and cache sharding rules for the (pod, data,
model) meshes (port of ``repro/train/sharding.py``).

Canonical tensor-parallel layout (megatron-style), MoE expert placement by
divisibility:

    embed (V, d)        → (model, ∅)          lm_head (d, V) → (∅, model)
    wq/wk/wv (d, H·dh)  → (∅, model)          wo (H·dh, d)   → (model, ∅)
    mlp gate/up (d, f)  → (∅, model)          down (f, d)    → (model, ∅)
    moe E % |model|==0  → experts over model  else d_ff over model
    norms / biases / small recurrent tensors  → replicated

A spec is the reference's ``PartitionSpec`` as a tuple (see
:mod:`repro_torch.models.act_sharding`); :func:`named` turns a tree of them
into DTensor placements.

The reference stacks the layers of a pattern group with a leading
``n_groups`` dim, and its rule runs on that stacked shape (its fallback
sorts the dims by size, and ``np.argsort``'s default sort is not stable, so
ties between equal dims may fall otherwise on an unstacked shape).  The
port keeps one tensor per layer: each spec is derived on the reference's
stacked shape and path (:func:`reference_path`) and the leading entry is
dropped.  ZeRO-1 (:func:`zero1_opt_specs`) may shard that leading group dim
over dp (whole layers' moments on different ranks), which a per-layer
tensor cannot express; :func:`zero1_opt_specs` then shards the layer's own
first free divisible dim instead (:func:`unstack_spec`), the same share of
the moments a device.
"""
from __future__ import annotations

import numpy as np

from ..models.act_sharding import placements_of
from ..models.model import layer_slot


def _rule(key_parts, shape, cfg, model_axis, model_size, ep_axis=None,
          ep_size=1):
    name = key_parts[-1]
    nd = len(shape)
    # params under the stacked "groups" carry a leading n_groups dim
    lead = 1 if key_parts and key_parts[0] == "groups" else 0
    pre = (None,) * lead

    def ok(dim_size):
        return dim_size % model_size == 0

    if name == "embed":
        return (model_axis, None) if ok(shape[0]) else ()
    if name == "lm_head":
        return (None, model_axis) if ok(shape[1]) else ()
    if name in ("wq", "wk", "wv", "wo") and "ffn" not in key_parts:
        # heads shard only when the head count divides the axis; replicated
        # kv projections under GQA (H_kv < tp) are the standard layout
        heads = cfg.n_kv_heads if name in ("wk", "wv") else cfg.n_heads
        if heads % model_size != 0:
            return ()
        if name == "wo":
            return (*pre, model_axis, None) if ok(shape[-2]) else ()
        return (*pre, None, model_axis) if ok(shape[-1]) else ()
    if name == "wx":      # sLSTM gates reshape per head → replicated
        return ()
    if name in ("in_x", "in_gate", "up", "gate") and "ffn" not in key_parts:
        return (*pre, None, model_axis) if ok(shape[-1]) else ()
    if name in ("out", "down") and "ffn" not in key_parts:
        return (*pre, model_axis, None) if ok(shape[-2]) else ()
    if "ffn" in key_parts:
        if name == "router":
            return ()
        if cfg.is_moe:
            e = cfg.n_experts
            if ep_axis is not None and e % ep_size == 0:
                # experts over the intra-pod ep_axis + d_ff over model
                if name in ("gate", "up"):
                    return (*pre, ep_axis, None, model_axis)
                if name == "down":
                    return (*pre, ep_axis, model_axis, None)
            if name in ("gate", "up"):
                if e % model_size == 0:
                    return (*pre, model_axis, None, None)
                # d_model over "data" (ZeRO-3, gathered at use)
                return (*pre, None, "data", model_axis) if ok(shape[-1]) \
                    else ()
            if name == "down":
                if e % model_size == 0:
                    return (*pre, model_axis, None, None)
                return (*pre, None, model_axis, "data") if ok(shape[-2]) \
                    else ()
        else:
            if name in ("gate", "up"):
                return (*pre, None, model_axis) if ok(shape[-1]) else ()
            if name == "down":
                return (*pre, model_axis, None) if ok(shape[-2]) else ()
    # fallback: shard the largest divisible matrix dim; 1-D-a-layer params
    # (norm scales, biases, stacked to 2-D) stay replicated
    if nd - lead >= 2:
        order = np.argsort(shape)[::-1]
        for dim in order:
            if shape[dim] % model_size == 0 and shape[dim] >= 2 * model_size \
                    and dim >= lead:
                spec = [None] * nd
                spec[dim] = model_axis
                return tuple(spec)
    return ()


def reference_path(cfg, name: str, shape) -> tuple[list[str], tuple, bool]:
    """The reference's tree path and array shape for the LM parameter
    ``name`` of shape ``shape``, and whether it is stacked over the groups
    (a leading ``n_groups`` dim): ``layers.<i>.core.wq`` →
    ``["groups", "<j>", "core", "wq"]``, ``(n_groups, *shape)``, True."""
    parts = name.split(".")
    if parts[0] != "layers":
        return parts, tuple(shape), False
    g, j = layer_slot(cfg, int(parts[1]))
    if g is None:
        return ["extra", str(j), *parts[2:]], tuple(shape), False
    n_groups = cfg.n_layers // len(cfg.pattern)
    return ["groups", str(j), *parts[2:]], (n_groups, *shape), True


def _shape(leaf):
    return tuple(getattr(leaf, "shape", leaf))


def reference_param_specs(cfg, params_shape: dict, model_axis="model",
                          model_size=16, ep_axis=None, ep_size=1) -> dict:
    """The reference's specs on its stacked shapes, by port name (a stacked
    leaf's spec keeps its leading entry)."""
    out = {}
    for name, leaf in params_shape.items():
        parts, shape, _ = reference_path(cfg, name, _shape(leaf))
        out[name] = _rule(parts, shape, cfg, model_axis, model_size, ep_axis,
                          ep_size)
    return out


def _drop_lead(cfg, name, spec):
    """A stacked leaf's spec without its leading (group) entry, which the
    parameter rules never shard."""
    stacked = name.startswith("layers.") and \
        layer_slot(cfg, int(name.split(".")[1]))[0] is not None
    if stacked and spec and spec[0] is not None:
        raise AssertionError(f"{name}: stacked spec {spec} shards the group "
                             f"dim")
    return spec[1:] if stacked and spec else spec


def param_specs(cfg, params_shape: dict, model_axis="model", model_size=16,
                ep_axis=None, ep_size=1) -> dict:
    """``{name: spec}`` for an LM's parameters (``params_shape``: name →
    tensor or shape), each derived on the reference's stacked shape."""
    ref = reference_param_specs(cfg, params_shape, model_axis, model_size,
                                ep_axis, ep_size)
    return {name: _drop_lead(cfg, name, spec) for name, spec in ref.items()}


def named(mesh, spec_tree):
    """A (nested) dict of specs → the same tree of DTensor placements on
    ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named(mesh, v) for v in spec_tree]
    return placements_of(mesh, spec_tree)


def _entry(axes):
    """A spec entry as ``PartitionSpec`` normalises it: no axes → None,
    one axis → its name, several → their tuple."""
    if axes is None or isinstance(axes, str):
        return axes
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def batch_specs(cfg, dp_axes, embeds: bool) -> dict:
    dp = _entry(dp_axes)
    inp = (dp, None, None) if embeds else (dp, None)
    return {"inputs": inp, "targets": (dp, None)}


def _used_axes(spec) -> set:
    used = set()
    for s in spec:
        for a in (s if isinstance(s, tuple) else (s,)):
            if a is not None:
                used.add(a)
    return used


def _shard_m(spec, dims, dp_axes, sizes):
    """The reference's ZeRO-1 rule for one leaf: the dp axes the spec does
    not use, on the first free dim that they divide."""
    if not dp_axes:
        return spec
    free = tuple(a for a in dp_axes if a not in _used_axes(spec))
    if not free:
        return spec
    dp_sz = int(np.prod([sizes.get(a, 16) for a in free]))
    used = {i for i, s in enumerate(spec) if s is not None}
    for i, d in enumerate(dims):
        if i in used:
            continue
        if d % dp_sz == 0 and d >= dp_sz:
            new = list(spec) + [None] * (len(dims) - len(spec))
            new[i] = free if len(free) > 1 else free[0]
            return tuple(new)
    return spec


def reference_zero1_specs(cfg, pspecs_stacked: dict, params_shape: dict,
                          dp_axes, sizes: dict) -> dict:
    """The reference's ZeRO-1 moment specs on its stacked shapes, by port
    name."""
    out = {}
    for name, leaf in params_shape.items():
        _, shape, _ = reference_path(cfg, name, _shape(leaf))
        out[name] = _shard_m(pspecs_stacked[name], shape, dp_axes, sizes)
    return out


def unstack_spec(cfg, name: str, stacked_spec, shape, dp_axes, sizes,
                 pspec):
    """A stacked moment spec for the port's per-layer tensor of ``shape``:
    the leading entry dropped; where it sharded the group dim, the layer's
    own first free divisible dim takes those axes instead."""
    _, _, stacked = reference_path(cfg, name, shape)
    if not stacked or not stacked_spec:
        return stacked_spec
    if stacked_spec[0] is None:
        return stacked_spec[1:]
    return _shard_m(pspec, tuple(shape), dp_axes, sizes)


def zero1_opt_specs(cfg, pspecs: dict, params_shape: dict, dp_axes,
                    mesh=None) -> dict:
    """ZeRO-1: the AdamW moments also sharded over the data-parallel axes,
    on the first free divisible dim (params stay as they are).  Sizes come
    from ``mesh`` (the reference's defaults, pod 2 and data 16, without
    one).  Returns ``{"m", "v", "count"}`` for the port's tensors."""
    from ..launch.mesh import mesh_sizes
    sizes = mesh_sizes(mesh) if mesh is not None else {"pod": 2, "data": 16}
    stacked_p = {}
    for name, leaf in params_shape.items():
        _, _, st = reference_path(cfg, name, _shape(leaf))
        stacked_p[name] = ((None, *pspecs[name]) if st and pspecs[name]
                           else pspecs[name])
    ref = reference_zero1_specs(cfg, stacked_p, params_shape, dp_axes, sizes)
    m = {name: unstack_spec(cfg, name, ref[name], _shape(params_shape[name]),
                            dp_axes, sizes, pspecs[name])
         for name in params_shape}
    return {"m": m, "v": m, "count": ()}


def cache_specs(cfg, dp_axes, model_axis="model"):
    """Decode-cache specs ``(groups, extra)`` in the cache's own (stacked)
    layout, which the port keeps: batch over dp, head_dim over model (S
    stays whole: the ring-buffer write is at a runtime position)."""
    dp_axes = _entry(dp_axes)

    def per_kind(kind):
        if kind == "attn":
            return {"k": (None, dp_axes, None, None, model_axis),
                    "v": (None, dp_axes, None, None, model_axis),
                    "slot_pos": (None, None)}
        if kind == "mlstm":
            return {"C": (None, dp_axes, None, None, None),
                    "n": (None, dp_axes, None, None)}
        if kind == "slstm":
            return {"h": (None, dp_axes, None),
                    "c": (None, dp_axes, None, None),
                    "n": (None, dp_axes, None, None)}
        if kind == "rglru":
            return {"conv": (None, dp_axes, None, None),
                    "h": (None, dp_axes, None)}
        raise ValueError(kind)

    group = tuple(per_kind(k) for k in cfg.pattern)
    n_extra = cfg.n_layers % len(cfg.pattern)
    extra = tuple({k: s[1:] for k, s in per_kind(cfg.pattern[i]).items()}
                  for i in range(n_extra))
    return group, extra
