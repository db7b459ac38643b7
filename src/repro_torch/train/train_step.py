"""The train step (port of ``repro/train/train_step.py``): loss, gradients
(microbatches accumulated in float32), AdamW.

The reference's step is a pure function of (params, opt_state, batch)
that ``jax.jit`` compiles, sharded over a mesh with
:mod:`repro.train.sharding`.  Here the parameters are an
:class:`~repro_torch.models.model.LM`'s (made with ``trainable=True``),
updated in place, and the step runs eagerly on the device they lie on.
On a mesh (:func:`build_train_step` with ``mesh=``) the parameters, the
AdamW moments and the batch are DTensors placed by
:mod:`repro_torch.train.sharding` (:func:`shard_state`; every collective a
DTensor issues, on the mesh's process groups); the gradients are
summed over the data-parallel axes when they are redistributed to the
parameters' placements, or, with ``zero2``, reduce-scattered to the
moments' ZeRO placements (``grad_spec_tree``), and AdamW updates each
shard where its moments live and gathers the parameter back.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..core.nap_collectives import distribute, from_local, implicit_replication
from ..models.model import loss_fn
from .optimizer import AdamWConfig, adamw_update, decay_mask


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """The reference's options.  ``dp_axes`` / ``model_axis`` name the
    mesh axes of a sharded step; ``unroll`` is kept for the reference's
    signature and does nothing (the port's loops are Python loops, already
    unrolled)."""
    remat: bool = True
    microbatches: int = 1
    use_kernel: bool = False
    dp_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    unroll: bool = False
    zero2: bool = False         # shard the grad accumulator over dp axes
    loss_chunk: int | None = None  # stream unembed + xent over seq chunks


def check_options(opts: TrainOptions) -> None:
    """Refuse what the port does not train with: the flash kernel (no
    backward, as the reference's Pallas kernel has no VJP)."""
    if opts.use_kernel:
        raise NotImplementedError(
            "TrainOptions(use_kernel=True): the flash-attention kernel has no "
            "backward (nor has the reference's Pallas kernel a VJP); train "
            "with use_kernel=False, as the reference does")
    if opts.microbatches < 1:
        raise ValueError(f"microbatches = {opts.microbatches} < 1")


def to_device(batch: dict, device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def _microbatch(v, mb: int, i: int):
    """Microbatch ``i`` of ``mb`` along dim 0.  A DTensor batch (rows over
    the dp ranks) is split rank by rank: each rank's rows ``i`` of ``mb``,
    so no row moves (the microbatches hold other rows than the one-device
    split, and their mean is the same)."""
    if isinstance(v, DTensor):
        loc = v.to_local()
        part = loc.reshape((mb, loc.shape[0] // mb) + tuple(loc.shape[1:]))[i]
        return from_local(part, v.device_mesh, v.placements)
    B = v.shape[0]
    return v.reshape((mb, B // mb) + tuple(v.shape[1:]))[i]


def _to(t, placements):
    return t if placements is None or not isinstance(t, DTensor) or \
        tuple(t.placements) == tuple(placements) else \
        t.redistribute(t.device_mesh, placements)


def make_step_fn(cfg, acfg: AdamWConfig, opts: TrainOptions,
                 grad_spec_tree=None, donate: bool = False):
    """The step function ``step(model, opt_state, batch) -> (model,
    opt_state, {"loss", "grad_norm", "lr"})``: ``model`` a trainable
    :class:`~repro_torch.models.model.LM` (updated in place), ``batch``
    tensors on its device.  With ``microbatches > 1`` the batch splits on
    dim 0 and the gradients add up in float32 before the mean.

    ``donate``: ``opt_state`` is donated, as the reference's jitted step
    donates it (:func:`~repro_torch.train.optimizer.adamw_update` with
    ``donate``): its moments become the returned ones, updated in place,
    and each gradient is freed as the update consumes it.  The old moments
    and a second copy of them are never held at once, which a model whose
    training state fills most of the card needs.

    On DTensor parameters each gradient is redistributed as it is made:
    with ``zero2`` to ``grad_spec_tree[name]`` (placements: the moments'
    ZeRO layout, a reduce-scatter over dp), else to the parameter's own
    placements (an all-reduce over dp)."""
    check_options(opts)
    masks: dict = {}

    def loss_of(model, mb):
        return loss_fn(model, cfg, mb, use_kernel=opts.use_kernel,
                       remat=opts.remat, loss_chunk=opts.loss_chunk)

    def step(model, opt_state, batch):
        sharded = any(isinstance(p, DTensor) for p in model.parameters())
        # plain tensors the model makes (positions, masks) join DTensor
        # operands as replicated
        with implicit_replication() if sharded else contextlib.nullcontext():
            return _step(model, opt_state, batch)

    def _step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if "decay" not in masks:
            masks["decay"] = decay_mask(cfg, params)
        names, leaves = list(params), list(params.values())
        sharded = any(isinstance(p, DTensor) for p in leaves)
        if opts.zero2 and sharded and grad_spec_tree is not None:
            target = [grad_spec_tree[n] for n in names]
        else:
            target = [p.placements if isinstance(p, DTensor) else None
                      for p in leaves]

        def grads_of(loss):
            return [_to(g, t) for g, t in
                    zip(torch.autograd.grad(loss, leaves), target)]

        if opts.microbatches == 1:
            loss = loss_of(model, batch)
            grads = grads_of(loss)
        else:
            mb = opts.microbatches
            B = next(iter(batch.values())).shape[0]
            if B % mb:
                raise ValueError(f"batch {B} does not split into {mb} "
                                 f"microbatches")
            gsum = None
            loss = 0.0
            for i in range(mb):
                part = {k: _microbatch(v, mb, i) for k, v in batch.items()}
                l = loss_of(model, part)
                g = [x.float() for x in grads_of(l)]
                gsum = g if gsum is None else [a.add_(b)
                                               for a, b in zip(gsum, g)]
                loss = loss + l.detach()
            grads = [g / mb for g in gsum]
            loss = loss / mb
        grads = dict(zip(names, grads))
        _, opt_state, om = adamw_update(acfg, params, grads, opt_state,
                                        masks["decay"], donate=donate)
        return model, opt_state, {"loss": loss.detach(), **om}

    return step


def shard_state(model, opt_state: dict | None, mesh, p_placements: dict,
                o_placements: dict | None = None):
    """Place ``model``'s parameters on ``mesh`` in place, by ``{name:
    placements}`` (:func:`~repro_torch.train.sharding.named` of
    :func:`~repro_torch.train.sharding.param_specs`), and the AdamW
    moments by ``o_placements`` (``{"m", "v"}``: ZeRO's, by default the
    parameters').  Returns the placed opt state (``None`` for none)."""
    from torch import nn

    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, nn.Parameter(
            distribute(p.detach(), mesh, p_placements[name]),
            requires_grad=p.requires_grad))
    if opt_state is None:
        return None
    o_pl = o_placements or {"m": p_placements, "v": p_placements}
    return {"m": {n: distribute(t, mesh, o_pl["m"][n])
                  for n, t in opt_state["m"].items()},
            "v": {n: distribute(t, mesh, o_pl["v"][n])
                  for n, t in opt_state["v"].items()},
            "count": opt_state["count"]}


def build_train_step(cfg, acfg: AdamWConfig, opts: TrainOptions, mesh=None,
                     params_shape: dict | None = None, ep_axis: str | None = None,
                     ep_size: int = 1):
    """Returns ``(step, shardings)``.  Without a mesh: the one-device step
    and ``None`` (the reference's ``mesh=None`` path).  With a
    :class:`~torch.distributed.device_mesh.DeviceMesh`: the sharded step
    and ``(param placements, opt placements, batch placements)``, each a
    dict of DTensor placements by name (``params_shape``: the parameters'
    ``{name: tensor or shape}``) — the reference's (param_sh, opt_sh,
    batch_sh).  The opt placements are ZeRO's when ``opts.zero2``, else
    the parameters'; place the state with :func:`shard_state`, the batch
    with ``distribute_tensor``.  ``ep_axis`` / ``ep_size``: the mesh axis
    and size an MoE's experts are sharded over (expert parallelism, as
    :func:`~repro_torch.train.sharding.param_specs` takes them)."""
    if mesh is None:
        return make_step_fn(cfg, acfg, opts), None
    from ..launch.mesh import mesh_sizes
    from .sharding import batch_specs, named, param_specs, zero1_opt_specs
    if params_shape is None:
        raise ValueError("build_train_step(mesh=...) needs params_shape")
    model_size = mesh_sizes(mesh)[opts.model_axis]
    pspecs = param_specs(cfg, params_shape, opts.model_axis, model_size,
                         ep_axis=ep_axis, ep_size=ep_size)
    ospecs = (zero1_opt_specs(cfg, pspecs, params_shape, opts.dp_axes, mesh)
              if opts.zero2 else {"m": pspecs, "v": pspecs, "count": ()})
    p_sh, o_sh = named(mesh, pspecs), named(mesh, ospecs)
    b_sh = named(mesh, batch_specs(cfg, opts.dp_axes,
                                   embeds=not cfg.embed_input))
    step = make_step_fn(cfg, acfg, opts,
                        grad_spec_tree=o_sh["m"] if opts.zero2 else None)
    return step, (p_sh, o_sh, b_sh)
