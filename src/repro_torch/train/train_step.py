"""The train step (port of ``repro/train/train_step.py``): loss, gradients
(microbatches accumulated in float32), AdamW, on one device.

The reference's step is a pure function of (params, opt_state, batch)
that ``jax.jit`` compiles, sharded over a mesh with
:mod:`repro.train.sharding`.  Here the parameters are an
:class:`~repro_torch.models.model.LM`'s (made with ``trainable=True``),
updated in place, and the step runs eagerly on the device they lie on.
The mesh shardings, ZeRO-2 and the activation-sharding constraints wait
for the dry-run slice (ROADMAP queue 1 item 13.6) and are refused.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.model import loss_fn
from .optimizer import AdamWConfig, adamw_update, decay_mask

SHARDING_TODO = ("is not ported yet: the mesh shardings (train/sharding.py, "
                 "models/act_sharding.py) wait for the dry-run slice "
                 "(ROADMAP queue 1 item 13.6)")


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """The reference's options on one device; its mesh axes (``dp_axes``,
    ``model_axis``) and the dry-run's scan unrolling come with item 13.6
    (the port's loops are Python loops, already unrolled)."""
    remat: bool = True
    microbatches: int = 1
    use_kernel: bool = False
    zero2: bool = False         # shard the grad accumulator over dp axes
    loss_chunk: int | None = None  # stream unembed + xent over seq chunks


def check_options(opts: TrainOptions) -> None:
    """Refuse what the port does not train with: the flash kernel (no
    backward, as the reference's Pallas kernel has no VJP) and ZeRO-2."""
    if opts.use_kernel:
        raise NotImplementedError(
            "TrainOptions(use_kernel=True): the flash-attention kernel has no "
            "backward (nor has the reference's Pallas kernel a VJP); train "
            "with use_kernel=False, as the reference does")
    if opts.zero2:
        raise NotImplementedError(f"TrainOptions(zero2=True) {SHARDING_TODO}")
    if opts.microbatches < 1:
        raise ValueError(f"microbatches = {opts.microbatches} < 1")


def to_device(batch: dict, device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def make_step_fn(cfg, acfg: AdamWConfig, opts: TrainOptions,
                 grad_spec_tree=None):
    """The step function ``step(model, opt_state, batch) -> (model,
    opt_state, {"loss", "grad_norm", "lr"})``: ``model`` a trainable
    :class:`~repro_torch.models.model.LM` (updated in place), ``batch``
    tensors on its device.  With ``microbatches > 1`` the batch splits on
    dim 0 and the gradients add up in float32 before the mean."""
    check_options(opts)
    if grad_spec_tree is not None:
        raise NotImplementedError(f"grad_spec_tree {SHARDING_TODO}")
    masks: dict = {}

    def loss_of(model, mb):
        return loss_fn(model, cfg, mb, use_kernel=opts.use_kernel,
                       remat=opts.remat, loss_chunk=opts.loss_chunk)

    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if "decay" not in masks:
            masks["decay"] = decay_mask(cfg, params)
        leaves = list(params.values())
        if opts.microbatches == 1:
            loss = loss_of(model, batch)
            grads = torch.autograd.grad(loss, leaves)
        else:
            mb = opts.microbatches
            B = next(iter(batch.values())).shape[0]
            if B % mb:
                raise ValueError(f"batch {B} does not split into {mb} "
                                 f"microbatches")
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in leaves]
            loss = 0.0
            for i in range(mb):
                part = {k: v.reshape((mb, B // mb) + tuple(v.shape[1:]))[i]
                        for k, v in batch.items()}
                l = loss_of(model, part)
                for a, g in zip(gsum, torch.autograd.grad(l, leaves)):
                    a += g.float()
                loss = loss + l.detach()
            grads = [g / mb for g in gsum]
            loss = loss / mb
        grads = dict(zip(params, grads))
        _, opt_state, om = adamw_update(acfg, params, grads, opt_state,
                                        masks["decay"])
        return model, opt_state, {"loss": loss.detach(), **om}

    return step


def build_train_step(cfg, acfg: AdamWConfig, opts: TrainOptions, mesh=None):
    """Returns (step, None) for one device: the reference's ``mesh=None``
    path, whose second item, the shardings, is None there too.  The
    parameters are updated in place.  A mesh is refused."""
    if mesh is not None:
        raise NotImplementedError(f"build_train_step(mesh=...) {SHARDING_TODO}")
    return make_step_fn(cfg, acfg, opts), None
