"""Stand-ins for every model input, made without memory, and the model-FLOPs
accounting of the roofline (port of ``repro/launch/specs.py``).

The reference's ``jax.eval_shape`` becomes ``FakeTensorMode``: the port's
own initialisers (:func:`~repro_torch.models.model.init_params`,
:func:`~repro_torch.models.model.init_cache`) run on fake tensors, which
carry shapes, types and devices and allocate nothing (a random draw from
a ``torch.Generator`` produces a fake tensor and leaves the generator as it
was).  Call them inside a ``FakeTensorMode`` to keep using what they return
(the dry-run does); outside one they enter their own.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.base import ArchConfig, ShapeConfig
from ..models.model import LM, init_cache, init_params
from ..train.optimizer import init_opt_state


def fake_mode():
    """The active ``FakeTensorMode``, or a new one to enter."""
    from torch._guards import detect_fake_mode
    mode = detect_fake_mode()
    return contextlib.nullcontext(mode) if mode is not None else \
        FakeTensorMode(allow_non_fake_inputs=True)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16,
                    device="cpu") -> dict[str, torch.Tensor]:
    """``{name: fake tensor}`` with an LM's parameter names
    (``layers.<i>.core.wq``, ...)."""
    with fake_mode():
        dev = torch.device(device)
        model = LM(cfg, init_params(cfg, torch.Generator(device=dev), dtype,
                                    dev))
    return dict(model.named_parameters())


def abstract_opt_state(params_shape: dict,
                       moment_dtype=torch.float32) -> dict:
    """The AdamW state of :func:`~repro_torch.train.optimizer.init_opt_state`
    for ``params_shape``, on fake tensors."""
    with fake_mode():
        return init_opt_state(params_shape, moment_dtype=moment_dtype)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, dtype=torch.bfloat16,
                device="cpu") -> dict:
    """Fake stand-ins for the step inputs of this (arch × shape) cell.

    train   → {"inputs", "targets"}
    prefill → {"inputs"}: tokens (or embeddings) [B, S]
    decode  → {"inputs" [B, 1], "cache" (groups, extra), "pos"}
    """
    B, S = shape.global_batch, shape.seq_len
    dev = torch.device(device)
    with fake_mode():
        def tok(b, s):
            if cfg.embed_input:
                return torch.empty((b, s), dtype=torch.int32, device=dev)
            # stub modality frontend: precomputed frame / patch embeddings
            return torch.empty((b, s, cfg.d_model), dtype=dtype, device=dev)

        if shape.kind == "train":
            return {"inputs": tok(B, S),
                    "targets": torch.empty((B, S), dtype=torch.int32,
                                           device=dev)}
        if shape.kind == "prefill":
            return {"inputs": tok(B, S)}
        if shape.kind == "decode":
            return {"inputs": tok(B, 1),
                    "cache": init_cache(cfg, B, S, dtype, device=dev),
                    "pos": torch.empty((), dtype=torch.int32, device=dev)}
    raise ValueError(shape.kind)


def analytic_memory_floor(cfg: ArchConfig, shape: ShapeConfig,
                          n_chips: int) -> float:
    """Bytes a device a well-fused step must move: a lower bound beside the
    traced per-device bytes."""
    P = float(cfg.n_params())
    Pa = float(cfg.n_active_params())
    tokens = shape.global_batch * shape.seq_len
    d, L = cfg.d_model, cfg.n_layers
    if shape.kind == "train":
        # params: bf16 read fwd + bwd-recompute read + f32 grad write +
        # f32 m/v read+write (ZeRO sharded → /chips like params)
        param_traffic = P * (2 + 2 + 4 + 16)
        act = tokens * d * L * 40.0          # ~40B/token/layer fused fwd+bwd
        return (param_traffic + act) / n_chips
    if shape.kind == "prefill":
        return (Pa * 2 + tokens * d * L * 20.0) / n_chips
    # decode: read all active params + the KV cache once per token
    clen = min(shape.seq_len, cfg.window) if cfg.window else shape.seq_len
    kv = (shape.global_batch * clen * cfg.n_kv_heads * cfg.head_dim * 2 * 2
          * sum(1 for k in cfg.pattern if k == "attn") * L // len(cfg.pattern))
    return (Pa * 2 + kv) / n_chips


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N·D (train) / 2·N·D (inference), N = active params, D = tokens."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch           # decode: one token each
