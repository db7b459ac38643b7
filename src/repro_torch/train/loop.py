"""Fault-tolerant training loop (port of ``repro/train/loop.py``).

* auto-resume from the latest atomic checkpoint (params, optimizer, step);
* periodic async checkpointing (host snapshot + background write), in the
  reference's format and layout (:mod:`repro_torch.ckpt`);
* preemption handling: SIGTERM/SIGINT requests a final checkpoint and a
  clean stop after the current step;
* straggler watchdog: per-step wall time EMA; steps slower than
  ``straggler_factor`` x the EMA are logged with their step index.

The reference's loop feeds the pipeline's tokens to every arch: for an
``embed_input=False`` arch it has only a placeholder
(``repro/train/loop.py:74-75``, ``if not cfg.embed_input: pass``), so such
an arch gets tokens where its forward wants embeddings.  The port refuses
it instead (its train step does take embedding batches).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time

import torch

from ..ckpt.checkpoint import (latest_step, restore_train_state, save_async,
                               train_state_to_tree, wait_pending)
from ..models.model import init_lm
from .data import DataConfig, TokenPipeline
from .optimizer import AdamWConfig, init_opt_state
from .train_step import TrainOptions, build_train_step, to_device


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    seed: int = 0


def train(cfg, acfg: AdamWConfig, dcfg: DataConfig, lcfg: LoopConfig,
          opts: TrainOptions | None = None, mesh=None, dtype=None,
          log=print, device="cuda"):
    """Train ``cfg`` from a seeded init (or the latest checkpoint in
    ``lcfg.ckpt_dir``) up to ``lcfg.total_steps``.  Returns (model,
    opt_state, per-step losses of this run)."""
    if not cfg.embed_input:
        raise NotImplementedError(
            f"{cfg.name}: the training loop feeds the pipeline's tokens, and "
            f"an embed_input=False arch wants frontend embeddings; the "
            f"reference's loop has only a placeholder for them "
            f"(repro/train/loop.py:74-75), so the port refuses the arch")
    dtype = dtype or torch.float32
    opts = opts or TrainOptions(remat=False)
    model = init_lm(cfg, seed=lcfg.seed, dtype=dtype, device=device,
                    trainable=True)
    opt_state = init_opt_state(dict(model.named_parameters()))
    step_fn, _ = build_train_step(cfg, acfg, opts, mesh=mesh)
    start = 0
    last = latest_step(lcfg.ckpt_dir)
    if last is not None:
        opt_state = restore_train_state(cfg, model, opt_state, lcfg.ckpt_dir,
                                        last)
        start = last
        log(f"[loop] resumed from step {last}")

    pipe = TokenPipeline(dcfg)
    stop_requested = {"flag": False}

    def _sig(_signum, _frame):
        stop_requested["flag"] = True

    old_handlers = [(s, signal.signal(s, _sig))
                    for s in (signal.SIGTERM, signal.SIGINT)]
    ema = None
    history = []
    try:
        for step in range(start, lcfg.total_steps):
            t0 = time.perf_counter()
            batch = to_device(pipe.batch_at(step), model.device)
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > lcfg.straggler_factor * ema and step > start + 3:
                log(f"[loop] STRAGGLER step {step}: {dt:.3f}s vs ema {ema:.3f}s")
            history.append(loss)
            if step % lcfg.log_every == 0:
                log(f"[loop] step {step} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms")
            if (step + 1) % lcfg.ckpt_every == 0 or stop_requested["flag"] \
                    or step + 1 == lcfg.total_steps:
                save_async(lcfg.ckpt_dir, step + 1,
                           train_state_to_tree(cfg, model, opt_state),
                           metadata={"loss": loss})
            if stop_requested["flag"]:
                log(f"[loop] preemption requested; checkpointed at {step + 1}")
                break
    finally:
        for s, h in old_handlers:
            signal.signal(s, h)
        wait_pending()
    return model, opt_state, history
