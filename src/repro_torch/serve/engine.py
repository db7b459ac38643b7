"""Batched serving engine (port of ``repro/serve/engine.py``): prefill →
decode, FIFO window batching, per-row greedy / temperature sampling, and the
prefill-cache conversion into the ring-buffer decode layout.

Prompts of a batch are left-padded with token 0 to the longest one and
prefilled with no padding mask, as the reference does: changing that would
change the answers.  Greedy rows agree with the reference; sampled rows
draw from a :class:`torch.Generator`, so their bits differ from JAX's.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] tokens
    max_new_tokens: int = 16
    temperature: float = 0.0


def prefill_to_decode_cache(cfg, caches, ctx_len: int, prompt_len: int,
                            dtype=torch.float32):
    """Convert ``LM.forward(return_cache=True)`` output into the decode
    cache layout (padded ring buffers + slot positions).  Pure data
    movement: bit-equal to the reference's conversion."""
    group_caches, extra_caches = caches
    clen = min(ctx_len, cfg.window) if cfg.window else ctx_len

    def conv_attn(c, stacked):
        k, v = c["k"], c["v"]                    # [..., B, S, H, dh]
        S = k.shape[-3]
        take = min(S, clen)
        positions = np.arange(S - take, S)
        slots = positions % clen
        idx = torch.as_tensor(slots, device=k.device)
        pad_shape = list(k.shape)
        pad_shape[-3] = clen
        bufs = {}
        for name, t in (("k", k), ("v", v)):
            buf = torch.zeros(pad_shape, dtype=dtype, device=t.device)
            buf[..., idx, :, :] = t[..., S - take:, :, :].to(dtype)
            bufs[name] = buf
        slot_pos = np.full((clen,), -1, np.int32)
        slot_pos[slots] = positions
        sp = torch.as_tensor(slot_pos, device=k.device)
        if stacked:   # one row per layer; decode writes it in place
            sp = sp.expand(k.shape[0], clen).clone()
        return {**bufs, "slot_pos": sp}

    out_groups = tuple(conv_attn(c, True) if kind == "attn" else c
                       for kind, c in zip(cfg.pattern, group_caches))
    out_extra = tuple(conv_attn(c, False) if cfg.pattern[i] == "attn" else c
                      for i, c in enumerate(extra_caches))
    return out_groups, out_extra


def pad_prompts(reqs: list[Request]) -> np.ndarray:
    """``[B, S]`` int32 prompts, right-aligned (left-padded with token 0) to
    the longest prompt of the batch."""
    S = max(r.prompt.shape[0] for r in reqs)
    prompts = np.zeros((len(reqs), S), np.int32)
    for i, r in enumerate(reqs):
        prompts[i, S - r.prompt.shape[0]:] = r.prompt
    return prompts


class Engine:
    """Collects requests into a batch window, left-pads them to a common
    length, prefills once (attention through the flash-attention kernel),
    then decodes in lockstep.  Runs on the card unless ``device="cpu"``;
    the model must already lie on that device."""

    def __init__(self, cfg, model, max_batch: int = 8, ctx_len: int = 256,
                 dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"runs on {self.device}")
        self.cfg, self.model = cfg, model
        self.max_batch, self.ctx_len, self.dtype = max_batch, ctx_len, dtype
        self.queue: list[Request] = []
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0,
                      "batches": 0}

    def submit(self, req: Request):
        self.queue.append(req)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits, temperatures: np.ndarray, gen: torch.Generator):
        """Per-row sampling for a [B, V] logits batch: rows with
        temperature <= 0 take the greedy argmax, the rest draw from
        logits/T with their own temperature (Gumbel-max, as
        ``jax.random.categorical`` does)."""
        greedy = torch.argmax(logits, dim=-1)
        if not np.any(temperatures > 0.0):
            return greedy
        temps = torch.as_tensor(temperatures, dtype=logits.dtype,
                                device=logits.device)
        scaled = logits / torch.where(temps > 0.0, temps, 1.0)[:, None]
        u = torch.rand(scaled.shape, generator=gen, dtype=scaled.dtype,
                       device=scaled.device)
        sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
        return torch.where(temps > 0.0, sampled, greedy)

    @torch.inference_mode()
    def run(self, seed: int = 0) -> dict[int, np.ndarray]:
        """Drain the queue; returns {rid: generated tokens}."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        results: dict[int, np.ndarray] = {}
        while self.queue:
            batch = self.queue[: self.max_batch]
            self.queue = self.queue[self.max_batch:]
            results.update(self._run_batch(batch, gen))
            self.stats["batches"] += 1
        return results

    def _run_batch(self, reqs: list[Request], gen) -> dict[int, np.ndarray]:
        B = len(reqs)
        prompts = pad_prompts(reqs)
        S = prompts.shape[1]
        t0 = time.perf_counter()
        logits, caches = self.model(torch.as_tensor(prompts, device=self.device),
                                    return_cache=True)
        cache = prefill_to_decode_cache(self.cfg, caches, self.ctx_len, S,
                                        self.dtype)
        del caches
        self._sync()
        self.stats["prefill_s"] += time.perf_counter() - t0
        max_new = max(r.max_new_tokens for r in reqs)
        temps = np.array([r.temperature for r in reqs], np.float32)
        toks = self._sample(logits[:, -1], temps, gen)
        del logits
        outs = [toks]
        t0 = time.perf_counter()
        for t in range(max_new - 1):
            lg, cache = self.model.decode_step(toks[:, None], cache, S + t)
            toks = self._sample(lg, temps, gen)
            outs.append(toks)
        self._sync()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["tokens"] += int(max_new) * B
        gen_toks = torch.stack(outs, dim=1).cpu().numpy()
        return {r.rid: gen_toks[i, : r.max_new_tokens] for i, r in enumerate(reqs)}
