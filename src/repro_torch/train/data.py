# Verbatim copy of repro/train/data.py (pure numpy); the port keeps its own.
"""Data pipeline: deterministic synthetic stream (resumable by construction)
and a memmap-backed token-file reader with shuffled windows + host prefetch.

Fault-tolerance contract: the pipeline is a pure function of (seed, step) —
restoring a checkpointed ``step`` resumes the exact stream, on any number of
hosts (each host slices its data-parallel shard by rank)."""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 1234
    token_file: str | None = None     # None → synthetic
    n_hosts: int = 1
    host_id: int = 0


class TokenPipeline:
    """Yields {"inputs" [B,S+? ...], "targets" [B,S]} per step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self._mm = None
        if cfg.token_file:
            self._mm = np.memmap(cfg.token_file, dtype=np.int32, mode="r")
            if self._mm.size < cfg.seq_len + 1:
                raise ValueError("token file too small")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        B, S = self.local_batch, cfg.seq_len
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        if self._mm is None:
            toks = rng.integers(0, cfg.vocab, size=(B, S + 1), dtype=np.int32)
        else:
            max_start = self._mm.size - (S + 1)
            starts = rng.integers(0, max_start, size=B)
            toks = np.stack([self._mm[s:s + S + 1] for s in starts])
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:].astype(np.int32)}

    # ------------------------------------------------------------- prefetch
    def prefetch(self, start_step: int, depth: int = 2):
        """Background-thread prefetching iterator (overlaps host data work
        with device steps)."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                q.put((s, self.batch_at(s)))
                s += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass


def write_token_file(path: str, tokens: np.ndarray):
    np.asarray(tokens, dtype=np.int32).tofile(path)
