"""Run ``chip_smoke.py``'s training and grad-sync phases alone on one card:
the quickest check that the port still trains there.

``chip_smoke.train_phase``: qwen3-1.7b in f32 at full width and depth
through ``repro_torch.launch.train`` at its defaults (batch 8, seq 256),
its checkpoint restored and stepped against the live model, 2 microbatches
against 1, timed steps, the loss falling on a periodic token file, a seq-2048
step from that run's state with ``chunked_attention`` against the plain
attention, seq 2048 with remat (``chunked_attention``), the step against float64 at 2 layers
(seq 256, and seq 2048 with remat), and xlstm-125m trained 4 steps; then ``chip_smoke.grad_sync_phase``:
``hier_grad_sync`` over one qwen3-1.7b layer's gradients on the 2 x 4
stacked ranks and on 8 gloo processes on the card.  Training launches no
custom kernel (the flash kernel has no backward), so nothing is built.  The
same checks and prints as the smoke; its numbers as one JSON line, then
``OK``::

    python3 scripts/train_phase.py
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("train_phase: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train = cs.train_phase()
    grad_sync = cs.grad_sync_phase()
    print(json.dumps({"train": train, "grad_sync": grad_sync}), flush=True)
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
