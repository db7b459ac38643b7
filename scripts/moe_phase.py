"""Run ``chip_smoke.py``'s MoE phase alone on one card: the quickest check
that the MoE archs still serve there.

Builds the kernels, then runs ``chip_smoke.moe_phase``: ``mixtral-8x22b``
and ``qwen3-moe-235b-a22b`` at full width and 2 layers, served in bf16 on
the smoke's first 4 prompts (flash launched layers x batches times), each
checked routing-aware against the plain attention, then one qwen3-moe
layer's MoE expert parallel over 2 x 4 stacked ranks.  The same checks and
prints as the smoke; its numbers as one JSON line, then ``OK``::

    python3 scripts/moe_phase.py
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
    from repro_torch.kernels.build import build

    if not torch.cuda.is_available():
        print("moe_phase: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build()
    runs, flash = cs.moe_phase()
    print(json.dumps({"moe": runs, "flash_launches": flash}), flush=True)
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
