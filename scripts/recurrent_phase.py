"""Run ``chip_smoke.py``'s head-dim-256 flash cases and its recurrent phase
alone on one card: the quickest check that the recurrent archs still serve
there.

Builds the kernels and prints every instance's ``ptxas -v`` line of both
flash kernels (``flash_attention``, ``flash_attention_wgmma``), then runs
``chip_smoke.flash_phase`` at head dim 256 only (recurrentgemma-9b's
prefill, and with a 256-key window, in f32 and bf16,
against the plain version, beside SDPA and the bound) and
``chip_smoke.recurrent_phase``: xlstm-125m in f32 and bf16 and
recurrentgemma-9b in bf16 at full width and depth, served on the smoke's
first 4 prompts, checked kernel vs plain and one layer of each recurrent
kind against float64.  The same checks and prints as the smoke; its numbers
as one JSON line, then ``OK``::

    python3 scripts/recurrent_phase.py
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
    from repro_torch.configs import get_arch
    from repro_torch.kernels.build import build, build_report

    if not torch.cuda.is_available():
        print("recurrent_phase: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build()
    ptxas = {k: build_report(k) for k in cs.FLASH_KERNELS}
    for inst, used in ptxas["flash_attention"] + ptxas["flash_attention_wgmma"]:
        print(f"ptxas {inst}: {used}", flush=True)
    S = max(len(p) for p in cs.lm_workload(get_arch(cs.LM_ARCH).vocab))
    rows = cs.flash_phase(S, head_dims=(256,))
    runs, flash = cs.recurrent_phase()
    print(json.dumps({"flash_head_dim_256": cs.flash_instances(rows, ptxas, 256),
                      "recurrent": runs, "flash_launches": flash}), flush=True)
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
