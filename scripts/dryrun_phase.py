"""Run ``chip_smoke.py``'s dry-run phase alone on one card.

``chip_smoke.dryrun_phase``: the ERT micro-kernels (``ert_stream``,
``ert_gather``) against their plain versions and the measured ceilings
(``repro_torch.launch.roofline.ert_sweep`` in float32 and float64, the
reference's working sets and two past the L2); the AMG cell (the SpMV's
halo exchange on 2 x 256 stacked ranks, standard / NAP-2 / NAP-3, each
halo bit-equal to ``x[need]``); the full-width dry-run of five cells on
the fake 2x16x16 mesh (probes at 1 and 2 pattern groups, extrapolated).
Builds the ERT kernels only.  (A real sharded step on 8 gloo ranks on
``cuda:0`` is not run: gloo crashes on the functional all-gather DTensor
issues on CUDA tensors, ``scripts/gloo_cuda_probe.py``; the CPU tests run
it on gloo CPU ranks.)  The same checks and
prints as the smoke; its numbers as one JSON line, then ``OK``::

    python3 scripts/dryrun_phase.py
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
        print("dryrun_phase: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"build: {build(['ert_stream', 'ert_gather'])}", flush=True)
    out, entries = cs.dryrun_phase(smi)
    print(json.dumps({"kernels": entries, "dryrun": out}, default=str),
          flush=True)
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
