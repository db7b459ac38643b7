"""Run ``chip_smoke.py``'s process phase alone on one card: the quickest
check that one process per rank (``AMGConfig(ranks="process")``) still runs
there.

Builds the kernels, sets up the main path's f64 stacked session on
``laplace_3d(64)`` (2 x 4 ranks, captured graphs), runs its PCG on ``b``
and on ``[n, 8]`` with the launch counters set to 0 just before each and
read just after, times a warm solve, runs the stacked bfloat16 session's
PCG of ``b`` (what the ranks' bfloat16 PCG is held to), then runs
``chip_smoke.process_phase`` against those numbers (8 gloo processes on
``cuda:0``; the same checks and prints as the smoke).  Prints the phase's
numbers as one JSON line, then ``OK``::

    python3 scripts/process_phase.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# at module level: each spawned rank imports this script first
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.kernels.build import build

    if not torch.cuda.is_available():
        print("process_phase: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    build()
    A = laplace_3d(cs.SIZE)
    b, B = cs.process_rhs(A.nrows)
    bound = AMGSolver(AMGConfig(backend="torch", n_pods=cs.N_PODS,
                                lanes=cs.LANES, dtype="float64",
                                tol=1e-8)).setup(A)
    res, c1 = cs.counted(lambda: bound.pcg(b))
    resm, cm = cs.counted(lambda: bound.pcg(B))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = bound.pcg(b)
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) * 1e3 / max(warm.iterations, 1)
    res16 = AMGSolver(bound.config.replace(dtype="bfloat16",
                                           tol=cs.BF16_TOL)).setup(A).pcg(b)
    out = cs.process_phase(A, b, B, res, resm, c1, cm, ms_iter, res16)
    print(json.dumps(out), flush=True)
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
