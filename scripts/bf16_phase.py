"""Run ``chip_smoke.py``'s bfloat16 phase alone on one card: the quickest
check that a bfloat16 session still solves there.

Builds the kernels and prints the ``ptxas -v`` line of every instance of
the three sparse kernels, sets up ``laplace_3d(64)`` on 2×4 stacked ranks
as the smoke does, runs its float64 PCG of one RHS and of ``[n, 8]``
(counted, through the captured graphs: what the bfloat16 run is held
against), then ``chip_smoke.bf16_phase``: the bfloat16 lowering of the
same host setup, ``ell_spmv`` / ``ell_spmm`` / ``bcsr_spmm`` in bfloat16
at its operands against their plain versions (device ms, bound, plain ms,
``torch.sparse.mm`` where it takes bfloat16), PCG to 1e-5 through the
graphs and a k = 8 solve through ``AMGService``; then the f64
``block_jacobi`` and ``hybrid_gs_sym`` PCG (one RHS, and ``[n, 8]`` with
``hybrid_gs_sym``), and ``chip_smoke.bf16_block_phase``: the block
smoothers' bfloat16 kernels against their plain versions (``tri_solve``'s
one-step floors from a bfloat16 chain), their PCG through the
graphs held to the f64 x, and a k = 8 ``hybrid_gs_sym`` chunk through
``AMGService``.  The same checks and prints as the smoke; its numbers as
one JSON line, then ``OK``::

    python3 scripts/bf16_phase.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.amg.solve import SolveOptions
    from repro_torch.kernels.build import build, build_report

    if not torch.cuda.is_available():
        print("bf16_phase: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    build()
    for k in cs.SPMV_KERNELS + cs.SMOOTHER_KERNELS:
        for inst, used in build_report(k):
            print(f"ptxas {inst}: {used}", flush=True)
    A = laplace_3d(cs.SIZE)
    rng = np.random.default_rng(cs.SEED)
    b = rng.standard_normal(A.nrows)
    B = np.stack([b] + [rng.standard_normal(A.nrows)
                        for _ in range(cs.K_RHS - 1)], axis=1)
    cfg64 = AMGConfig(backend="torch", n_pods=cs.N_PODS, lanes=cs.LANES,
                      dtype="float64", tol=1e-8, device=cs.DEVICE)
    bound64 = AMGSolver(cfg64).setup(A)
    res, c64 = cs.counted(lambda: bound64.pcg(b))
    cs.check(res.converged, "f64 PCG did not converge")
    resm = bound64.pcg(B)
    cs.check(resm.converged, "f64 [n, 8] PCG did not converge")
    print(f"pcg f64: {res.iterations} iterations, launches {c64}", flush=True)
    t0 = time.perf_counter()
    rows, launches, info, bound16, _ = cs.bf16_phase(cfg64, A, b, B, res,
                                                     resm, c64)
    info["phase_s"] = time.perf_counter() - t0
    print(f"bf16 phase: {info['phase_s']:.1f} s", flush=True)
    x64 = {}
    for smoother, rhs in (("block_jacobi", b), ("hybrid_gs_sym", b),
                          ("hybrid_gs_sym", B)):
        r = AMGSolver(cfg64.replace(opts=SolveOptions(smoother=smoother))) \
            .setup(A).pcg(rhs)
        cs.check(r.converged, f"f64 {smoother} PCG did not converge")
        x64[smoother if rhs.ndim == 1 else (smoother, rhs.shape[1])] = r.x
    t0 = time.perf_counter()
    smoother_rows, block = cs.bf16_block_phase(bound16, A, b, B, x64)
    block["phase_s"] = time.perf_counter() - t0
    print(f"bf16 block-smoother phase: {block['phase_s']:.1f} s", flush=True)
    print(json.dumps({"card": smi, "kernels": {**rows, **smoother_rows},
                      "launches": launches, "pcg_bf16": info,
                      "block_bf16": block}), flush=True)
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
