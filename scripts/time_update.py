"""Time the streaming refresh (``update(delta=)``) of ``chip_smoke.py``'s
main-path sessions on one card.

Sets up ``laplace_3d(SIZE)`` on 2 x 4 ranks with ``backend="torch"`` in
float64 and in float32 (one shared host hierarchy, two lowerings, as the
smoke's sessions), runs one Jacobi PCG on each (the graphs are captured),
then times ``REPEATS`` updates of the float64 session, each refreshing both
lowerings beneath their graphs (the drift is the smoke's, applied and then
taken back in turn).  With ``--block`` it then runs ``block_jacobi`` and
``hybrid_gs_sym`` PCG on both sessions, which places their sparse factors
at every smoothing level, and times ``REPEATS`` updates again: what the
placed factors add to a refresh.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (an
earlier commit's, unpacked with ``git archive``), so two versions are
compared in one call: run them in the order parent, change, change,
parent.  Prints one JSON line::

    python scripts/time_update.py [--src DIR] [--size 64] [--repeats 3] [--block]
                                  [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def drift(A, scale=0.03, seed=1):
    """``chip_smoke.drift``: a symmetric value-only drift on A's pattern."""
    from repro_torch.amg.csr import CSR

    rng = np.random.default_rng(seed)
    data = A.data * (1.0 + scale * rng.random(A.nnz))
    At = CSR(A.shape, A.indptr.copy(), A.indices.copy(), data).T
    return CSR(A.shape, A.indptr.copy(), A.indices.copy(),
               0.5 * (data + At.data))


def timed_updates(bound, delta, repeats: int) -> list[float]:
    out = []
    for i in range(repeats):
        t0 = time.perf_counter()
        action = bound.update(delta=delta if i % 2 == 0 else -delta)
        out.append(time.perf_counter() - t0)
        if action != "refresh":
            raise SystemExit(f"update took {action!r}, want 'refresh'")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--block", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a dry run")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.amg.solve import SolveOptions

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    A = laplace_3d(args.size)
    b = np.random.default_rng(0).standard_normal(A.nrows)
    delta = drift(A).data - A.data
    cfgs = {dt: AMGConfig(backend="torch", n_pods=2, lanes=4, dtype=dt,
                          tol=1e-8 if dt == "float64" else 1e-5,
                          device=args.device)
            for dt in ("float64", "float32")}
    t0 = time.perf_counter()
    bound = {dt: AMGSolver(c).setup(A) for dt, c in cfgs.items()}
    for s in bound.values():
        if not s.pcg(b).converged:
            raise SystemExit("Jacobi PCG did not converge")
    out = {"src": str(args.src), "size": args.size,
           "lowerings": len(bound["float64"].hierarchy.dist_cache),
           "setup_and_first_solves_s": time.perf_counter() - t0,
           "jacobi_update_s": timed_updates(bound["float64"], delta, args.repeats)}
    if args.block:
        from repro_torch.amg.dist_solve import dist_pcg

        for dt, c in cfgs.items():
            for sm in ("block_jacobi", "hybrid_gs_sym"):
                res = dist_pcg(bound[dt].dist_hierarchy, b, tol=c.tol,
                               opts=SolveOptions(smoother=sm))
                if not res.converged:
                    raise SystemExit(f"{sm} PCG ({dt}) did not converge")
        out["factor_bytes"] = sum(dh.factor_bytes() for dh in
                                  bound["float64"].hierarchy.dist_cache.values())
        out["block_update_s"] = timed_updates(bound["float64"], delta, args.repeats)
    if args.device == "cuda":
        gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        out["gpu"] = gpu.stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
