"""The dry-run's peak memory a device at full depth against the probes'
estimate, for ``chip_smoke.py``'s five full-width cells on the fake
2x16x16 mesh.

``chip_smoke.py`` extrapolates each cell's peak live bytes from probes at
1 and 2 pattern groups (``run_cell(production=False)``), which is fast but
an estimate.  This script also traces each cell at its full depth and
production microbatches (``_compile_cell``, the production trace) and
prints both peaks, their difference and the seconds each took, then one
JSON line (also written to ``chiprun_out/dryrun_peak_check.json``)::

    python3 scripts/dryrun_peak_check.py [--device cuda|cpu]

The traces run on fake tensors (no device memory) but at full width:
run it where a full-width trace may take tens of GiB of host memory.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from chip_smoke import DRYRUN_CELLS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, pod_size_of

    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(smi, flush=True)
    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"),
                     device_type=args.device)
    rows = []
    for arch, shape in DRYRUN_CELLS:
        kw = {k: (dict(v) if isinstance(v, dict) else v) for k, v in
              dryrun.PROD_CELL_OPTS.get((arch, shape), {}).items()}
        t0 = time.perf_counter()
        est = dryrun.run_cell(arch, shape, mesh=mesh, production=False,
                              verbose=False, **dict(kw))
        t1 = time.perf_counter()
        full = dryrun._compile_cell(arch, shape, mesh, pod_size_of(mesh),
                                    **dict(kw))
        t2 = time.perf_counter()
        row = {"arch": arch, "shape": shape,
               "probe_peak_bytes": est["peak_bytes_per_dev"],
               "full_peak_bytes": full["peak_bytes"],
               "short_bytes": full["peak_bytes"] - est["peak_bytes_per_dev"],
               "probes_s": t1 - t0, "full_trace_s": t2 - t1}
        rows.append(row)
        print(f"{arch} x {shape} x 2x16x16: full-depth trace peak "
              f"{row['full_peak_bytes'] / 2**30:.3f} GiB a device, probes' "
              f"estimate {row['probe_peak_bytes'] / 2**30:.3f} GiB (short by "
              f"{row['short_bytes'] / 2**30:.3f} GiB); trace "
              f"{row['full_trace_s']:.1f} s, probes {row['probes_s']:.1f} s",
              flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dryrun_peak_check.json").write_text(json.dumps(rows, indent=1))
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
