"""Hold the port's ELL SpMV kernel against other versions of it on one card.

Builds ``src/repro_torch/kernels/spmv/csrc/ell_spmv.cu`` and each source
SRC given (same C interface, e.g. an earlier commit's ``ell_spmv.cu`` or an
edited copy; named by its file stem) into ``build/tune_ell_spmv/``, one
``nvcc -Xptxas -v`` each, all at once, and prints each build's register and
spill counts.  Then, on the AMG path of ``laplace_3d(SIZE)`` over 2 x 4
ranks, it checks every version against the plain version and times it,
``torch.sparse.mm`` on the same operator and the byte bound (CUDA events
around bursts of 10 calls queued behind a GPU spin, median of 25, as
``chip_smoke.py`` times): at every operand the f64 solve launches, with its
launches per solve counted by operand, and at level 0's A_on in float32.
Each operand is timed in the order SRC..., kernel, kernel, ...SRC and each
version reports the mean of its two times.

Run from the root of a checkout, on a machine with a card::

    python3 scripts/tune_ell_spmv.py SRC [SRC ...] [--size 64] [--out results.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def build_variants(variants: dict[str, Path], out_dir: Path) -> dict:
    """name -> source; builds all at once, returns the C entry point of
    each."""
    from repro_torch.kernels.build import KERNELS, NVCC_FLAGS, nvcc_path

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        lib = out_dir / f"ell_spmv_{name}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "entry function" in ln or "registers" in ln or "spill" in ln]
        print(f"{name}:", " | ".join(regs), flush=True)
        fn = getattr(ctypes.CDLL(str(lib)), KERNELS["ell_spmv"][1])
        fn.argtypes = KERNELS["ell_spmv"][2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_operand(cs, fns, name, cols, vals, m, rng, order) -> dict:
    """Check every variant at one operand against the plain version and
    time it (``order``: variant names, in the order they are timed; a name
    timed twice reports its mean)."""
    from repro_torch.kernels.spmv.ref import ell_spmv_ref

    D, n, K = cols.shape
    dt = vals.dtype
    s = vals.element_size()
    nnz = int((cols >= 0).sum())
    x = torch.as_tensor(rng.standard_normal((D, m)), dtype=dt, device="cuda")
    want = ell_spmv_ref(cols, vals, x)
    scale = float(want.abs().max()) or 1.0
    csr = cs.ell_to_csr(cols, vals, m)
    xf = x.reshape(-1, 1)
    row = {"operand": name, "dtype": str(dt).replace("torch.", ""),
           "shape": [D, n, K], "m": m, "fill": nnz / (D * n * K),
           "bound_ms": (D * n * K * 4 + nnz * s + D * (m + n) * s)
           / cs.HBM_BYTES_PER_S * 1e3,
           "library_ms": cs.time_ms(lambda: torch.sparse.mm(csr, xf))[0]}
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty((D, n), dtype=dt, device="cuda")

    def call(fn):
        rc = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                D, n, K, m, int(dt == torch.float64), stream)
        assert rc == 0, rc

    times: dict[str, list] = {}
    for v in order:
        if v not in times:
            y.fill_(float("nan"))
            call(fns[v])
            torch.cuda.synchronize()
            err = float((y - want).abs().max()) / scale
            cs.check(err <= cs.RTOL[dt], f"{v} {name} {row['dtype']}: error "
                     f"{err:.2e} of max|plain|")
        times.setdefault(v, []).append(cs.time_ms(lambda: call(fns[v]))[0])
    for v, ts in times.items():
        row[f"{v}_ms"] = float(np.mean(ts))
    print(f"{name} {row['dtype']} [{D}, {n}, {K}] fill {row['fill']:.2f}: bound "
          f"{row['bound_ms']:.4f} ms, torch.sparse.mm {row['library_ms']:.4f} ms; "
          + ", ".join(f"{v} {row[f'{v}_ms']:.4f}" for v in times), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("sources", nargs="+", metavar="SRC",
                    help="other ell_spmv.cu sources to hold the kernel against")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_ell_spmv: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.kernels.build import source_path

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    others = {Path(b).stem: Path(b) for b in args.sources}
    variants = {**others, "kernel": source_path("ell_spmv")}
    order = [*others, "kernel", "kernel", *reversed(others)]
    fns = build_variants(variants, ROOT / "build" / "tune_ell_spmv")
    A = laplace_3d(args.size)
    rng = np.random.default_rng(0)
    results, sums = [], {}
    for dtype in ("float64", "float32"):
        bound = AMGSolver(AMGConfig(backend="torch", n_pods=2, lanes=4, dtype=dtype,
                                    tol=1e-8, device="cuda")).setup(A)
        ops = cs.ell_operands(bound.dist_hierarchy)
        per_solve = {}
        if dtype == "float64":
            per_solve, _ = cs.operand_launches(bound, rng.standard_normal(A.nrows))
        for name in per_solve or ["L0 A_on"]:
            row = time_operand(cs, fns, name, *ops[name], rng, order)
            row["launches_per_solve"] = per_solve.get(name)
            results.append(row)
            for v in variants:
                if row["launches_per_solve"]:
                    sums[v] = sums.get(v, 0.0) + row["launches_per_solve"] * row[f"{v}_ms"]
        del bound
        torch.cuda.empty_cache()
    if sums:
        print("f64 solve, sum of launches x ms over its operands: "
              + ", ".join(f"{v} {t:.4f} ms" for v, t in sums.items()))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "rows": results,
                                              "launch_ms_per_solve": sums}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
