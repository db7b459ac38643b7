"""Hold one of the port's kernels against other versions of its source on
one card.

Builds the kernel's source (``--kernel ell_spmv``, the default,
``ell_spmm``, ``flash_attention``, ``flash_attention_tf32``,
``flash_attention_wgmma``, ``tri_solve`` or ``block_diag_apply``; ``repro_torch.kernels.build``) and each
source SRC given (same C interface, e.g. an earlier commit's source or an
edited copy; named by its file stem) into ``build/tune_<kernel>/``, one
``nvcc -Xptxas -v`` each, all at once, and prints each build's register and
spill counts and, from ``cuobjdump -sass``, the count of tensor-core
instructions (``HMMA``: ``mma.sync``; ``HGMMA``: ``wgmma``) and float32 FMA
(``FFMA``) instructions of each kernel instance.
Then at each case it checks every version against the plain version
(``chip_smoke.py``'s bars) and times it beside the library call and the
bound (CUDA events around bursts of 10 calls queued behind a GPU spin,
median of 25, as ``chip_smoke.py`` times), in the order SRC..., kernel,
kernel, ...SRC; each version reports the mean of its two times.  The cases:

- ``ell_spmv``: on the AMG path of ``laplace_3d(SIZE)`` over 2 x 4 ranks,
  every operand the f64 solve launches, then every operand the bfloat16
  solve (tolerance 1e-5) launches, each with its launches per solve counted
  by operand and level 0's A_on also with the L2 flushed before every call,
  and level 0's A_on in float32; ``torch.sparse.mm`` and the byte bound;
  ``--dtype bfloat16`` runs the bfloat16 pass alone (an earlier commit's
  source as SRC: ``git show <commit>:src/repro_torch/kernels/spmv/csrc/
  ell_spmv.cu > build/old_ell_spmv.cu``);
- ``ell_spmm``: the same at the solves of ``[n, 8]`` (8 right-hand sides);
- ``flash_attention`` (float32, 3xTF32 on ``mma.sync``): ``chip_smoke.py``'s
  cases at the serving run's longest prompt (qwen3-1.7b: B 4, 16 query / 8
  KV heads of 128, S 1819, causal; with a 256-key window; 128 queries over
  1024 keys; head dim 64, 14 / 2 heads; recurrentgemma-9b's 16:1 at head
  dim 256, its 2048-key window and a 256-key one; phi-3-vision-4.2b's 32:32
  at head dim 96) (``--head-dim D``: only those);
  ``scaled_dot_product_attention`` and the flop bound (3xTF32 on the tensor
  cores, with the FMA units' bound beside it); then large scores (q x 8, k
  + 50) against a float64 truth, beside the float32 plain version's error;
- ``flash_attention_tf32`` (float32, 3xTF32 on ``wgmma`` fed by TMA, same C
  interface; head dims 96 and 256): the float32 cases above at those head
  dims (recurrentgemma-9b's 16:1 with its 2048-key window and a 256-key one;
  phi-3-vision-4.2b's 32:32 prefill), then their large scores.  An earlier
  commit's ``flash_attention.cu`` as SRC (``git show 7d8f434:src/repro_torch/
  kernels/flash_attention/csrc/flash_attention.cu > build/mma_sync.cu``, one
  that still has the float32 ``mma.sync`` instances at 96 and 256) holds the
  two designs against each other;
- ``flash_attention_wgmma`` (bfloat16, the Hopper design, same C
  interface): the same cases and the MoE archs' (mixtral-8x22b 48:8 with
  its 4096-key window, qwen3-moe 64:4) in bfloat16, beside SDPA and the
  flop bound at the tensor cores' 989 TFLOP/s.  An earlier commit's
  ``flash_attention.cu`` as SRC (``git show <commit>:src/repro_torch/
  kernels/flash_attention/csrc/flash_attention.cu > build/old.cu``, one that
  still has bfloat16 instances on ``mma.sync``) holds the two designs
  against each other.  Tile shapes are the ``Cfg`` lines of the source
  (``BK``, ``STAGES``) and its ``L2_FIT_BYTES`` / ``L2_SECTION_BYTES``: a
  Python ``str.replace`` of one into ``build/`` makes a variant;
- ``tri_solve``: both triangles of every non-coarsest level of the f64
  lowering of ``laplace_3d(SIZE)`` over 2 x 4 ranks (its own factors and
  row orders), k = 1 and 8, and level 0 in float32, on every route that
  can take the case (``smoother.tri_routes``: L2; block where a rank fits a
  block; staged for bfloat16 at k = 1), with the rule's; each with its DAG
  depth and µs a dependent step, ``torch.triangular_solve`` on a sparse
  CSR operand (cuSPARSE; float32-widened for bfloat16) and the byte bound;
  ``--chain M`` adds a chain of M rows (the one-step floor), ``--level L``
  keeps level L alone, ``--cube N`` (repeatable, with ``--size 0`` alone)
  sweeps the 27-point stencil's triangle on an N³ box a rank on each route,
  ``--wide W[:K]`` (repeatable) a triangle of 32,768 rows a rank in level
  sets of W rows and K slots a row (13 if not given), the readings behind
  the route rule's widths (``smoother.BLOCK_MAX_WIDTH``,
  ``smoother.STAGED_MAX_WIDTH``).  ``--dtype bfloat16`` runs the
  bfloat16 pass instead: the chain, the cubes and both triangles of every
  non-coarsest level of the bfloat16 lowering, k = 1 and 8, held to the
  card's bfloat16 bar.  A variant of ``tri_solve.cu`` is a copy with one
  of its constants edited (``LANES``, ``BLOCK_THREADS``,
  ``L2_BLOCKS_PER_SM``, ``STAGED_ROWS``, ``STAGED_CONSUMERS``,
  ``STAGED_MAX_STAGES``);
- ``block_diag_apply``: the bs = 4 block inverses of every non-coarsest
  level of the lowering of ``laplace_3d(SIZE)`` over 2 x 4 ranks, k = 1
  and 8, in each type (``--dtype``), against the plain version (bfloat16
  at the card's bar, and whether each version equals
  ``smoother/bf16_order.py``'s emulation bit for bit), beside batched
  ``torch.matmul`` and the byte bound; an earlier commit's source as SRC
  (``git show <commit>:src/repro_torch/kernels/smoother/csrc/
  block_diag_apply.cu > build/old_block_diag_apply.cu``).

Run from the root of a checkout, on a machine with a card::

    python3 scripts/tune_kernel.py [SRC ...] [--kernel ell_spmm]
        [--dtype bfloat16] [--size 64] [--out results.json]
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
FLASH_S = 1819      # the serving run's longest prompt (chip_smoke.lm_workload)
UNCHECKED: set[str] = set()     # versions timed without holding their error


def build_variants(kernel: str, variants: dict[str, Path], out_dir: Path) -> dict:
    """name -> source of ``kernel``; builds all at once, prints each
    instance's registers and SASS counts, returns the C entry point of
    each."""
    from repro_torch.kernels.build import (KERNELS, NVCC_FLAGS, nvcc_path, ptxas_report,
                                           shared_headers, source_path)

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        lib = out_dir / f"{kernel}_{name}.so"
        # a source's own directory comes first (a variant's edited header
        # beside it), then the tree's kernel headers
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(source_path(kernel).parent),
               "-I", str(shared_headers()), "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for inst, used in ptxas_report(log):
            print(f"{name} {inst}: {used}", flush=True)
        for fn_name, counts in sass_counts(lib).items():
            ops = counts.pop("ops")
            print(f"{name} SASS {fn_name[:90]}: {counts}; {sum(ops.values())} "
                  f"instructions, most common {ops.most_common(14)}", flush=True)
        fn = getattr(ctypes.CDLL(str(lib)), KERNELS[kernel][1])
        fn.argtypes = KERNELS[kernel][2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def sass_counts(lib: Path) -> dict[str, dict[str, int]]:
    """Per kernel function of ``lib``: its HMMA, HGMMA and FFMA instruction counts,
    and under "ops" the count of every opcode (modifiers dropped)."""
    from repro_torch.kernels.build import nvcc_path

    sass = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0, "ops": collections.Counter()}
        elif name:
            for op in ("HMMA", "HGMMA", "FFMA"):
                if re.search(rf"\b{op}\b", line):
                    out[name][op] += 1
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                out[name]["ops"][m.group(1)] += 1
    return out


def hold(cs, fns, order, row, call, error, bar) -> None:
    """Check each version once (``error(fn)``: its error over the plain
    version, at most ``bar``, except for the versions in UNCHECKED, whose
    error is only reported), time it at each of its places in ``order``
    and put the mean into ``row``."""
    times: dict[str, list] = {}
    for v in order:
        if v not in times:
            err = error(fns[v])
            cs.check(err <= bar or v in UNCHECKED,
                     f"{v} {row.get('operand', '')} {row['dtype']}: "
                     f"error {err:.2e} of plain, above {bar:g}")
            row[f"{v}_rel_err"] = err
        times.setdefault(v, []).append(cs.time_ms(lambda: call(fns[v]))[0])
    for v, ts in times.items():
        row[f"{v}_ms"] = float(np.mean(ts))


def ell_case(cs, fns, order, name, cols, vals, m, rng, k, cold=False) -> dict:
    """One ELL operand (``k``: None for ``ell_spmv``, else the right-hand
    sides of ``ell_spmm``); bfloat16 at the card's bar (``chip_smoke.py:
    bf16_bar``, at most 1), the library call on the bfloat16 CSR where the
    install has one.  ``cold``: also each version's time with the L2
    flushed before every call (``chip_smoke.py:time_cold_ms``)."""
    from repro_torch.kernels.spmv import ref
    from repro_torch.kernels.spmv.spmv import DTYPE_CODES

    D, n, K = cols.shape
    dt = vals.dtype
    s = vals.element_size()
    nnz = int((cols >= 0).sum())
    ext = (k,) if k else ()
    x = torch.as_tensor(rng.standard_normal((D, m) + ext), dtype=dt, device="cuda")
    plain = ref.ell_spmm_ref if k else ref.ell_spmv_ref
    want = plain(cols, vals, x)
    scale = float(want.abs().max()) or 1.0
    csr = cs.ell_to_csr(cols, vals, m)
    xf = x.reshape(D * m, -1)
    library, library_error = ((lambda: torch.sparse.mm(csr, xf)), None)
    if dt == torch.bfloat16:
        library, library_error = cs.bf16_library(csr, xf)
        rel = cs.bf16_rel(plain, (cols, vals, x))
    row = {"operand": name, "dtype": str(dt).replace("torch.", ""),
           "shape": [D, n, K], "m": m, "k": k or 1, "fill": nnz / (D * n * K),
           "bound_ms": (D * n * K * 4 + nnz * s + D * (m + n) * (k or 1) * s)
           / cs.HBM_BYTES_PER_S * 1e3,
           "library_ms": None if library is None else cs.time_ms(library)[0],
           "library_error": library_error}
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty((D, n) + ext, dtype=dt, device="cuda")

    def call(fn):
        rc = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                D, n, K, m, *ext, DTYPE_CODES[dt], stream)
        assert rc == 0, rc

    def error(fn):
        y.fill_(float("nan"))
        call(fn)
        torch.cuda.synchronize()
        if dt == torch.bfloat16:
            return rel(y, want)
        return float((y - want).abs().max()) / scale

    hold(cs, fns, order, row, call, error,
         1.0 if dt == torch.bfloat16 else cs.RTOL[dt])
    if cold:
        for v in dict.fromkeys(order):
            row[f"{v}_cold_ms"] = cs.time_cold_ms(lambda: call(fns[v]))
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
    print(f"{name} {row['dtype']} [{D}, {n}, {K}] k {k or 1} fill {row['fill']:.2f}: bound "
          f"{row['bound_ms']:.4f} ms, torch.sparse.mm {lib}; "
          + ", ".join(f"{v} {row[f'{v}_ms']:.4f}"
                      + (f" (L2 flushed {row[f'{v}_cold_ms']:.4f})" if cold else "")
                      for v in dict.fromkeys(order)), flush=True)
    return row


def ell_cases(cs, fns, order, kernel: str, size: int,
              dtypes=("float64", "float32", "bfloat16"), only=None) -> tuple[list, dict]:
    """In float64 and in bfloat16, every operand the solve launches (the
    float64 and the bfloat16 PCG to their tolerances, one right-hand side
    for ``ell_spmv``, K_RHS for ``ell_spmm``), with launches per solve
    counted by operand, level 0's A_on also with the L2 flushed; in float32
    level 0's A_on alone; ``only``: just these operands.  Returns the rows
    and each version's launches x ms per solve, by type."""
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d

    k = cs.K_RHS if kernel == "ell_spmm" else None
    A = laplace_3d(size)
    rng = np.random.default_rng(0)
    rows, sums = [], {}
    for dtype in dtypes:
        tol = cs.BF16_TOL if dtype == "bfloat16" else 1e-8
        bound = AMGSolver(AMGConfig(backend="torch", n_pods=2, lanes=4, dtype=dtype,
                                    tol=tol, device="cuda")).setup(A)
        ops = cs.ell_operands(bound.dist_hierarchy)
        per_solve = {}
        if dtype != "float32":
            rhs = rng.standard_normal((A.nrows,) + ((k,) if k else ()))
            per_solve, iters = cs.operand_launches(bound, rhs, kernel)
            print(f"{dtype} solve ({iters} iterations): {kernel} launches by operand "
                  f"{per_solve}", flush=True)
        for name in per_solve or ["L0 A_on"]:
            if only and name not in only:
                continue
            row = ell_case(cs, fns, order, name, *ops[name], rng, k,
                           cold=dtype != "float32" and name == "L0 A_on")
            row["launches_per_solve"] = per_solve.get(name)
            rows.append(row)
            if row["launches_per_solve"]:
                for v in fns:
                    sums.setdefault(dtype, {}).setdefault(v, 0.0)
                    sums[dtype][v] += row["launches_per_solve"] * row[f"{v}_ms"]
        del bound
        torch.cuda.empty_cache()
    for dtype, by in sums.items():
        print(f"{dtype} solve, sum of launches x ms over its operands: "
              + ", ".join(f"{v} {t:.4f} ms" for v, t in by.items()), flush=True)
    return rows, sums


def flash_cases(cs, fns, order, head_dims, dtypes) -> list:
    """``chip_smoke.py``'s flash cases at the serving run's longest prompt
    (prefill, a 256-key window, Sq < Skv, head dim 64, recurrentgemma-9b's
    head dim 256 with its window and a 256-key one, phi-3-vision-4.2b's
    head dim 96), causal, in ``dtypes``, and the MoE archs' prefill shapes
    in bfloat16 (as served); ``head_dims``: only the cases at those."""
    from repro_torch.kernels.flash_attention.ref import attention_ref, rel_err_rows

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cases = [(shape, dt) for shape in (cs.flash_shapes(FLASH_S)
                                       + cs.recurrent_flash_shapes(FLASH_S)
                                       + cs.embed_flash_shapes(FLASH_S))
             for dt in dtypes]
    cases += [(shape, torch.bfloat16) for shape in cs.moe_flash_shapes(FLASH_S)
              if torch.bfloat16 in dtypes]
    for (label, B, Hq, Hkv, Sq, Skv, D, window), dt in cases:
        if head_dims and D not in head_dims:
            continue
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dt)
                   for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
        o = torch.empty_like(q)
        want = attention_ref(q, k, v, True, window)
        strides = [st for t in (q, k, v, o) for st in t.stride()[:3]]
        stream = torch.cuda.current_stream().cuda_stream
        w = -1 if window is None else window

        def call(fn):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, Hq, Hkv, Sq, Skv, D, *strides, 1, w,
                    int(dt == torch.bfloat16), stream)
            assert rc == 0, rc

        def error(fn):
            o.fill_(float("nan"))
            call(fn)
            torch.cuda.synchronize()
            return rel_err_rows(o, want)

        bounds = cs.flash_bounds(dt, B, Hq, D, cs.visible_pairs(Sq, Skv, True, window),
                                 (2 * q.numel() + 2 * k.numel()) * q.element_size())
        row = {"case": label, "dtype": str(dt).replace("torch.", ""),
               "shape": [B, Hq, Hkv, Sq, Skv, D], "window": window, **bounds,
               "library_ms": cs.time_ms(cs.sdpa_call(q, k, v, window))[0]}
        hold(cs, fns, order, row, call, error, cs.FLASH_RTOL[dt])
        for name in fns:
            row[f"{name}_tflops"] = bounds["flops"] / (row[f"{name}_ms"] * 1e-3) / 1e12
        fma = (f", FMA bound {row['bound_fma_ms']:.4f} ms" if "bound_fma_ms" in row
               else "")
        print(f"{label} {row['dtype']} {row['shape']} window {window}: bound "
              f"{row['bound_ms']:.4f} ms{fma}, sdpa {row['library_ms']:.4f} ms; "
              + ", ".join(f"{n} {row[f'{n}_ms']:.4f} ms ({row[f'{n}_tflops']:.0f} "
                          f"TFLOP/s, error {row[f'{n}_rel_err']:.2e})"
                          for n in dict.fromkeys(order)), flush=True)
        rows.append(row)
        del q, k, v, o, want
    return rows


def flash_large_scores(fns, head_dims=None) -> list:
    """float32 with q x 8 (one key dominates a row) and k + 50 (scores in
    the hundreds), causal, at the card tests' shapes and the prefill shape:
    each version's per-row error over the float64 truth, and the float32
    plain version's."""
    from repro_torch.kernels.flash_attention.ref import (attention_f64, attention_ref,
                                                         rel_err_rows)

    rows = []
    for B, Hq, Hkv, S, D in ((2, 16, 8, 256, 128), (1, 14, 2, 301, 64),
                             (4, 16, 8, FLASH_S, 128), (1, 16, 1, 301, 256),
                             (4, 16, 1, FLASH_S, 256), (1, 32, 32, 301, 96),
                             (4, 32, 32, FLASH_S, 96)):
        if head_dims and D not in head_dims:
            continue
        gen = torch.Generator(device="cuda").manual_seed(2)
        q, k, v = (torch.randn(s, generator=gen, device="cuda")
                   for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
        for kind, (qq, kk) in (("peaked", (q * 8, k)), ("offset", (q, k + 50))):
            truth = attention_f64(qq, kk, v)
            o = torch.empty_like(qq)
            strides = [st for t in (qq, kk, v, o) for st in t.stride()[:3]]
            row = {"shape": [B, Hq, Hkv, S, D], "kind": kind,
                   "plain": rel_err_rows(attention_ref(qq, kk, v), truth)}
            for name, fn in fns.items():
                o.fill_(float("nan"))
                assert fn(qq.data_ptr(), kk.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
                          Hkv, S, S, D, *strides, 1, -1, 0,
                          torch.cuda.current_stream().cuda_stream) == 0
                torch.cuda.synchronize()
                row[name] = rel_err_rows(o, truth)
            print(f"{kind} f32 {row['shape']} over the float64 truth: "
                  + ", ".join(f"{n} {row[n]:.3e}" for n in ("plain", *fns)), flush=True)
            rows.append(row)
            del truth, o
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def tri_case(cs, fns, order, label, f, k, rng, library=True) -> list:
    """``tri_solve`` on factor ``f`` with ``k`` right-hand sides: every
    version on every route that can take the case (``smoother.tri_routes``;
    the C entry point's route code; the staged route reads the factor's
    slab), with µs a dependent step and the route the rule takes."""
    from repro_torch.kernels.smoother import ref as sref
    from repro_torch.kernels.smoother import smoother as ks
    from repro_torch.kernels.spmv.spmv import DTYPE_CODES

    D, m, K = f.cols.shape
    dt, s = f.vals.dtype, f.vals.element_size()
    bf16 = dt == torch.bfloat16
    nnz = int((f.cols >= 0).sum())
    ext = (k,) if k > 1 else ()
    r, x = (torch.as_tensor(rng.standard_normal((D, m) + ext), dtype=dt,
                            device="cuda") for _ in range(2))
    want = sref.tri_solve_ref(f.cols, f.vals, f.diag, r, x, 1.0, f.schedule())
    scale = float(want.abs().max()) or 1.0
    bar = cs.bf16_bar(sref.tri_solve_absum(f.cols, f.vals, f.diag, r, x, 1.0,
                                           f.schedule())) if bf16 else None
    call_lib, lib_name = cs.tri_library(f, r) if library else (None, "not timed")
    smem = ks.tri_smem(r.device)
    rule = ks.tri_plan(m, f.depth(), k, dt, smem, K=K)
    lib_ms = None if call_lib is None else cs.time_ms(call_lib)[0]
    rows = []
    for route in ks.tri_routes(m, f.depth(), k, dt, smem, K=K):
        row = {"case": label, "dtype": str(dt).replace("torch.", ""), "k": k,
               "route": route, "rule": rule, "shape": [D, m, K],
               "depth": f.depth(), "rows_per_set": m / f.depth(),
               "bound_ms": cs.tri_bytes(route, nnz, D, m, k, s)
               / cs.HBM_BYTES_PER_S * 1e3,
               "library": lib_name, "library_ms": lib_ms}
        y = torch.empty_like(x)
        # the L2 route's scratch z, the staged route's slab (the factor's
        # where the rule gave it one)
        z = ((f.slab or ks.TriSlab(f.cols, f.vals, f.diag, f.order)).data
             if route == "staged" else torch.empty_like(r, dtype=ks.z_dtype(dt)))
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn, code=ks.TRI_ROUTE_CODES[route], z=z):
            rc = fn(f.cols.data_ptr(), f.vals.data_ptr(), f.diag.data_ptr(),
                    r.data_ptr(), x.data_ptr(), f.order.data_ptr(),
                    f.starts.data_ptr(), z.data_ptr(), y.data_ptr(), D, m, K, k,
                    f.depth(), 1.0, DTYPE_CODES[dt], code, stream)
            assert rc == 0, rc

        def error(fn, call=call):
            y.fill_(float("nan"))
            call(fn)
            torch.cuda.synchronize()
            if bf16:
                return bar(y, want)
            return float((y - want).abs().max()) / scale

        hold(cs, fns, order, row, call, error, 1.0 if bf16 else cs.RTOL[dt])
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        print(f"{label} {row['dtype']} [{D}, {m}, {K}] k {k} {route} (rule: {rule}) "
              f"depth {row['depth']}, {row['rows_per_set']:.1f} rows a set: bound "
              f"{row['bound_ms']:.4f} ms, cuSPARSE {lib}; "
              + ", ".join(f"{v} {row[f'{v}_ms']:.4f} ({row[f'{v}_ms'] * 1e3 / row['depth']:.3f} "
                          f"us a step)" for v in dict.fromkeys(order)), flush=True)
        rows.append(row)
    return rows


def tri_cube(D: int, n: int, dtype, rng):
    """The 27-point stencil's strict lower triangle on an n³ box in natural
    order on each of D ranks (13 entries a row, depth 7(n - 1) + 1), random
    values, diagonal in [1, 2), as a factor on the card."""
    from repro_torch.kernels.smoother.ops import TriFactor

    i = np.arange(n ** 3)
    x, y, zc = i % n, (i // n) % n, i // (n * n)
    offs = [o for o in np.ndindex(3, 3, 3) if o < (1, 1, 1)]
    cols = np.full((n ** 3, len(offs)), -1, dtype=np.int32)
    for e, (dz, dy, dx) in enumerate(offs):
        cx, cy, cz = x + dx - 1, y + dy - 1, zc + dz - 1
        ok = (cx >= 0) & (cx < n) & (cy >= 0) & (cy < n) & (cz >= 0)
        cols[ok, e] = (cx + n * (cy + n * cz))[ok]
    cols = np.broadcast_to(cols, (D,) + cols.shape).copy()
    return TriFactor.place({"cols": cols, "upper": False,
                            "vals": np.where(cols >= 0, rng.standard_normal(cols.shape)
                                             * 0.5 / 13, 0.0),
                            "diag": 1.0 + rng.random((D, n ** 3))}, "cuda", dtype)


def tri_wide(D: int, m: int, width: int, K: int, dtype, rng):
    """A strict lower triangle of ``m`` rows a rank in level sets of
    ``width`` rows, in level order on each of D ranks: row i of set j > 0
    needs one random row of set j - 1 and K - 1 random rows of sets 0 … j -
    1 (depth ceil(m / width)), random values, diagonal in [1, 2), as a
    factor on the card."""
    from repro_torch.kernels.smoother.ops import TriFactor

    i = np.arange(m)
    base = i // width * width                 # where row i's set begins
    cols = np.full((D, m, K), -1, dtype=np.int32)
    late = base > 0
    prev = base[late] - width
    cols[:, late, 0] = prev + rng.integers(0, width, (D, late.sum()))
    cols[:, late, 1:] = (rng.random((D, late.sum(), K - 1))
                         * base[late, None]).astype(np.int32)
    return TriFactor.place({"cols": cols, "upper": False,
                            "vals": np.where(cols >= 0, rng.standard_normal(cols.shape)
                                             * 0.5 / K, 0.0),
                            "diag": 1.0 + rng.random((D, m))}, "cuda", dtype)


def tri_cases(cs, fns, order, size: int, chain=None, levels=None,
              cubes=(), bf16=False, wides=()) -> list:
    """Both triangles of every non-coarsest level, k = 1 and K_RHS, in f64,
    and level 0 in f32, on the lowering's own factors (``levels``: only
    those); with ``chain`` a pure chain of that many rows (each row needs
    the one before) on 8 ranks and on 1 first, f64, k = 1; with ``cubes``
    the route rule's sweep first: the 27-point stencil's lower triangle on
    an n³ box a rank for each n, 8 ranks, f32 and f64, k = 1 and K_RHS,
    wherever a rank fits a block (:func:`tri_case`); with ``wides`` (pairs
    of rows a set and slots a row) triangles of 32,768 rows a rank (level
    0's) in sets of that width (:func:`tri_wide`), 8 ranks, k = 1.
    ``bf16``: all of it in bfloat16 instead (the levels of the bfloat16
    lowering, every level on both triangles; the cubes wherever a rank's
    float32 z fits a block)."""
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.kernels.smoother.smoother import tri_smem, z_dtype

    rng = np.random.default_rng(0)
    rows = []
    types = (torch.bfloat16,) if bf16 else (torch.float64, torch.float32)
    for n in cubes:
        for dtype in types:
            f = tri_cube(8, n, dtype, rng)
            for k in (1, cs.K_RHS):
                if n ** 3 * k * z_dtype(dtype).itemsize <= tri_smem("cuda"):
                    rows += tri_case(cs, fns, order, f"cube {n}", f, k, rng,
                                     library=False)
    for width, K in wides:
        f = tri_wide(8, 32_768, width, K, types[0], rng)
        rows += tri_case(cs, fns, order, f"wide {width} K{K}", f, 1, rng,
                         library=False)
        del f
    if chain:
        for D in (8, 1):
            f = cs.tri_chain(D, chain, types[0], "cuda")
            rows += tri_case(cs, fns, order, f"chain D{D}", f, 1, rng,
                             library=False)
    if not size:
        return rows
    A = laplace_3d(size)
    for dtype in ("bfloat16",) if bf16 else ("float64", "float32"):
        dh = AMGSolver(AMGConfig(backend="torch", n_pods=2, lanes=4, dtype=dtype,
                                 tol=cs.BF16_TOL if bf16 else 1e-8,
                                 device="cuda")).setup(A).dist_hierarchy
        for l, dl in enumerate(dh.levels):
            if (dl.coarse_inv is not None or (dtype == "float32" and l > 0)
                    or (levels and l not in levels)):
                continue
            for kind in ("gs", "gsu"):
                for k in (1, cs.K_RHS):
                    rows += tri_case(cs, fns, order, f"L{l} {kind}",
                                     dh._factor(l, kind, 0), k, rng)
        del dh
        torch.cuda.empty_cache()
    return rows


def bda_cases(cs, fns, order, size: int, dtypes) -> list:
    """``block_diag_apply`` at bs = 4 (the main path's) on the lowering's
    own block-Jacobi factors at every non-coarsest level, k = 1 and K_RHS,
    in each of ``dtypes``: every version against the plain version
    (bfloat16 at the card's bar, and bit for bit against the order's
    emulation, ``smoother/bf16_order.py``), beside batched ``torch.matmul``
    and the byte bound (Binv, r and x read once, y written once)."""
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.amg.solve import SolveOptions
    from repro_torch.kernels.smoother import ref as sref
    from repro_torch.kernels.smoother.bf16_order import block_diag_apply_emulate
    from repro_torch.kernels.spmv.ref import block_x
    from repro_torch.kernels.spmv.spmv import DTYPE_CODES

    bs, omega = SolveOptions().block_size, SolveOptions().omega
    A = laplace_3d(size)
    rng = np.random.default_rng(0)
    rows = []
    for dtype in dtypes:
        dt = getattr(torch, dtype)
        bf16 = dt == torch.bfloat16
        dh = AMGSolver(AMGConfig(backend="torch", n_pods=2, lanes=4, dtype=dtype,
                                 tol=cs.BF16_TOL if bf16 else 1e-8,
                                 device="cuda")).setup(A).dist_hierarchy
        for l, dl in enumerate(dh.levels):
            if dl.coarse_inv is not None:
                continue
            binv = dh._factor(l, "bj", bs).binv
            D, nb = binv.shape[:2]
            m = dl.A.rows_local
            for k in (1, cs.K_RHS):
                shape = (D, m) + ((k,) if k > 1 else ())
                r, x = (torch.as_tensor(rng.standard_normal(shape), dtype=dt,
                                        device="cuda") for _ in range(2))
                want = sref.block_diag_apply_ref(binv, r, x, omega)
                emu = block_diag_apply_emulate(binv, r, x, omega) if bf16 else None
                bar = cs.bf16_bar(sref.block_diag_apply_absum(binv, r, x, omega)) \
                    if bf16 else None
                scale = float(want.abs().max()) or 1.0
                rb = block_x(r, bs)
                row = {"case": f"L{l} bs{bs}", "dtype": dtype, "k": k,
                       "shape": [D, m], "bound_ms": (D * nb * bs * bs + 3 * D * m * k)
                       * dt.itemsize / cs.HBM_BYTES_PER_S * 1e3,
                       "library_ms": cs.time_ms(lambda: torch.matmul(binv, rb))[0]}
                y = torch.empty_like(x)
                stream = torch.cuda.current_stream().cuda_stream

                def call(fn):
                    rc = fn(binv.data_ptr(), r.data_ptr(), x.data_ptr(), y.data_ptr(),
                            D, m, nb, bs, k, omega, DTYPE_CODES[dt], stream)
                    assert rc == 0, rc

                def error(fn):
                    y.fill_(float("nan"))
                    call(fn)
                    torch.cuda.synchronize()
                    if bf16:
                        return bar(y, want)
                    return float((y - want).abs().max()) / scale

                hold(cs, fns, order, row, call, error, 1.0 if bf16 else cs.RTOL[dt])
                if bf16:
                    for v in fns:
                        call(fns[v])
                        torch.cuda.synchronize()
                        row[f"{v}_bit_equal_emulation"] = bool(torch.equal(
                            y.view(torch.int16), emu.view(torch.int16)))
                print(f"block_diag_apply L{l} {dtype} [{D}, {m}] bs {bs} k {k}: bound "
                      f"{row['bound_ms']:.4f} ms, torch.matmul {row['library_ms']:.4f}; "
                      + ", ".join(f"{v} {row[f'{v}_ms']:.4f}"
                                  + (f" (= emulation: {row[f'{v}_bit_equal_emulation']})"
                                     if bf16 else "")
                                  for v in dict.fromkeys(order)), flush=True)
                rows.append(row)
        del dh
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--kernel", choices=("ell_spmv", "ell_spmm", "flash_attention",
                                         "flash_attention_tf32",
                                         "flash_attention_wgmma", "tri_solve",
                                         "block_diag_apply"),
                    default="ell_spmv")
    ap.add_argument("sources", nargs="*", metavar="SRC",
                    help="other sources of the kernel to hold it against")
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtype", action="append", dest="dtypes", default=None,
                    choices=("float64", "float32", "bfloat16"),
                    help="ell_spmv / ell_spmm / block_diag_apply: only this "
                         "type's pass (repeatable); tri_solve: bfloat16 runs "
                         "the bfloat16 pass")
    ap.add_argument("--operand", action="append", dest="operands", default=None,
                    metavar="NAME", help='ell_spmv / ell_spmm: only this operand, '
                    'e.g. "L0 A_on" (repeatable)')
    ap.add_argument("--chain", type=int, default=None, metavar="M",
                    help="tri_solve: also a chain of M rows (8 ranks, then 1); "
                         "--size 0 for the chains alone")
    ap.add_argument("--level", type=int, action="append", dest="levels",
                    default=None, metavar="L",
                    help="tri_solve: only level L (repeatable)")
    ap.add_argument("--cube", type=int, action="append", dest="cubes",
                    default=[], metavar="N",
                    help="tri_solve: also the route rule's sweep at the 27-point "
                         "stencil on an N^3 box a rank (repeatable)")
    ap.add_argument("--wide", action="append", dest="wides", default=[],
                    metavar="W[:K]",
                    help="tri_solve: also a triangle of 32,768 rows a rank in "
                         "level sets of W rows, K slots a row (13 if not "
                         "given), k = 1 (repeatable)")
    ap.add_argument("--head-dim", type=int, action="append", dest="head_dims",
                    default=None, metavar="D",
                    help="flash_attention(_tf32): only the cases at head dim D "
                         "(repeatable)")
    ap.add_argument("--unchecked", action="append", default=[], metavar="NAME",
                    help="a version (file stem) to time whose error is reported "
                         "but not held to the bar: a variant that trades accuracy "
                         "to show what a part of the kernel costs")
    args = ap.parse_args()
    UNCHECKED.update(args.unchecked)
    if not torch.cuda.is_available():
        print("tune_kernel: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.build import source_path

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    others = {Path(b).stem: Path(b) for b in args.sources}
    variants = {**others, "kernel": source_path(args.kernel)}
    order = [*others, "kernel", "kernel", *reversed(others)]
    fns = build_variants(args.kernel, variants, ROOT / "build" / f"tune_{args.kernel}")
    sums = {}
    if args.kernel == "flash_attention":
        rows = (flash_cases(cs, fns, order, args.head_dims, dtypes=(torch.float32,))
                + flash_large_scores(fns, args.head_dims))
    elif args.kernel == "flash_attention_tf32":
        head_dims = args.head_dims or [96, 256]
        rows = (flash_cases(cs, fns, order, head_dims, dtypes=(torch.float32,))
                + flash_large_scores(fns, head_dims))
    elif args.kernel == "flash_attention_wgmma":
        rows = flash_cases(cs, fns, order, args.head_dims, dtypes=(torch.bfloat16,))
    elif args.kernel == "tri_solve":
        wides = [tuple(int(v) for v in (w + ":13").split(":")[:2])
                 for w in args.wides]
        rows = tri_cases(cs, fns, order, args.size, args.chain, args.levels,
                         args.cubes, bf16="bfloat16" in (args.dtypes or ()),
                         wides=wides)
    elif args.kernel == "block_diag_apply":
        rows = bda_cases(cs, fns, order, args.size,
                         args.dtypes or ("float64", "float32", "bfloat16"))
    else:
        rows, sums = ell_cases(cs, fns, order, args.kernel, args.size,
                               args.dtypes or ("float64", "float32", "bfloat16"),
                               args.operands)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "rows": rows,
                                              "launch_ms_per_solve": sums}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
