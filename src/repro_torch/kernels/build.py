"""Build and load the hand-written CUDA kernels of :mod:`repro_torch.kernels`.

Every kernel family registers its sources in the one :data:`KERNELS` table.
Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, which is loaded with :mod:`ctypes`.
Builds happen at first use (or through :func:`build`), into
``build/repro_torch/`` at the root of the checkout; a library's file name
carries a hash of its source, the headers it may include (``*.cuh`` beside
it and in the shared ``csrc/`` of this package, which is on the include
path) and the flags, so an edited source or header is rebuilt and an
unchanged one is reused; the compiler's output (``ptxas -v``: registers,
stack and spills of every kernel instance) is kept beside it.  Several
sources build concurrently, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# kernel name -> (source relative to this package, C entry point, argtypes)
KERNELS = {
    # cols, vals, x, y; D, n, K, m (ell_spmm: and k); dtype code, stream
    "ell_spmv": ("spmv/csrc/ell_spmv.cu", "ell_spmv_launch",
                 [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _INT, _P]),
    "ell_spmm": ("spmv/csrc/ell_spmm.cu", "ell_spmm_launch",
                 [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _INT, _P]),
    # bcols, bvals, x, y; D, mb, Kb, m, bs, k, rows; dtype code, stream
    "bcsr_spmm": ("spmv/csrc/bcsr_spmm.cu", "bcsr_spmm_launch",
                  [_P, _P, _P, _P] + [_I64] * 7 + [_INT, _P]),
    # binv, r, x, y; D, m, nb, bs, k; w, dtype code, stream
    "block_diag_apply": ("smoother/csrc/block_diag_apply.cu",
                         "block_diag_apply_launch",
                         [_P, _P, _P, _P] + [_I64] * 5
                         + [ctypes.c_double, _INT, _P]),
    # cols, vals, diag, r, x, order, starts, z, y; D, m, K, k, levels; w,
    # dtype code, block, stream
    "tri_solve": ("smoother/csrc/tri_solve.cu", "tri_solve_launch",
                  [_P] * 9 + [_I64] * 5 + [ctypes.c_double, _INT, _INT, _P]),
    # q, k, v, o; B, Hq, Hkv, Sq, Skv, D; (b, h, s) strides of q, k, v, o;
    # causal, window (-1: none), bf16, stream
    "flash_attention": ("flash_attention/csrc/flash_attention.cu",
                        "flash_attention_launch",
                        [_P, _P, _P, _P] + [_I64] * 6 + [_I64] * 12
                        + [_INT, _I64, _INT, _P]),
    # the bfloat16 Hopper design (wgmma fed by TMA, warp-specialised), with
    # flash_attention's C signature (float32 operands are refused)
    "flash_attention_wgmma": ("flash_attention/csrc/flash_attention_wgmma.cu",
                              "flash_attention_launch",
                              [_P, _P, _P, _P] + [_I64] * 6 + [_I64] * 12
                              + [_INT, _I64, _INT, _P]),
    # the roofline's measured ceilings: x, y; n, t; a, c, f64, stream
    "ert_stream": ("ert/csrc/ert.cu", "ert_stream_launch",
                   [_P, _P, _I64, _INT, ctypes.c_double, ctypes.c_double,
                    _INT, _P]),
    # x, idx, y; n, f64, stream
    "ert_gather": ("ert/csrc/ert.cu", "ert_gather_launch",
                   [_P, _P, _P, _I64, _INT, _P]),
}

_LOADED: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def source_path(name: str) -> Path:
    return KERNELS_DIR / KERNELS[name][0]


def shared_headers() -> Path:
    """The headers every kernel family may include (``value_types.cuh``:
    the value-type rule of the bfloat16 instances), on nvcc's include
    path."""
    return KERNELS_DIR / "csrc"


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library goes: its file name hashes the source,
    the headers it may include (``*.cuh`` beside it and in
    :func:`shared_headers`) and the flags."""
    src = source_path(name)
    headers = b"".join(h.read_bytes() for d in (src.parent, shared_headers())
                       for h in sorted(d.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    every ``nvcc`` started at once; returns seconds per compiled kernel.
    Raises with the compiler's output when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(shared_headers()), "-o", str(tmp),
               str(source_path(n))]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, errors = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {KERNELS[n][0]} "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def ptxas_report(log: str) -> list[tuple[str, str]]:
    """(kernel instance, its "Used N registers, ..." line and its stack and
    spill line) for every entry function in an ``nvcc -Xptxas -v`` log;
    names demangled, without their parameter lists, where the toolkit's
    ``cu++filt`` is found."""
    rows, name, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, frame = line.split("'")[1], ""
        elif "stack frame" in line and name:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            rows.append((name, f"{line.split(':', 1)[1].strip()}; {frame}"))
            name = None
    try:
        filt = Path(nvcc_path()).with_name("cu++filt")
    except RuntimeError:                  # no toolkit here: names stay mangled
        filt = None
    if rows and filt is not None and filt.exists():
        out = subprocess.run([str(filt)], input="\n".join(n for n, _ in rows),
                             capture_output=True, text=True, check=True).stdout
        rows = [(d[:d.find(">(") + 1] or d, r) for d, (_, r) in zip(out.splitlines(), rows)]
    return rows


def build_report(name: str) -> list[tuple[str, str]]:
    """:func:`ptxas_report` of kernel ``name``'s last build."""
    return ptxas_report(library_path(name).with_suffix(".log").read_text())


def kernel(name: str):
    """The C entry point of kernel ``name`` (built on first use), with its
    argument types declared."""
    _, symbol, argtypes = KERNELS[name]
    return entry(name, symbol, argtypes)


def entry(name: str, symbol: str, argtypes: list):
    """Another C function ``symbol`` of kernel ``name``'s library (built on
    first use), returning an int, with its argument types declared."""
    fn = _LOADED.get((name, symbol))
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[(name, symbol)] = fn
    return fn
