"""The port's local sparse kernels on the CPU: the plain PyTorch versions
(what the wrappers run for CPU tensors) against the reference's Pallas
kernels run in interpret mode, float32 at rtol 1e-5 and float64 — with x64
really enabled — at 1e-12; plus the wrappers' contract: degenerate shapes
give exact zeros, bad operands raise, and a CUDA operand never reaches the
plain version."""
import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.spmv import bcsr as jbcsr  # noqa: E402
from repro.kernels.spmv import spmv as jspmv  # noqa: E402
from repro_torch.kernels.spmv import bcsr, ops, ref, spmv  # noqa: E402

D = 3
RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _random_ell(rng, n, m, K, dtype):
    cols = rng.integers(0, m, size=(D, n, K)).astype(np.int32)
    cols[rng.random((D, n, K)) < 0.3] = -1
    cols[:, -2:] = -1                                  # all-padding rows
    vals = rng.standard_normal((D, n, K)).astype(dtype)
    vals[cols == -1] = 0.0
    return cols, vals


def _random_bcsr(rng, mb, Kb, nb, bs, dtype):
    bcols = rng.integers(0, nb, size=(D, mb, Kb)).astype(np.int32)
    bcols[rng.random((D, mb, Kb)) < 0.25] = -1
    bvals = rng.standard_normal((D, mb, Kb, bs, bs)).astype(dtype)
    bvals[bcols == -1] = 0.0
    return bcols, bvals


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= RTOL[dtype] * scale


def _pallas(fn, dtype, *args):
    """Run a reference Pallas kernel per rank in interpret mode, with x64
    enabled for float64 operands (the reference's own float64 case
    otherwise silently runs float32)."""
    with jax.enable_x64(dtype == np.float64):
        out = [np.asarray(fn(*(jnp.asarray(a[d]) for a in args),
                             interpret=True)) for d in range(D)]
    assert out[0].dtype == dtype
    return np.stack(out)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,m,K", [(37, 50, 7), (64, 40, 27), (9, 300, 40)])
def test_ell_spmv_plain_matches_pallas(n, m, K, dtype):
    rng = np.random.default_rng(n + K)
    cols, vals = _random_ell(rng, n, m, K, dtype)
    x = rng.standard_normal((D, m)).astype(dtype)
    want = _pallas(jspmv.ell_spmv, dtype, cols, vals, x)
    t = [torch.as_tensor(a) for a in (cols, vals, x)]
    _close(ref.ell_spmv_ref(*t), want, dtype)
    _close(spmv.ell_spmv(*t), want, dtype)            # CPU: the plain path
    _close(ops.spmv(*t, use_kernel=False), want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,m,K,k", [(37, 50, 7, 3), (64, 40, 27, 8)])
def test_ell_spmm_plain_matches_pallas(n, m, K, k, dtype):
    rng = np.random.default_rng(n * k + K)
    cols, vals = _random_ell(rng, n, m, K, dtype)
    X = rng.standard_normal((D, m, k)).astype(dtype)
    want = _pallas(jspmv.ell_spmm, dtype, cols, vals, X)
    t = [torch.as_tensor(a) for a in (cols, vals, X)]
    _close(ref.ell_spmm_ref(*t), want, dtype)
    _close(spmv.ell_spmm(*t), want, dtype)
    _close(ops.spmm(*t), want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", bcsr.BLOCK_SIZES)
@pytest.mark.parametrize("k", [None, 1, 4])
def test_bcsr_plain_matches_pallas(bs, k, dtype):
    rng = np.random.default_rng(bs * 10 + (k or 0))
    mb, Kb = 6, 4
    m = 5 * bs - 3                       # not a multiple of bs: padded blocks
    bcols, bvals = _random_bcsr(rng, mb, Kb, -(-m // bs), bs, dtype)
    x = rng.standard_normal((D, m) + (() if k is None else (k,))).astype(dtype)
    if k is None:
        want = _pallas(jbcsr.bcsr_spmv, dtype, bcols, bvals, x)
        got = bcsr.bcsr_spmv(*(torch.as_tensor(a) for a in (bcols, bvals, x)))
    else:
        want = _pallas(jbcsr.bcsr_spmm, dtype, bcols, bvals, x)
        got = bcsr.bcsr_spmm(*(torch.as_tensor(a) for a in (bcols, bvals, x)))
    assert got.shape == (D, mb * bs) + (() if k is None else (k,))
    _close(got, want, dtype)
    t = [torch.as_tensor(a) for a in (bcols, bvals, x)]
    _close(ref.bcsr_apply_ref(*t), want, dtype)
    _close(ops.bcsr(*t), want, dtype)                  # CPU: the plain path
    _close(ops.bcsr(*t, use_kernel=False), want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", bcsr.BLOCK_SIZES)
@pytest.mark.parametrize("k", [None, 1, 3])
@pytest.mark.parametrize("cut", [0, 1, 5])
def test_bcsr_rows_match_pallas_sliced(bs, k, cut, dtype):
    """``rows=`` keeps the first rows of the product: the plain path (what
    the wrappers run for CPU tensors, and what ``DistOperator`` asks for
    with its true row count) against the Pallas kernel's result sliced to
    the same rows."""
    rng = np.random.default_rng(bs * 100 + (k or 0) * 10 + cut)
    mb, Kb = 7, 3
    m = mb * bs - 4                          # a partial last block, as on the path
    rows = mb * bs - cut
    bcols, bvals = _random_bcsr(rng, mb, Kb, -(-m // bs), bs, dtype)
    x = rng.standard_normal((D, m) + (() if k is None else (k,))).astype(dtype)
    fn = jbcsr.bcsr_spmv if k is None else jbcsr.bcsr_spmm
    want = _pallas(fn, dtype, bcols, bvals, x)[:, :rows]
    t = [torch.as_tensor(a) for a in (bcols, bvals, x)]
    wrapper = bcsr.bcsr_spmv if k is None else bcsr.bcsr_spmm
    for got in (ref.bcsr_apply_ref(*t, rows), wrapper(*t, rows=rows),
                ops.bcsr(*t, rows=rows), ops.bcsr(*t, rows=rows, use_kernel=False)):
        assert got.shape == (D, rows) + (() if k is None else (k,))
        assert got.is_contiguous()
        _close(got, want, dtype)
    with pytest.raises(ValueError, match="rows"):
        wrapper(*t, rows=mb * bs + 1)


@pytest.mark.parametrize("case", ["n0", "K0", "m0", "k0"])
def test_degenerate_shapes_give_exact_zeros(case):
    n, K, m, k = {"n0": (0, 3, 5, 2), "K0": (4, 0, 5, 2),
                  "m0": (4, 3, 0, 2), "k0": (4, 3, 5, 0)}[case]
    cols = torch.full((D, n, K), -1, dtype=torch.int32)
    vals = torch.zeros((D, n, K), dtype=torch.float64)
    if case != "k0":
        y = spmv.ell_spmv(cols, vals, torch.ones((D, m), dtype=torch.float64))
        assert y.shape == (D, n) and not y.any()
    Y = spmv.ell_spmm(cols, vals, torch.ones((D, m, k), dtype=torch.float64))
    assert Y.shape == (D, n, k) and not Y.any()
    bcols = torch.full((D, n, K), -1, dtype=torch.int32)
    bvals = torch.zeros((D, n, K, 8, 8), dtype=torch.float64)
    Yb = bcsr.bcsr_spmm(bcols, bvals, torch.ones((D, m, k), dtype=torch.float64))
    assert Yb.shape == (D, n * 8, k) and not Yb.any()


def test_wrappers_reject_bad_operands():
    cols = torch.zeros((D, 4, 3), dtype=torch.int32)
    vals = torch.zeros((D, 4, 3), dtype=torch.float64)
    x = torch.zeros((D, 5), dtype=torch.float64)
    with pytest.raises(TypeError):
        spmv.ell_spmv(cols.long(), vals, x)           # column ids not int32
    with pytest.raises(TypeError):
        spmv.ell_spmv(cols, vals, x.float())          # mixed dtypes
    with pytest.raises(TypeError):
        spmv.ell_spmv(cols, vals.half(), x.half())    # not float32/float64
    with pytest.raises(ValueError):
        spmv.ell_spmv(cols, vals[:, :2], x)           # shapes disagree
    with pytest.raises(ValueError):
        spmv.ell_spmm(cols, vals, x)                  # spmm needs [D, m, k]
    with pytest.raises(ValueError):
        spmv.ell_spmv(cols.to("meta"), vals.to("meta"), x.to("meta"))


WRAPPERS = [(spmv, "ell_spmv", "ell_spmv_ref"), (spmv, "ell_spmm", "ell_spmm_ref"),
            (bcsr, "bcsr_spmm", "bcsr_apply_ref")]


@pytest.mark.parametrize("module,name,plain", WRAPPERS)
def test_cuda_operands_never_take_the_plain_version(module, name, plain,
                                                    monkeypatch):
    """No card here, so inspect the wrapper: its plain version is reached
    only through ``check_operands`` returning False, which happens for CPU
    tensors alone; and with the device check answering "CUDA" the wrapper
    launches its kernel, counts the launch and never calls the plain one."""
    tree = ast.parse(inspect.getsource(getattr(module, name)))
    plain_calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                   and getattr(n.func, "id", None) == plain]
    assert len(plain_calls) == 1
    guard = next(n for n in ast.walk(tree) if isinstance(n, ast.If)
                 and plain_calls[0] in list(ast.walk(n)))
    assert ast.unparse(guard.test).startswith("not check_operands(")
    src = inspect.getsource(spmv.check_operands)
    assert src.count("return False") == 1
    assert 'if dev.type == "cpu":\n        return False' in src

    launched = []
    monkeypatch.setattr(module, "check_operands", lambda *a: True)
    monkeypatch.setattr(module, plain, lambda *a: pytest.fail("plain path"))
    monkeypatch.setattr(module, "kernel",
                        lambda k: lambda *a: launched.append(k) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    wrapper = getattr(module, name)
    before = wrapper.launches
    if name == "bcsr_spmm":
        args = (torch.zeros((D, 2, 2), dtype=torch.int32),
                torch.zeros((D, 2, 2, 8, 8)), torch.zeros((D, 16, 1)))
    else:
        x = torch.zeros((D, 5)) if name == "ell_spmv" else torch.zeros((D, 5, 2))
        args = (torch.zeros((D, 4, 3), dtype=torch.int32),
                torch.zeros((D, 4, 3)), x)
    wrapper(*args)
    assert launched == [name] and wrapper.launches == before + 1
    wrapper.launches = before

    # a failed launch raises instead of falling back
    monkeypatch.setattr(module, "kernel", lambda k: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wrapper(*args)
    assert wrapper.launches == before


def test_launch_counters_reset():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"ell_spmv": 0, "ell_spmm": 0, "bcsr_spmm": 0}
