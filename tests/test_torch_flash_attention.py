"""The port's flash attention on the CPU: its time-major ``attention`` and the
``[B, H, S, D]`` wrapper (both run the plain version for CPU tensors) against
the reference's Pallas kernel in interpret mode, float32 at 2e-5 (the bar of
``tests/test_kernels.py``); plus the wrapper's contract: bad operands raise,
Sq > Skv raises, and a CUDA operand never reaches the plain version."""
import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

TOL = 2e-5

# (B, Hq, Hkv, Sq, Skv, D, window): GQA 4/2, MQA, window, Sq < Skv (decode
# alignment), S not a multiple of the 32-row blocks, head dims 16 and 32
CASES = [
    (2, 4, 2, 64, 64, 32, None),
    (1, 4, 1, 50, 50, 16, None),
    (1, 4, 2, 77, 77, 32, 16),
    (2, 2, 2, 40, 40, 16, 48),
    (1, 4, 2, 8, 96, 32, None),
    (1, 4, 4, 19, 83, 16, 24),
    (2, 6, 3, 33, 33, 16, None),
]


def _inputs(case, seed, time_major):
    B, Hq, Hkv, Sq, Skv, D, _ = case
    rng = np.random.default_rng(seed)
    if time_major:
        shapes = [(B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)]
    else:
        shapes = [(B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _ids(case):
    B, Hq, Hkv, Sq, Skv, D, w = case
    return f"B{B}-H{Hq}/{Hkv}-S{Sq}/{Skv}-D{D}-w{w}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_time_major_attention_matches_pallas(case):
    """``ops.attention`` (what the models call) against the reference's
    ``attention(use_kernel=True)`` running the Pallas kernel in interpret
    mode with 32-row blocks, so several query/key blocks and the block-skip
    logic are exercised."""
    window = case[-1]
    q, k, v = _inputs(case, 0, time_major=True)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=window, use_kernel=True,
                          block_q=32, block_k=32, interpret=True)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    plain = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=window,
                          use_kernel=False)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_matches_pallas_and_reference_oracle(case, causal):
    window = case[-1]
    q, k, v = _inputs(case, 1, time_major=False)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, causal=causal, window=window,
                             block_q=32, block_k=32, interpret=True))
    oracle = np.asarray(jref(jq, jk, jv, causal=causal, window=window))
    before = fa.flash_attention.launches
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal, window=window)
    assert fa.flash_attention.launches == before       # CPU: no launch
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=TOL, atol=TOL)


def test_plain_version_keeps_bfloat16():
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(CASES[0], 2, time_major=False))
    out = ref.attention_ref(q, k, v)
    assert out.dtype == torch.bfloat16
    want = ref.attention_ref(q.float(), k.float(), v.float())
    assert float((out.float() - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_err_rows_scales_each_row_by_its_own_max(dtype):
    """The kernels' error measure: on a causal output whose first row is
    far larger than the late ones, an error of 10% of a late row is 0.1 of
    that row, where a scale over the whole output would call it 1e-3; a
    row of zeros must match exactly."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs((1, 2, 1, 300, 300, 64, None), 3, time_major=False))
    want = ref.attention_ref(q, k, v)
    assert ref.rel_err_rows(want, want) == 0.0
    got = want.clone()
    row = want[0, 0, -1].float()
    got[0, 0, -1, 5] = (row[5] + 0.1 * row.abs().max()).to(dtype)
    whole = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert whole < 1e-2
    assert ref.rel_err_rows(got, want) == pytest.approx(0.1, rel=0.05)
    want[0, 1, 0] = 0
    got = want.clone()
    assert ref.rel_err_rows(got, want) == 0.0
    got[0, 1, 0, 3] = 1e-30
    assert ref.rel_err_rows(got, want) == float("inf")


def test_more_queries_than_keys_raises():
    """Sq > Skv: queries are right-aligned at Skv, so the first Sq - Skv rows
    see no key.  On those rows the Pallas kernel (l == 0 → 0) and
    attention_ref (a uniform average over every key) give different
    answers, so the wrapper raises rather than pick one."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 16, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 16, 16)).astype(np.float32)
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, block_q=8, block_k=8,
                               interpret=True))
    oracle = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True))
    blind = slice(0, 8)                         # rows with no visible key
    assert not np.allclose(pallas[:, :, blind], oracle[:, :, blind], atol=1e-3)
    np.testing.assert_allclose(pallas[:, :, 8:], oracle[:, :, 8:], rtol=TOL,
                               atol=TOL)
    with pytest.raises(ValueError, match="Sq = 24 > Skv = 16"):
        fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v))
    with pytest.raises(ValueError, match="Sq"):
        ops.attention(torch.from_numpy(q).transpose(1, 2),
                      torch.from_numpy(k).transpose(1, 2),
                      torch.from_numpy(v).transpose(1, 2))


def test_wrapper_rejects_bad_operands():
    q = torch.zeros((1, 4, 8, 64))
    k = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention(q, torch.zeros((1, 3, 8, 64)), torch.zeros((1, 3, 8, 64)))
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention(q, k, torch.zeros((1, 2, 9, 64)))
    with pytest.raises(TypeError, match="differ"):
        fa.flash_attention(q, k.double(), k.double())
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


def _as_cuda(monkeypatch):
    """Make ``check_operands`` see CUDA tensors: device type, alignment and
    stream are faked; every other check runs as written."""
    real = fa.check_operands

    class FakeDevice:
        type = "cuda"

    class View:
        def __init__(self, t):
            self.t = t

        def __getattr__(self, name):
            return getattr(self.t, name)

        @property
        def device(self):
            return FakeDevice

    monkeypatch.setattr(fa, "check_operands",
                        lambda q, k, v, w: real(View(q), View(k), View(v), w))


def test_cuda_operands_never_take_the_plain_version(monkeypatch):
    """No card here, so inspect the wrapper: its plain version is reached
    only through ``check_operands`` returning False, which happens for CPU
    tensors alone; with the device answering "CUDA" the wrapper checks the
    kernel's limits, launches, counts the launch and never calls the plain
    version; a failed launch raises."""
    tree = ast.parse(inspect.getsource(fa.flash_attention))
    plain_calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                   and getattr(n.func, "id", None) == "attention_ref"]
    assert len(plain_calls) == 1
    guard = next(n for n in ast.walk(tree) if isinstance(n, ast.If)
                 and plain_calls[0] in list(ast.walk(n)))
    assert ast.unparse(guard.test).startswith("not check_operands(")
    src = inspect.getsource(fa.check_operands)
    assert src.count("return False") == 1
    assert 'if dev.type == "cpu":\n        return False' in src

    _as_cuda(monkeypatch)
    launched = []
    monkeypatch.setattr(fa, "attention_ref", lambda *a, **k: pytest.fail("plain"))
    monkeypatch.setattr(fa, "kernel", lambda name: lambda *a: launched.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    # the kernel's limits are checked for CUDA operands only
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(torch.zeros((1, 2, 4, 32)), torch.zeros((1, 2, 4, 32)),
                           torch.zeros((1, 2, 4, 32)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(*(torch.zeros((1, 2, 4, 64), dtype=torch.float64),) * 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(*(torch.zeros((1, 2, 64, 4)).transpose(2, 3),) * 3)
    before = fa.flash_attention.launches
    # time-major operands go in as strided views, no copy
    q = torch.zeros((2, 5, 4, 64)).transpose(1, 2)
    k = torch.zeros((2, 9, 2, 64)).transpose(1, 2)
    out = fa.flash_attention(q, k, k, causal=True, window=3)
    assert out.shape == q.shape and out.stride() == q.stride()
    (args,) = launched
    assert args[4:10] == (2, 4, 2, 5, 9, 64)
    assert args[10:13] == q.stride()[:3] and args[19:22] == out.stride()[:3]
    assert args[22:25] == (1, 3, 0)
    assert fa.flash_attention.launches == before + 1
    fa.flash_attention.launches = before
    monkeypatch.setattr(fa, "kernel", lambda name: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fa.flash_attention(q, k, k)
    assert fa.flash_attention.launches == before


def test_bfloat16_operands_need_strides_of_8(monkeypatch):
    """For CUDA operands the kernel copies bfloat16 rows in 16-byte pieces:
    a stride of 68 elements (a multiple of 4, which float32 takes) raises
    for bfloat16 and never reaches the plain version; strides of 8 launch
    the bfloat16 instance."""
    _as_cuda(monkeypatch)
    launched = []
    monkeypatch.setattr(fa, "attention_ref", lambda *a, **k: pytest.fail("plain"))
    monkeypatch.setattr(fa, "kernel", lambda name: lambda *a: launched.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    before = fa.flash_attention.launches
    q = torch.zeros((1, 2, 8, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.flash_attention(q, q, q)
    assert not launched
    qf = torch.zeros((1, 2, 8, 68))[..., :64]
    fa.flash_attention(qf, qf, qf)
    q = torch.zeros((1, 2, 8, 72), dtype=torch.bfloat16)[..., :64]
    fa.flash_attention(q, q, q)
    assert [a[24] for a in launched] == [0, 1]      # the bf16 flag
    assert fa.flash_attention.launches == before + 2
    fa.flash_attention.launches = before
