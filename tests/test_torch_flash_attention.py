"""The port's flash attention on the CPU: its time-major ``attention`` and the
``[B, H, S, D]`` wrapper (both run the plain version for CPU tensors) against
the reference's Pallas kernel in interpret mode, float32 at 2e-5 (the bar of
``tests/test_kernels.py``); plus the wrapper's contract: bad operands raise,
Sq > Skv raises, and a CUDA operand never reaches the plain version; and
the float32 kernel's 3xTF32 arithmetic (its TF32 split, fragment orders
and rounding points) emulated in torch, held to the Pallas kernel and,
with large scores, to a float64 truth."""
import ast
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref, tf32_order  # noqa: E402

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


# ---------------------------------------------------------------------------
# The float32 kernel's arithmetic: 3xTF32 on mma.sync m16n8k8, emulated.
# The kernel runs only on the card; its split, fragment orders and the order
# of its roundings are written out here in torch and held against the
# Pallas kernel, and against a float64 truth where the scores are large.
# ---------------------------------------------------------------------------

KERNEL_SRC = (Path(fa.__file__).parent / "csrc" / "flash_attention.cu").read_text()
# the float32 instance's key tile, as the kernel source sets it
BK = int(re.search(r"struct Cfg<float, D> \{\s*static constexpr int WARPS = \d+, "
                   r"MT = \d+, BK = (\d+)", KERNEL_SRC).group(1))
# the head dims with a shape of their own (Cfg<float, D>; none since the
# float32 head dims 96 and 256 went to flash_attention_tf32.cu)
BK_OF = {int(D): int(bk) for D, bk in re.findall(
    r"struct Cfg<float, (\d+)> \{\s*static constexpr int WARPS = \d+, MT = \d+, "
    r"BK = (\d+)", KERNEL_SRC)}
LOG2E = np.float32(1.4426950408889634)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero, on the int32 view (add half a TF32
    ulp to the magnitude bits, clear the 13 low bits); inf and NaN (the
    all-ones exponent) pass through."""
    bits = x.contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, bits, (bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


# m16n8k8 fragment layouts (PTX ISA, .tf32): register r / e of lane (g, t)
def a_pos(g, t, r):
    return g + 8 * (r & 1), t + 4 * (r >> 1)          # A (row, col)


def b_pos(g, t, r):
    return t + 4 * r, g                               # B (k, n)


def c_pos(g, t, e):
    return g + 8 * (e >> 1), 2 * t + (e & 1)          # C (row, col)


LANES = [(g, t) for g in range(8) for t in range(4)]
P_FROM_C = (0, 2, 1, 3)     # P's A fragment from the score registers


def score_orders():
    """Per k-step h of a 16-dim chunk, the dim each A column and each B row
    stands for, as the kernel loads them: the lane's float4 of a Q row at
    dims 4t.. gives A registers {x[2h], x[2h] (row g + 8), x[2h + 1],
    x[2h + 1] (row g + 8)}, its float4 of K row g the B registers
    {y[2h], y[2h + 1]}."""
    a_dim, b_dim = {}, {}
    for g, t in LANES:
        for h in range(2):
            for r in range(4):
                a_dim[h, a_pos(g, t, r)[1]] = 4 * t + 2 * h + (r >> 1)
            for r in range(2):
                b_dim[h, b_pos(g, t, r)[0]] = 4 * t + 2 * h + r
    return ([[a_dim[h, c] for c in range(8)] for h in range(2)],
            [[b_dim[h, k] for k in range(8)] for h in range(2)])


def pv_orders():
    """Within an 8-key step, the key each A column (from the score
    registers, a = {c0, c2, c1, c3}) and each B row (V rows 2t + r) stands
    for; and for a 32-dim group, the dim of B column n of n-tile jj (V's
    float4 at 32p + 4g) and of the output the store writes for it (float4
    at 32p + 8t + 4h from C columns 2t + h)."""
    a_key, b_key, v_dim, o_dim = {}, {}, {}, {}
    for g, t in LANES:
        for r in range(4):
            row, col = a_pos(g, t, r)
            crow, key = c_pos(g, t, P_FROM_C[r])
            assert crow == row
            a_key[col] = key
        for r in range(2):
            b_key[b_pos(g, t, r)[0]] = 2 * t + r
        for jj in range(4):
            v_dim[jj, g] = 4 * g + jj
            for h in range(2):
                o_dim[jj, c_pos(g, t, h)[1]] = 8 * t + 4 * h + jj
    return ([a_key[c] for c in range(8)], [b_key[k] for k in range(8)],
            [[v_dim[jj, n] for n in range(8)] for jj in range(4)],
            [[o_dim[jj, n] for n in range(8)] for jj in range(4)])


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _fast_two_sum(s, err, x):
    """The kernel's Fast2Sum in float32: s + x as s + err."""
    t = s + x
    return t, err + (x - (t - s))


def emulate(q, k, v, causal, window, passes=3, bk=BK):
    """The float32 kernel's arithmetic on [B, H, S, D] numpy operands: key
    tiles of ``bk``; S = Q K^T per 16-dim chunk (two k-steps of the
    fragment orders above, three TF32 products each, or one with
    ``passes=1``) summed exactly, as in the tensor cores, rounded to
    float32, added in pairs and the pairs to the scores by Fast2Sum with
    the rounding errors kept aside; the mask, the online softmax in log2
    units with the scale in the exp's FMA; each tile's P V through the
    permuted contraction, summed exactly, rounded, then o = o * alpha + PV
    in one rounding; o / l at the end."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    B, H, Sq, D = q.shape
    Skv, group = k.shape[2], H // k.shape[1]
    n_kt = -(-Skv // bk)
    pad = n_kt * bk - Skv
    k, v = (torch.nn.functional.pad(a.repeat_interleave(group, 1), (0, 0, 0, pad))
            for a in (k, v))
    scale_log2 = np.float32(np.float32(1.0 / np.sqrt(D)) * LOG2E)
    a_dim, b_dim = score_orders()
    a_key, b_key, v_dim, o_dim = pv_orders()
    # the V columns n-tile jj's B column n reads, and where its output goes
    groups = D // 32 if D % 32 == 0 else 0
    v_cols = [32 * p + v_dim[jj][n] for p in range(groups) for jj in range(4) for n in range(8)]
    o_cols = [32 * p + o_dim[jj][n] for p in range(groups) for jj in range(4) for n in range(8)]
    if not groups:                       # head dims below the kernel's 32-dim groups
        v_cols = o_cols = list(range(D))

    def parts(x):
        hi, lo = split(x)
        return (hi.double(), lo.double()) if passes == 3 else (hi.double(), None)

    def product(a, b):                    # sum of the TF32 products, exact
        (ah, al), (bh, bl) = parts(a), parts(b)
        out = ah @ bh
        return out if al is None else out + al @ bh + ah @ bl

    qpos = torch.arange(Sq)[:, None] + (Skv - Sq)
    m = torch.full((B, H, Sq), -1e30, dtype=torch.float32)
    l = torch.zeros((B, H, Sq), dtype=torch.float32)
    acc = torch.zeros((B, H, Sq, len(v_cols)), dtype=torch.float32)
    for kt in range(n_kt):
        ks, vs = k[:, :, kt * bk:(kt + 1) * bk], v[:, :, kt * bk:(kt + 1) * bk]
        s = torch.zeros((B, H, Sq, bk), dtype=torch.float32)
        err = even = torch.zeros_like(s)
        for c in range(D // 16):
            part = 0.0
            for h in range(2):
                qa = q[..., [16 * c + d for d in a_dim[h]]]
                kb = ks[..., [16 * c + d for d in b_dim[h]]]
                part = part + product(qa, kb.transpose(-1, -2))
            if c % 2 == 0:
                even = part.float()
            else:
                s, err = _fast_two_sum(s, err, even + part.float())
        if D // 16 % 2:      # head dims below the kernel's: a last chunk alone
            s, err = _fast_two_sum(s, err, even)
        s = s + err
        kpos = kt * bk + torch.arange(bk)[None, :]
        ok = kpos < Skv
        if causal:
            ok = ok & (qpos >= kpos)
        if window is not None:
            ok = ok & (qpos - kpos < window)
        x = torch.where(ok, s, -torch.inf)
        m_new = torch.maximum(m, x.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(_fma(x, torch.tensor(scale_log2), -m_new[..., None]))
        l = _fma(l, alpha, p.sum(-1))
        m = m_new
        pv = 0.0
        for kk in range(bk // 8):
            pa = p[..., [8 * kk + key for key in a_key]]
            vb = vs[:, :, [8 * kk + key for key in b_key]][..., v_cols]
            pv = pv + product(pa, vb)
        acc = _fma(acc, alpha[..., None], pv.float())
    out = torch.empty((B, H, Sq, D), dtype=torch.float32)
    out[..., o_cols] = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated ``cvt.rna.tf32.f32``: ties (low 13 bits 0x1000) go away
    from zero in both signs, below a tie down, above it up, with the carry
    into the exponent; ±0, ±inf and NaN pass through, and a value at the top
    of the exponent range keeps its exponent."""
    def f(bits):
        return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))

    def bits(x):
        return x.numpy().view(np.uint32).tolist()

    base = 0x3F800000                                  # 1.0
    x = f([base | 0x1000, base | 0x0FFF, base | 0x1001, 0x3FFFF000,
           0x80000000 | base | 0x1000, 0x80000000 | base | 0x0FFF])
    assert bits(tf32(x)) == [base + 0x2000, base, base + 0x2000, 0x40000000,
                             0x80000000 | (base + 0x2000), 0x80000000 | base]
    special = f([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001])
    got = bits(tf32(special))
    assert got[:4] == [0x00000000, 0x80000000, 0x7F800000, 0xFF800000]
    assert torch.isnan(tf32(special)[4])
    huge = torch.tensor([3.0e38, -3.0e38, 1.0e-38, 1.0e-45], dtype=torch.float32)
    r = tf32(huge)
    assert torch.isfinite(r).all()
    assert ((r.view(torch.int32) >> 23) & 0xFF).tolist() == \
        ((huge.view(torch.int32) >> 23) & 0xFF).tolist()
    assert (r.view(torch.int32) & 0x1FFF == 0).all()


def test_split_rebuilds_x():
    """hi + lo rebuilds x to 2^-21 of |x| over a wide range of exponents
    (in fact 2^-22); both parts are TF32 values, and lo is within half a
    TF32 ulp of x."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-30, 30, 100_000)).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    assert (lo.double().abs() <= 2.0 ** -11 * x.double().abs()).all()


def test_fragment_orders_pair_a_with_b():
    """The kernel's fragment orders: in each k-step of S the dim an A
    column stands for is the dim of the matching B row, and the two k-steps
    of a 16-dim chunk cover its 16 dims once; in P V, the key of A column c
    (taken from the score registers) is the key of B row c, and the
    8 keys are covered once; V's column for B column n of n-tile jj is the
    dim the store writes that output column to, and a 32-dim group's
    four n-tiles cover its 32 dims once."""
    a_dim, b_dim = score_orders()
    assert a_dim == b_dim
    assert sorted(a_dim[0] + a_dim[1]) == list(range(16))
    a_key, b_key, v_dim, o_dim = pv_orders()
    assert a_key == b_key and sorted(a_key) == list(range(8))
    assert v_dim == o_dim
    assert sorted(d for row in v_dim for d in row) == list(range(32))


def test_a_fragment_from_score_registers_multiplies_like_p_v():
    """One m16n8k8 step done register by register: the score registers of a
    16 x 8 tile of P laid out as C, turned into A by {c0, c2, c1, c3}, and
    B gathered from V rows 2t + r, multiplied as the instruction reads its
    fragments, give P V exactly; the unpermuted {c0, c1, c2, c3} does not."""
    rng = np.random.default_rng(6)
    P = rng.standard_normal((16, 8))
    V = rng.standard_normal((8, 8))

    def mma(order):
        A, Bm = np.zeros((16, 8)), np.zeros((8, 8))
        for g, t in LANES:
            c = [P[c_pos(g, t, e)] for e in range(4)]
            for r in range(4):
                A[a_pos(g, t, r)] = c[order[r]]
            for r in range(2):
                Bm[b_pos(g, t, r)] = V[2 * t + r, g]
        return A @ Bm

    np.testing.assert_allclose(mma(P_FROM_C), P @ V, rtol=1e-14, atol=1e-14)
    assert not np.allclose(mma((0, 1, 2, 3)), P @ V)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_emulation_matches_pallas(case, causal):
    """The float32 kernel's arithmetic against the reference's Pallas kernel
    in interpret mode (32-row blocks), each row within 2e-5 of its max."""
    window = case[-1]
    q, k, v = _inputs(case, 7, time_major=False)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  window=window, block_q=32, block_k=32, interpret=True)
    got = emulate(q, k, v, causal, window)
    err = ref.rel_err_rows(got, torch.from_numpy(np.array(want)))
    assert err <= TOL, err


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_one_pass_tf32_fails_the_bar(case):
    """The same emulation with one TF32 product (hi x hi) is further than
    2e-5 from the Pallas kernel: the bar tells 3xTF32 from plain TF32."""
    window = case[-1]
    q, k, v = _inputs(case, 7, time_major=False)
    want = torch.from_numpy(np.asarray(
        jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
               window=window, block_q=32, block_k=32, interpret=True)))
    assert ref.rel_err_rows(emulate(q, k, v, True, window, passes=1), want) > TOL
    assert ref.rel_err_rows(emulate(q, k, v, True, window), want) <= TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_f64_is_the_plain_function(case, causal):
    """The float64 truth computes the plain version's function: with
    ordinary scores the two agree to the float32 bar, windows and decode
    alignment included."""
    tq, tk, tv = (torch.from_numpy(a) for a in _inputs(case, 9, time_major=False))
    truth = ref.attention_f64(tq, tk, tv, causal=causal, window=case[-1])
    assert truth.dtype == torch.float64
    assert ref.rel_err_rows(ref.attention_ref(tq, tk, tv, causal, case[-1]), truth) <= TOL


def _routed_emulation(D):
    """The float32 design that serves head dim D, as an emulation: the
    mma.sync kernel's above, or the Hopper design's
    (``tf32_order.emulate`` with its source's key tile and chains)."""
    if D not in fa.TF32_HEAD_DIMS:
        return lambda q, k, v, passes=3: emulate(q, k, v, True, None, passes=passes,
                                                 bk=BK_OF.get(D, BK))
    src = (Path(fa.__file__).parent / "csrc" / "flash_attention_tf32.cu").read_text()
    body = re.search(rf"struct Cfg<{D}> \{{(.*?)\}};", src, re.S).group(1)
    bk, chains = (int(re.search(rf"{n} = (\d+)", body).group(1)) for n in ("BK", "CHAINS"))
    return lambda q, k, v, passes=3: tf32_order.emulate(q, k, v, True, None, bk=bk,
                                                        chains=chains, passes=passes)


@pytest.mark.parametrize("D", [64, 96, 128, 256])
@pytest.mark.parametrize("kind", ["peaked", "offset"])
def test_3xtf32_emulation_holds_large_scores(kind, D):
    """At the kernels' head dims, each through the design the route table
    sends it to (``mma.sync`` at 64 and 128, the ``wgmma`` design of
    ``flash_attention_tf32.cu`` at 96 and 256), with q scaled by 8 (one key
    dominates a row's softmax) or k + 50 (scores in the hundreds, where the
    low parts carry the differences between keys): the emulation is within
    2e-5 of the float64 truth and no further from it than the float32 plain
    version, which in the offset case is itself further than 2e-5 from the
    truth (so the card holds these cases to ``ref.attention_f64``).  One
    TF32 pass fails the bar in both."""
    q, k, v = _inputs((1, 4, 2, 256, 256, D, None), 8, time_major=False)
    if kind == "peaked":
        q = q * np.float32(8)
    else:
        k = k + np.float32(50)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    truth = ref.attention_f64(tq, tk, tv)
    plain = ref.rel_err_rows(ref.attention_ref(tq, tk, tv), truth)
    run = _routed_emulation(D)
    got = ref.rel_err_rows(run(q, k, v), truth)
    assert got <= TOL and got <= plain, (got, plain)
    if kind == "offset":
        assert plain > TOL
    assert ref.rel_err_rows(run(q, k, v, passes=1), truth) > TOL
