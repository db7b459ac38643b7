"""The port's local sparse kernels in bfloat16 on the CPU: the plain PyTorch
versions (what the wrappers run for CPU tensors, and what the card's
kernels are held against) against the reference's Pallas kernels run in
interpret mode on the same bfloat16 operands, as ``tests/test_kernels.py``
runs them, and against float64 of the same operands.

The reference's kernels round along the row in bfloat16; the port widens
to float32, sums in float32 and rounds once.  So they cannot be bit-equal,
and each entry is held to two bars (Σ|a·x| is the entry's sum of absolute
products, in float64):

* against the reference: |y_port − y_ref| ≤ 2^-6 · Σ|a·x| (the worst seen
  is 2^-7);
* against float64 of the same bfloat16 operands: ≤ 2^-8 · |y| + 2^-16 ·
  Σ|a·x| (one rounding of a float32 sum).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.spmv import bcsr as jbcsr  # noqa: E402
from repro.kernels.spmv import spmv as jspmv  # noqa: E402
from repro_torch.kernels.spmv import bcsr, bf16_order, ops, ref, spmv  # noqa: E402

D = 2
REF_BAR = 2.0**-6          # of Σ|a·x|, against the reference's kernel
F64_REL, F64_ABS = 2.0**-8, 2.0**-16   # of |y| and Σ|a·x|, against float64
# the reference suite's bfloat16 shapes (tests/test_kernels.py), (n, m, K)
SHAPES = [(8, 16, 3), (100, 64, 7), (257, 300, 27), (1024, 512, 9)]


def _bf16(a):
    """float32 numpy holding ``a`` rounded to bfloat16 (the values both
    sides are given)."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _ell(rng, n, m, K):
    cols = rng.integers(0, m, size=(D, n, K)).astype(np.int32)
    cols[rng.random((D, n, K)) < 0.3] = -1
    cols[:, -1:] = -1                                  # an all-padding row
    vals = _bf16(rng.standard_normal((D, n, K)))
    vals[cols == -1] = 0.0
    return cols, vals


def _pallas(fn, *args):
    """The reference kernel per rank, in interpret mode on bfloat16
    operands (int32 ids as they are), as float32."""
    out = []
    for d in range(D):
        a = [jnp.asarray(x[d]) if x.dtype == np.int32
             else jnp.asarray(x[d]).astype(jnp.bfloat16) for x in args]
        y = fn(*a, interpret=True)
        assert y.dtype == jnp.bfloat16
        out.append(np.asarray(y.astype(jnp.float32)))
    return np.stack(out)


def _torch(*arrays):
    """int32 ids as they are, values as bfloat16 tensors."""
    return [torch.as_tensor(a) if a.dtype == np.int32
            else torch.as_tensor(a).to(torch.bfloat16) for a in arrays]


def _check(got, want_ref, exact, absum):
    """Both bars; ``exact`` is float64 of the same bfloat16 operands."""
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    assert got.shape == want_ref.shape == exact.shape
    assert (np.abs(got - want_ref) <= REF_BAR * absum).all(), \
        float((np.abs(got - want_ref) / np.maximum(absum, 1e-300)).max())
    bar = F64_REL * np.abs(exact) + F64_ABS * absum
    assert (np.abs(got - exact) <= bar).all()


def _f64(fn, idx, vals, x, *args):
    """``fn`` (a plain version) in float64 on the operands and on their
    absolute values: the exact-ish result and Σ|a·x|."""
    i = torch.as_tensor(idx)
    v, xx = torch.as_tensor(vals, dtype=torch.float64), torch.as_tensor(
        x, dtype=torch.float64)
    return (fn(i, v, xx, *args).numpy(),
            fn(i, v.abs(), xx.abs(), *args).numpy())


@pytest.mark.parametrize("n,m,K", SHAPES)
def test_ell_spmv_bf16_plain_matches_pallas(n, m, K):
    rng = np.random.default_rng(n + K)
    cols, vals = _ell(rng, n, m, K)
    x = _bf16(rng.standard_normal((D, m)))
    want = _pallas(jspmv.ell_spmv, cols, vals, x)
    exact, absum = _f64(ref.ell_spmv_ref, cols, vals, x)
    t = _torch(cols, vals, x)
    for got in (ref.ell_spmv_ref(*t), spmv.ell_spmv(*t),
                ops.spmv(*t, use_kernel=False)):
        _check(got, want, exact, absum)


@pytest.mark.parametrize("n,m,K", [(100, 64, 7), (257, 300, 27)])
@pytest.mark.parametrize("k", [1, 8])
def test_ell_spmm_bf16_plain_matches_pallas(n, m, K, k):
    rng = np.random.default_rng(n * k + K)
    cols, vals = _ell(rng, n, m, K)
    X = _bf16(rng.standard_normal((D, m, k)))
    want = _pallas(jspmv.ell_spmm, cols, vals, X)
    exact, absum = _f64(ref.ell_spmm_ref, cols, vals, X)
    t = _torch(cols, vals, X)
    for got in (ref.ell_spmm_ref(*t), spmv.ell_spmm(*t), ops.spmm(*t)):
        _check(got, want, exact, absum)


@pytest.mark.parametrize("bs", bcsr.BLOCK_SIZES)
@pytest.mark.parametrize("k", [None, 1, 8])
def test_bcsr_bf16_plain_matches_pallas(bs, k):
    """Both block sizes, one RHS and k = 1 and 8, a source that is not a
    multiple of bs."""
    rng = np.random.default_rng(bs * 10 + (k or 0))
    mb, Kb = 6, 4
    m = 5 * bs - 3
    bcols = rng.integers(0, -(-m // bs), size=(D, mb, Kb)).astype(np.int32)
    bcols[rng.random((D, mb, Kb)) < 0.25] = -1
    bvals = _bf16(rng.standard_normal((D, mb, Kb, bs, bs)))
    bvals[bcols == -1] = 0.0
    x = _bf16(rng.standard_normal((D, m) + (() if k is None else (k,))))
    fn = jbcsr.bcsr_spmv if k is None else jbcsr.bcsr_spmm
    want = _pallas(fn, bcols, bvals, x)
    exact, absum = _f64(ref.bcsr_apply_ref, bcols, bvals, x)
    t = _torch(bcols, bvals, x)
    wrapper = bcsr.bcsr_spmv if k is None else bcsr.bcsr_spmm
    for got in (ref.bcsr_apply_ref(*t), wrapper(*t), ops.bcsr(*t)):
        _check(got, want, exact, absum)
    cut = mb * bs - 5                  # the true rows, as DistOperator asks
    got = wrapper(*t, rows=cut)
    assert got.shape[1] == cut and got.is_contiguous()
    _check(got, want[:, :cut], exact[:, :cut], absum[:, :cut])


def test_bf16_rounds_once_from_float32_sums():
    """The plain bfloat16 rule is a float32 sum of exact products rounded
    once: equal bit for bit to that computed by hand, where a bfloat16
    running sum would lose the small terms."""
    cols = torch.tensor([[[0, 1, 2, 3, -1]]], dtype=torch.int32)
    vals = torch.tensor([[[1.0, 2.0**-9, 2.0**-9, 2.0**-9, 7.0]]]).to(
        torch.bfloat16)
    x = torch.ones((1, 4), dtype=torch.bfloat16)
    y = ref.ell_spmv_ref(cols, vals, x)
    # float32: 1 + 3·2^-9 rounds to bfloat16 1 + 2^-7 (the nearest);
    # summed in bfloat16 each 2^-9 would vanish against 1
    assert y.dtype == torch.bfloat16
    assert float(y) == float(torch.tensor(1.0 + 3 * 2.0**-9).to(torch.bfloat16))
    assert float(y) == 1.0 + 2.0**-7


def test_bf16_wrappers_take_their_plain_version_on_the_cpu():
    """A bfloat16 CPU operand goes to the plain version (no launch counted);
    the dtype code the kernels read is 2; half precision is refused."""
    rng = np.random.default_rng(0)
    cols, vals = _ell(rng, 9, 11, 4)
    t = _torch(cols, vals, _bf16(rng.standard_normal((D, 11))))
    before = ops.launch_counts()
    assert torch.equal(spmv.ell_spmv(*t), ref.ell_spmv_ref(*t))
    assert ops.launch_counts() == before
    assert [spmv.DTYPE_CODES[d] for d in (torch.float32, torch.float64,
                                          torch.bfloat16)] == [0, 1, 2]
    with pytest.raises(TypeError, match="bfloat16"):
        spmv.ell_spmv(t[0], t[1].half(), t[2].half())
    y = spmv.ell_spmv(torch.full((D, 0, 3), -1, dtype=torch.int32),
                      torch.zeros((D, 0, 3), dtype=torch.bfloat16), t[2])
    assert y.shape == (D, 0) and y.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_full_precision_plain_versions_keep_their_type(dtype):
    """float32 and float64 compute in their own type: the bfloat16 rule
    widens nothing else (their bit-equality with today's results is held
    by tests/test_torch_spmv_kernels.py against Pallas)."""
    rng = np.random.default_rng(1)
    cols, vals = _ell(rng, 9, 11, 4)
    c = torch.as_tensor(cols)
    v = torch.as_tensor(vals, dtype=dtype)
    x = torch.as_tensor(rng.standard_normal((D, 11)), dtype=dtype)
    want = torch.where(c >= 0, v * x.gather(
        1, c.reshape(D, -1).clamp_min(0).long()).reshape(c.shape), 0.0).sum(2)
    assert torch.equal(ref.ell_spmv_ref(c, v, x), want)


# ---------------------------------------------------------------------------
# the bfloat16 kernels' own order of sums (kernels/spmv/bf16_order.py), the
# CPU side of the card tests that hold the kernels to it bit for bit

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
          / "spmv" / "csrc" / "ell_bf16.cuh")


def _card_bar(got, plain, absum):
    """The card's bar (chip_smoke.py:bf16_bar): one bfloat16 ulp of plain
    + 2^-16 Σ|a·x| an entry."""
    p = plain.double().numpy()
    _, e = np.frexp(p)
    ulp = np.where(p == 0, 0.0, np.ldexp(1.0, e - 8))
    err = np.abs(got.double().numpy() - p)
    assert (err <= ulp + F64_ABS * absum).all(), float(
        (err / np.maximum(ulp + F64_ABS * absum, 1e-300)).max())


def test_bf16_order_constants_are_the_kernels():
    """The emulation's constants are the ones ell_bf16.cuh declares, and
    its shape rule (which operands take the bulk design) the launches'."""
    src = HEADER.read_text()
    for name in ("CONSUMERS", "STAGE_SLOTS", "MAX_LANES", "TARGET_UNITS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(bf16_order, name), name
    assert bf16_order.STAGE_SLOTS % 8 == 0
    for name, want in (("ell_spmv.cu", {"BULK_SLOTS": bf16_order.SPMV_BULK_SLOTS}),
                       ("ell_spmm.cu", {"FLAT_K": bf16_order.SPMM_FLAT_K,
                                        "FLAT_SLOTS": bf16_order.SPMM_FLAT_SLOTS})):
        text = (HEADER.parent / name).read_text()
        for const, value in want.items():
            m = re.search(rf"constexpr int64_t {const} = ([^;]+);", text)
            got = m.group(1).replace("int64_t{1}", "1")
            assert m and eval(got) == value, (name, const, got)
    assert bf16_order.bulk("ell_spmv", 8 * 32768, 27)          # level-0 A_on
    assert not bf16_order.bulk("ell_spmv", 8 * 2689, 27)
    assert bf16_order.bulk("ell_spmm", 8 * 32768, 27)
    assert not bf16_order.bulk("ell_spmm", 8 * 32768, 9)       # level-0 A_off
    assert bf16_order.bulk("ell_spmm", 8 * 2689, 7)


@pytest.mark.parametrize("rows", [6, 21512, 262144])
@pytest.mark.parametrize("k", [1, 3, 8, 16, 17, 33])
@pytest.mark.parametrize("K", [1, 2, 8, 9, 18, 27, 33, 36, 46, 66, 3000, 20001])
def test_bf16_order_plan(K, k, rows):
    """The launch's rule keeps its promises at every row length of the
    path and the tests' long rows, at a few rows, at a level-1-sized and at
    the level-0 operand: R a multiple of 8 (units start 16-byte aligned); a
    row's V·G lanes inside one warp where G > 1; G above 1 only where a
    unit of half the lanes would not fit a stage, or where G <= K and the
    operand still has at most TARGET_UNITS units (one wave of blocks); a
    unit inside a stage unless G is at its cap; the level-0 A_on (K = 27,
    262,144 rows) one lane a row in slot order."""
    C, S = bf16_order.CONSUMERS, bf16_order.STAGE_SLOTS
    for W in {bf16_order.lane_width(k), 1}:
        p = bf16_order.plan(rows, K, k, W)
        V, G, R = p["V"], p["G"], p["R"]
        assert R >= 8 and R % 8 == 0 and R * V * G <= C
        assert p["KT"] == V * W and V <= bf16_order.MAX_LANES
        assert G & (G - 1) == 0
        if G > 1:
            half = C // (V * G // 2) // 8 * 8
            assert 32 % (V * G) == 0
            assert half * K > S or (G <= K and -(-rows // R) <= bf16_order.TARGET_UNITS)
        gmax = bf16_order.MAX_LANES // V if V & (V - 1) == 0 else 1
        assert R * K <= S or G == gmax
    if K == 27 and k in (1, 8) and rows == 262144:
        assert bf16_order.plan(rows, 27, k, bf16_order.lane_width(k)) == \
            {"V": 1, "G": 1, "R": 128, "KT": bf16_order.lane_width(k)}


def test_bf16_order_is_the_lane_tree():
    """A lone row of K = 4 takes G = 4 lanes: (s0 + s2) + (s1 + s3), not the
    slot-order sum, which loses a small term; the same row among 2^17 rows
    (1024 units of 128) takes one lane, in slot order.  The emulation
    follows each."""
    n, K = 1 << 17, 4
    cols = torch.full((1, n, K), -1, dtype=torch.int32)
    vals = torch.full((1, n, K), float("nan")).to(torch.bfloat16)
    cols[0, 0] = torch.arange(4, dtype=torch.int32)
    vals[0, 0] = torch.tensor([1.0, 2.0**-24, -1.0, 2.0**-24])
    x = torch.ones((1, 4), dtype=torch.bfloat16)
    assert bf16_order.plan(1, K, 1, 1)["G"] == 4
    assert bf16_order.plan(n, K, 1, 1)["G"] == 1
    assert float(bf16_order.emulate(cols[:, :1], vals[:, :1], x)) == 2.0**-23
    # one lane: 1 + 2^-24 rounds to 1, minus 1 is 0, plus 2^-24
    y = bf16_order.emulate(cols, vals, x)
    assert float(y[0, 0]) == 2.0**-24 and not y[0, 1:].any()
    one = bf16_order.emulate(cols[:, :1, :1], vals[:, :1, :1], x)
    assert one.dtype == torch.bfloat16 and float(one) == 1.0


@pytest.mark.parametrize("n,m,K", SHAPES + [(37, 50, 8), (37, 50, 18), (37, 50, 36)])
def test_bf16_order_spmv_matches_plain_and_pallas(n, m, K):
    """The kernel's order against the plain version at the card's bar and
    against the reference's kernel in interpret mode and float64 at this
    file's bars, padded values NaN (never multiplied)."""
    rng = np.random.default_rng(3 * n + K)
    cols, vals = _ell(rng, n, m, K)
    x = _bf16(rng.standard_normal((D, m)))
    want = _pallas(jspmv.ell_spmv, cols, vals, x)
    exact, absum = _f64(ref.ell_spmv_ref, cols, vals, x)
    c, v, xt = _torch(cols, vals, x)
    v = torch.where(c >= 0, v, torch.tensor(float("nan"), dtype=torch.bfloat16))
    got = bf16_order.emulate(c, v, xt)
    _check(got, want, exact, absum)
    _card_bar(got, ref.ell_spmv_ref(c, v.nan_to_num(), xt), absum)


@pytest.mark.parametrize("W", [8, 4, 1])
@pytest.mark.parametrize("K", [8, 27])
def test_bf16_order_spmm_matches_plain_and_pallas(K, W):
    """k = 8 with 8, 4 or 1 columns a lane (the widths X's alignment
    gives): G follows V, the results stay within the bars."""
    rng = np.random.default_rng(K * 10 + W)
    n, m, k = 100, 64, 8
    cols, vals = _ell(rng, n, m, K)
    X = _bf16(rng.standard_normal((D, m, k)))
    want = _pallas(jspmv.ell_spmm, cols, vals, X)
    exact, absum = _f64(ref.ell_spmm_ref, cols, vals, X)
    t = _torch(cols, vals, X)
    got = bf16_order.emulate(*t, W=W)
    _check(got, want, exact, absum)
    _card_bar(got, ref.ell_spmm_ref(*t), absum)


@pytest.mark.parametrize("k", [None, 3])
def test_bf16_order_long_rows(k):
    """Rows longer than a stage (K = 3000; one RHS: 16 lanes a row; k = 3:
    one lane a row over three columns, V = 3 being no power of two), the
    lanes' sums carried over chunks, against float64 and the plain
    version."""
    rng = np.random.default_rng(11)
    n, m, K = 3, 500, 3000
    cols, vals = _ell(rng, n, m, K)
    x = _bf16(rng.standard_normal((D, m) + (() if k is None else (k,))))
    plain = ref.ell_spmv_ref if k is None else ref.ell_spmm_ref
    exact, absum = _f64(plain, cols, vals, x)
    t = _torch(cols, vals, x)
    got = bf16_order.emulate(*t)
    assert bf16_order.plan(D * n, K, k or 1, 1)["G"] == (16 if k is None else 1)
    bar = F64_REL * np.abs(exact) + F64_ABS * absum
    assert (np.abs(got.double().numpy() - exact) <= bar).all()
    _card_bar(got, plain(*t), absum)
