"""The block smoothers' bfloat16 plain versions on the CPU, the rule their
CUDA instances follow: operands widened to float32, products and sums in
float32, ``tri_solve``'s solution ``z = T⁻¹ r`` kept in float32 from one
level set to the next, and ``y = x + w·…`` rounded to bfloat16 once.

* Each plain version at small sizes, on random factors and random r and x
  from a numpy seed, lies within one bfloat16 rounding of the float64
  truth on the same (bfloat16) inputs: ``|y − y₆₄| ≤ 2⁻⁸|y₆₄| +
  2⁻¹⁸ Σ|·|``, the second term the float32 round-off of the sums over the
  magnitudes each entry adds up (``ref.*_absum``).
* A solve whose z were rounded to bfloat16 at every level set fails that
  bar on a chain, where each row carries its predecessor's rounding.
* float32 and float64 compute in their own type, as before.
* A factor's float64 host values reach bfloat16 through float32, placed
  and refreshed alike (the rounding the reference's ``astype`` makes).
* The CUDA instances' orders of sums (``smoother/bf16_order.py``): its
  ``fmaf`` rounds once; the staged ``tri_solve`` route's one lane a row
  sums as the L2 route's 32-lane butterfly does, bit for bit; the whole
  emulated solve and ``block_diag_apply`` lie within one rounding.
* The staged route's slab: the level-ordered gather of the factor for any
  valid order, rewritten in place by a refresh, held only by the factors
  the rule sends to that route.
* The bfloat16 ``block_diag_apply`` vector path's guard keeps every offset
  of its 32-bit indices below 2^31.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.smoother import ref as sref  # noqa: E402
from repro_torch.kernels.smoother import smoother as sm  # noqa: E402
from repro_torch.kernels.smoother.ops import BlockFactor, TriFactor  # noqa: E402

BF16 = torch.bfloat16
U = 2.0**-8           # bfloat16's unit round-off: one rounding's bound
SLACK = 2.0**-18      # float32 round-off of the sums, over Σ|·| (2^6 of its u)
D = 3


def _one_rounding(got, truth, absum):
    """The largest ratio of |got − truth| to the bar; ≤ 1 passes."""
    assert got.dtype == BF16 and got.shape == truth.shape
    err = (got.double() - truth).abs()
    return float((err / (U * truth.abs() + SLACK * absum)).max())


def _bf16(rng, shape, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale).to(BF16)


def _triangle(rng, m, K, upper):
    """Random strict triangles in ELL (-1 padding), values ≈ 0.5 / K and a
    diagonal in [1, 2), as float64 numpy: a stable solve."""
    cols = np.full((D, m, K), -1, dtype=np.int32)
    for d in range(D):
        for i in range(m):
            cand = np.arange(i + 1, m) if upper else np.arange(i)
            n = min(len(cand), int(rng.integers(0, K + 1)))
            c = np.sort(rng.choice(cand, size=n, replace=False))
            cols[d, i, :c.size] = c
    vals = np.where(cols >= 0, rng.standard_normal(cols.shape) * 0.5 / K, 0.0)
    return cols, vals, 1.0 + rng.random((D, m))


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("bs,m", [(1, 13), (3, 13), (4, 64), (8, 101)])
def test_block_diag_apply_bf16_is_one_rounding_of_the_truth(bs, m, k):
    rng = np.random.default_rng(bs * m)
    nb = -(-m // bs)
    shape = (D, m) + (() if k is None else (k,))
    binv, r, x = _bf16(rng, (D, nb, bs, bs)), _bf16(rng, shape), _bf16(rng, shape)
    got = sref.block_diag_apply_ref(binv, r, x, 0.7)
    truth = sref.block_diag_apply_ref(binv.double(), r.double(), x.double(), 0.7)
    assert _one_rounding(got, truth,
                         sref.block_diag_apply_absum(binv, r, x, 0.7)) <= 1
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(sm.block_diag_apply(binv, r, x, 0.7), got)
    assert torch.equal(BlockFactor(binv).apply(r, x, 0.7), got)


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
@pytest.mark.parametrize("m,K", [(1, 0), (40, 5), (200, 13)])
def test_tri_solve_bf16_is_one_rounding_of_the_truth(m, K, upper, k):
    rng = np.random.default_rng(m + K)
    cols, vals, diag = _triangle(rng, m, K, upper)
    shape = (D, m) + (() if k is None else (k,))
    r, x = _bf16(rng, shape), _bf16(rng, shape)
    f = TriFactor.place({"cols": cols, "vals": vals, "diag": diag,
                         "upper": upper}, "cpu", BF16)
    sched = f.schedule()
    got = sref.tri_solve_ref(f.cols, f.vals, f.diag, r, x, 0.9, sched)
    truth = sref.tri_solve_ref(f.cols, f.vals.double(), f.diag.double(),
                               r.double(), x.double(), 0.9, sched)
    absum = sref.tri_solve_absum(f.cols, f.vals, f.diag, r, x, 0.9, sched)
    assert _one_rounding(got, truth, absum) <= 1
    assert torch.equal(sm.tri_solve(f.cols, f.vals, f.diag, r, x, 0.9,
                                    upper=upper), got)
    assert torch.equal(f.apply(r, x, 0.9), got)


def _tri_solve_bf16_z(cols, vals, diag, r, x, w, schedule):
    """``tri_solve_ref`` with z stored in bfloat16 after every level set:
    what the plain version would compute if z took the operands' type."""
    Dn, m, K = cols.shape
    R = r.reshape(Dn * m, -1).float()
    z = torch.zeros_like(R)
    keep = (cols >= 0).reshape(Dn * m, K)
    offs = (torch.arange(Dn) * m).reshape(Dn, 1, 1)
    fc = torch.where(cols >= 0, cols.long() + offs, 0).reshape(Dn * m, K)
    fv, dg = vals.reshape(Dn * m, K).float(), diag.reshape(Dn * m, 1).float()
    for rows in schedule:
        s = torch.where(keep[rows][..., None], fv[rows][..., None] * z[fc[rows]],
                        0.0).sum(dim=1)
        z[rows] = ((R[rows] - s) / dg[rows]).to(BF16).float()
    return (x.float() + w * z.reshape(r.shape)).to(BF16)


def test_tri_solve_bf16_does_not_round_between_level_sets():
    """A 512-row chain, each row adding 0.9 of the one before: the plain
    version (z in float32) stays within one rounding of the truth, and a z
    rounded to bfloat16 at each of the 512 level sets does not (each row
    inherits the roundings of the rows before it)."""
    m = 512
    cols = np.arange(-1, m - 1, dtype=np.int32).reshape(1, m, 1).repeat(D, 0)
    f = TriFactor.place({"cols": cols, "vals": np.where(cols >= 0, -0.9, 0.0),
                         "diag": np.ones((D, m)), "upper": False}, "cpu", BF16)
    sched = f.schedule()
    assert len(sched) == m
    rng = np.random.default_rng(2)
    r = torch.as_tensor(0.5 + rng.random((D, m))).to(BF16)
    x = torch.zeros(D, m, dtype=BF16)
    truth = sref.tri_solve_ref(f.cols, f.vals.double(), f.diag.double(),
                               r.double(), x.double(), 1.0, sched)
    absum = sref.tri_solve_absum(f.cols, f.vals, f.diag, r, x, 1.0, sched)
    kept = sref.tri_solve_ref(f.cols, f.vals, f.diag, r, x, 1.0, sched)
    rounded = _tri_solve_bf16_z(f.cols, f.vals, f.diag, r, x, 1.0, sched)
    assert _one_rounding(kept, truth, absum) <= 1
    assert _one_rounding(rounded, truth, absum) > 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_float_types_compute_in_their_own_type(dtype):
    """float32 and float64 plain versions take no widening and no final
    conversion: each equals the same arithmetic written in its type."""
    rng = np.random.default_rng(4)
    m, bs = 50, 4
    binv = torch.as_tensor(rng.standard_normal((D, 13, bs, bs)), dtype=dtype)
    r, x = (torch.as_tensor(rng.standard_normal((D, m)), dtype=dtype)
            for _ in range(2))
    rb = torch.nn.functional.pad(r[..., None], (0, 0, 0, 2)).reshape(D, 13, 1, bs, 1)
    z = (binv[..., None] * rb).sum(dim=3).reshape(D, 52, 1)[:, :m, 0]
    got = sref.block_diag_apply_ref(binv, r, x, 0.7)
    assert got.dtype == dtype and torch.equal(got, x + 0.7 * z)
    cols, vals, diag = _triangle(rng, m, 5, False)
    c, v, dg = torch.as_tensor(cols), torch.as_tensor(vals, dtype=dtype), \
        torch.as_tensor(diag, dtype=dtype)
    sched = sref.level_schedule(cols, False)
    zz = torch.zeros(D * m, 1, dtype=dtype)
    fc = torch.where(c >= 0, c.long() + (torch.arange(D) * m).reshape(D, 1, 1),
                     0).reshape(D * m, -1)
    for rows in sched:
        s = torch.where((c >= 0).reshape(D * m, -1)[rows][..., None],
                        v.reshape(D * m, -1)[rows][..., None] * zz[fc[rows]],
                        0.0).sum(dim=1)
        zz[rows] = (r.reshape(D * m, 1)[rows] - s) / dg.reshape(D * m, 1)[rows]
    got = sref.tri_solve_ref(c, v, dg, r, x, 0.7, sched)
    assert got.dtype == dtype and torch.equal(got, x + 0.7 * zz.reshape(D, m))


def test_factor_values_reach_bf16_through_float32(monkeypatch):
    """Placed and refreshed alike, a bfloat16 hierarchy's factors take their
    float64 host values through float32 (float64 → float32 → bfloat16, the
    value planes' ``DTYPES`` staging): 1 + 2⁻⁸ + 2⁻³⁰ rounds to 1, where one
    rounding from float64 would give 1 + 2⁻⁷.  The refresh writes into the
    placed tensors; a float64 hierarchy's factors hold the host values."""
    from repro_torch.amg import dist_solve
    from repro_torch.amg.hierarchy import setup
    from repro_torch.amg.problems import laplace_3d

    tie = 1.0 + 2.0**-8 + 2.0**-30
    real = dist_solve._host_factor

    def tied(*args, **kw):
        host = real(*args, **kw)
        if "binv" in host:
            host["binv"][0, 0, 0, 0] = tie
        else:
            host["vals"][0, 1, 0], host["diag"][1, 2] = -tie, tie
        return host

    monkeypatch.setattr(dist_solve, "_host_factor", tied)
    h = setup(laplace_3d(6), max_coarse=30)
    dh = dist_solve.DistHierarchy.build(h, 2, 4, dtype=BF16, device="cpu")
    keys = [("bj", 4), ("gs", 0)]
    placed = [dh._factor(0, *key) for key in keys]
    for fresh in (False, True):
        if fresh:
            ptrs = [t.data_ptr() for f in placed for t in f.tensors()]
            dh.refresh_values(h.levels)
            assert [t.data_ptr() for f in placed for t in f.tensors()] == ptrs
        for key, f in zip(keys, placed):
            host = dh.levels[0].smoother_factor(*key)
            for name in f.VALUES:
                assert host[name].dtype == np.float64
                got = getattr(f, name)
                assert torch.equal(got, torch.as_tensor(
                    host[name].astype(np.float32)).to(BF16))
        assert float(placed[0].binv[0, 0, 0, 0]) == 1.0
        assert float(placed[1].vals[0, 1, 0]) == -1.0
        assert float(placed[1].diag[1, 2]) == 1.0
        assert placed[1].cols.dtype == torch.int32
    dh64 = dist_solve.DistHierarchy.build(h, 2, 4, dtype=torch.float64,
                                          device="cpu")
    f64 = dh64._factor(0, "bj", 4)
    assert torch.equal(f64.binv, torch.as_tensor(
        dh64.levels[0].smoother_factor("bj", 4)["binv"]))


def test_wrappers_refuse_other_types():
    """float16 (no instance) and operands of mixed types are refused before
    any launch, naming the three types the kernels take."""
    r = torch.zeros(D, 8, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        sm.block_diag_apply(torch.zeros(D, 2, 4, 4, dtype=torch.float16),
                            r, r.clone())
    rb = torch.zeros(D, 8, dtype=BF16)
    with pytest.raises(TypeError, match="binv"):
        sm.block_diag_apply(torch.zeros(D, 2, 4, 4), rb, rb.clone())


# ------------------------------------------------ the bfloat16 kernels' orders
from fractions import Fraction  # noqa: E402

from repro_torch.kernels.smoother import bf16_order as bo  # noqa: E402


def test_fma32_rounds_once():
    """``bf16_order.fma32`` is ``fmaf``: a·b + c rounded once to float32.
    The product of two float32 values is exact in float64; the sum is
    rounded to float64 with round-to-odd and then to float32, which at 53
    bits against 24 is the one correct rounding (no double rounding).  Held
    here against the exact sum in rationals, at addends across 60 binades."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(600).astype(np.float32)
    b = rng.standard_normal(600).astype(np.float32)
    c = (rng.standard_normal(600) * np.exp2(rng.integers(-30, 30, 600))).astype(np.float32)
    got = bo.fma32(a, b, c)
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        near = np.float32(float(exact))
        cands = (near, np.nextafter(near, np.float32(np.inf)),
                 np.nextafter(near, np.float32(-np.inf)))
        # nearest, ties to the even significand
        want = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.int32)) & 1))
        assert gi == want


@pytest.mark.parametrize("K", [7, 13, 26, 33, 70])
def test_staged_sum_order_is_the_l2_butterfly(K):
    """The staged route's one lane a row (slot e into leaf e mod 32 by a
    fused multiply-add, leaves met as the butterfly's lane 0 meets them,
    the o = 16 step skipped at K <= 16) equals, bit for bit, the L2 route's
    32 lanes emulated lane by lane (lane g's slots g, g + 32, ..., then
    ``acc += shfl_xor(acc, o)``), on random bfloat16 values and float32 z
    with padding slots; K > 32 puts several slots on a leaf.  Each
    multiply-add rounds once (``fma32``, above): a bfloat16 value times a
    float32 z is not exact in float32."""
    rng = np.random.default_rng(K)
    n = 400
    v = torch.as_tensor(rng.standard_normal((n, K))).to(BF16)
    zg = torch.as_tensor(rng.standard_normal((n, K)).astype(np.float32)
                         * np.exp2(rng.integers(-8, 8, (n, K))).astype(np.float32))
    keep = rng.random((n, K)) < 0.8
    keep[0] = False                                   # a row of padding only
    staged = bo.staged_sums(v, zg, keep)
    butterfly = bo.butterfly_sums(v, zg, keep)
    assert staged.dtype == butterfly.dtype == np.float32
    assert np.array_equal(staged.view(np.int32), butterfly.view(np.int32))
    # the order matters: a plain float32 sum in slot order differs
    plain = np.zeros(n, dtype=np.float32)
    for e in range(K):
        plain = np.where(keep[:, e], bo.fma32(v[:, e].float(), zg[:, e], plain), plain)
    assert K < 26 or not np.array_equal(plain, staged)


@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
@pytest.mark.parametrize("m,K", [(60, 7), (150, 13), (90, 40)])
def test_tri_solve_bf16_emulation_is_one_rounding(m, K, upper):
    """The whole bfloat16 solve in the staged order and in the butterfly
    order gives the same bits, within one rounding of the float64 truth as
    the plain version is."""
    rng = np.random.default_rng(m * K)
    cols, vals, diag = _triangle(rng, m, K, upper)
    f = TriFactor.place({"cols": cols, "vals": vals, "diag": diag,
                         "upper": upper}, "cpu", BF16)
    r, x = _bf16(rng, (D, m)), _bf16(rng, (D, m))
    sched = f.schedule()
    staged = bo.tri_solve_emulate(f.cols, f.vals, f.diag, r, x, 0.9, sched)
    butterfly = bo.tri_solve_emulate(f.cols, f.vals, f.diag, r, x, 0.9, sched,
                                     order="butterfly")
    assert torch.equal(staged.view(torch.int16), butterfly.view(torch.int16))
    truth = sref.tri_solve_ref(f.cols, f.vals.double(), f.diag.double(),
                               r.double(), x.double(), 0.9, sched)
    absum = sref.tri_solve_absum(f.cols, f.vals, f.diag, r, x, 0.9, sched)
    assert _one_rounding(staged, truth, absum) <= 1


@pytest.mark.parametrize("k", [None, 8])
@pytest.mark.parametrize("bs,m", [(4, 64), (4, 1001), (3, 13), (8, 101)])
def test_block_diag_apply_bf16_emulation_within_the_bar(bs, m, k):
    """The kernel's order (c = 0 .. bs − 1 in turn, then fma(w, sum, x),
    rounded once) lies within the card's bfloat16 bar of the plain version
    (one ulp of plain + 2^-16 Σ|·|, ``chip_smoke.py:bf16_bar``), and within
    one rounding of the float64 truth."""
    rng = np.random.default_rng(bs * m + 7)
    nb = -(-m // bs)
    shape = (D, m) + (() if k is None else (k,))
    binv, r, x = _bf16(rng, (D, nb, bs, bs)), _bf16(rng, shape), _bf16(rng, shape)
    got = bo.block_diag_apply_emulate(binv, r, x, 0.7)
    plain = sref.block_diag_apply_ref(binv, r, x, 0.7)
    absum = sref.block_diag_apply_absum(binv, r, x, 0.7)
    assert got.dtype == BF16 and got.shape == plain.shape
    m_, e = torch.frexp(plain.double())
    ulp = torch.where(plain == 0, 0.0, torch.ldexp(torch.ones_like(m_), e - 8))
    assert bool(((got.double() - plain.double()).abs()
                 <= ulp + 2.0**-16 * absum).all())
    truth = sref.block_diag_apply_ref(binv.double(), r.double(), x.double(), 0.7)
    assert _one_rounding(got, truth, absum) <= 1


# ------------------------------------------------ the staged route's slab
def _unpack(slab, K):
    """A slab's stages back as (row index, diag, cols, vals), each by
    position: ``[D, nst·R]`` and ``[D, nst·R, KP]`` (padding slots column
    m, value 0)."""
    Dn, nst, nbytes = slab.shape
    R, KP = sm.STAGED_ROWS, sm.staged_slots(K)
    assert nbytes == sm.staged_stage_bytes(K) == 4 * R * (1 + KP)
    halves = slab.contiguous().view(torch.int16).reshape(Dn, nst, 1 + KP, R, 2)
    lo = halves[..., 0].to(torch.int32) & 0xffff            # [D, nst, 1 + KP, R]
    hi = halves[..., 1].contiguous().view(BF16)

    def by_position(t):                     # [D, nst, KP, R] -> [D, nst·R, KP]
        return t.transpose(2, 3).reshape(Dn, nst * R, -1)

    return (lo[:, :, 0].reshape(Dn, nst * R), hi[:, :, 0].reshape(Dn, nst * R),
            by_position(lo[:, :, 1:]), by_position(hi[:, :, 1:]))


@pytest.mark.parametrize("m,K", [(1, 0), (130, 5), (300, 13)])
def test_slab_is_the_level_ordered_gather(m, K):
    """A bfloat16 factor's slab holds each rank's rows in its own order (row
    index and diagonal, K columns and values, the padding slots and those
    up to ``staged_slots(K)`` column m and value 0), STAGED_ROWS rows a
    stage, padded positions zero words; another valid order (each level set
    reversed) gives that order's gather, built by the wrapper's own
    ``TriSlab``, and a factor's slab serves only its own order and values.
    A factor on the CPU holds none (the plain version reads none)."""
    rng = np.random.default_rng(m + K)
    cols, vals, diag = _triangle(rng, m, K, False)
    f = TriFactor.place({"cols": cols, "vals": vals, "diag": diag,
                         "upper": False}, "cpu", BF16)
    assert f.slab is None and len(f.tensors()) == 5
    f.sync_values()                           # nothing to rewrite
    f.slab = sm.TriSlab(f.cols, f.vals, f.diag, f.order)
    order2 = f.order.clone()
    st = f.starts.numpy()
    for d in range(D):
        for lo, hi in zip(st[d, :-1], st[d, 1:]):
            order2[d, lo:hi] = order2[d, lo:hi].flip(0)
    for order, slab in ((f.order, f.slab.data),
                        (order2, sm.TriSlab(f.cols, f.vals, f.diag, order2).data)):
        nst, KP = -(-m // sm.STAGED_ROWS), sm.staged_slots(K)
        assert slab.dtype == torch.uint8
        assert tuple(slab.shape) == (D, nst, sm.staged_stage_bytes(K))
        idx, dg, c, v = _unpack(slab, K)
        o = order.long()
        assert torch.equal(idx[:, :m], order) and bool((idx[:, m:] == 0).all())
        assert torch.equal(dg[:, :m].view(torch.int16),
                           f.diag.gather(1, o).view(torch.int16))
        assert bool((c[:, m:] == 0).all()) and bool((v[:, m:] == 0).all())
        assert bool((c[:, :m, K:] == m).all()) and bool((v[:, :m, K:] == 0).all())
        if K:
            ok = o[..., None].expand(D, m, K)
            want = f.cols.gather(1, ok)
            assert torch.equal(c[:, :m, :K], torch.where(want >= 0, want, m))
            assert torch.equal(
                v[:, :m, :K].view(torch.int16),
                torch.where(want >= 0, f.vals.gather(1, ok), 0).view(torch.int16))
    assert f.slab.serves(f.cols, f.vals, f.diag, f.order)
    assert not f.slab.serves(f.cols, f.vals, f.diag, order2)
    assert f.tensors()[-1] is f.slab.data
    f.vals.mul_(2)                            # values moved without a refill
    assert not f.slab.serves(f.cols, f.vals, f.diag, f.order)
    f.sync_values()
    assert f.slab.serves(f.cols, f.vals, f.diag, f.order)
    f32 = TriFactor.place({"cols": cols, "vals": vals, "diag": diag,
                           "upper": False}, "cpu", torch.float32)
    assert f32.slab is None


def test_refresh_rewrites_the_slab_in_place(monkeypatch):
    """``BoundSolver.update`` on a bfloat16 hybrid_gs_sym session refreshes
    its triangles' values and rewrites each slab in place: the same
    ``data_ptr``, holding the level-ordered gather of the new values.  The
    factors are placed as on the card, where the rule sends their launches
    to the staged route (``ops._plans_staged``: here every factor)."""
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.kernels.smoother import ops

    monkeypatch.setattr(ops, "_plans_staged", lambda cols, starts, dtype: True)
    from repro_torch.amg.api import SessionStore
    from repro_torch.amg.csr import CSR
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.amg.solve import SolveOptions

    A = laplace_3d(8)
    cfg = AMGConfig(backend="torch", n_pods=2, lanes=4, dtype="bfloat16",
                    device="cpu", max_coarse=30, tol=1e-2,
                    opts=SolveOptions(smoother="hybrid_gs_sym"))
    bound = AMGSolver(cfg, store=SessionStore(),
                      setup_store=SessionStore()).setup(A)
    bound.pcg(np.ones(A.nrows))
    dh = bound.dist_hierarchy
    tris = [f for f in dh._factors.values() if isinstance(f, TriFactor)]
    assert tris and all(f.slab is not None for f in tris)
    ptrs = [f.slab.data.data_ptr() for f in tris]
    old = [f.slab.data.clone() for f in tris]
    drift = np.random.default_rng(1)
    data = A.data * (1.0 + 0.03 * drift.random(A.nnz))
    At = CSR(A.shape, A.indptr.copy(), A.indices.copy(), data).T
    assert bound.update(delta=0.5 * (data + At.data) - A.data) == "refresh"
    assert bound.dist_hierarchy is dh
    for f, ptr, before in zip(tris, ptrs, old):
        assert f.slab.data.data_ptr() == ptr
        assert not torch.equal(f.slab.data, before)
        assert torch.equal(f.slab.data, sm.staged_slab(f.cols, f.vals, f.diag,
                                                       f.order))
        assert f.slab.serves(f.cols, f.vals, f.diag, f.order)


def _bs4_guard():
    """The size condition of ``bs4_width`` in ``block_diag_apply.cu`` (the
    first ``if (...) return 0;``), as a Python function of D, m, bs, k."""
    cu = (Path(sm.__file__).parent / "csrc" / "block_diag_apply.cu").read_text()
    body = cu[cu.index("int bs4_width("):]
    cond = re.search(r"if \((.*?)\)\s*return 0;", body, re.S).group(1)
    expr = (" ".join(cond.split()).replace("||", " or ").replace("int64_t{1}", "1")
            .replace("BS4", "4").replace("/", "//"))
    return lambda D, m, bs, k: eval(expr, {}, dict(D=D, m=m, bs=bs, k=k))


@pytest.mark.parametrize("D,m,k", [(1, 1 << 29, 1), (8, 1 << 26, 1),
                                   (2, 1 << 28, 1), (1, 1 << 28, 8)])
def test_bs4_width_keeps_every_offset_in_32_bits(D, m, k):
    """The bfloat16 vector path indexes r, x and y (D·m·k) and Binv (its
    last block's largest offset, D·nb·16 = 4·D·m) in 32 bits: its guard
    (read from the source) refuses every size where either reaches 2^31,
    which then takes the kernel whose indices are 64-bit, and admits the
    sizes four rows short of that."""
    refuses = _bs4_guard()
    for D_, m_, k_ in ((D, m, k), (D, m - 4, k)):
        over = D_ * m_ * k_ >= 1 << 31 or 4 * D_ * m_ >= 1 << 31
        assert refuses(D_, m_, 4, k_) == over
    assert refuses(D, m, 4, k) and not refuses(D, m - 4, 4, k)
    assert refuses(1, 64, 3, 1) and refuses(1, 66, 4, 1)
