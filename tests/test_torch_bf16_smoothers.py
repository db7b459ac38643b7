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
"""
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
