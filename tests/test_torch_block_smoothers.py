"""The block smoothers (``block_jacobi``, ``hybrid_gs``, ``hybrid_gs_sym``)
of the port's distributed solve on the CPU, against the reference's JAX
``backend="dist"`` path on a 2×4 mesh of 8 host devices, x64 on, both fed
the identical ``laplace_3d(8)`` hierarchy through :mod:`repro_torch.convert`:

* every non-coarsest level's sparse factor (block-Jacobi at block sizes 1,
  4 and 8, the forward and the backward triangle) applied to seeded random
  ``r``, k = 1 and 3, against the reference's dense
  ``DistLevel.smoother_minv(kind, bs) @ r``: ≤ 1e-12 of max|M⁻¹r| in
  float64, ≤ 1e-5 in float32;
* residual histories ≤ 1e-7 of r0 over V/W/F × the three smoothers, PCG
  and the stationary solve, k = 1 and 3; again after both sides refresh
  their lowering with the same drifted values; and for a dist-born session
  (``setup_backend="dist"``) on both sides, before and after ``update``;
* on the port alone: the factors shared across option sets (the
  counterpart of the reference suite's ``tests/test_dist_solve.py``
  ``_arrs_ex`` check), the level-scheduled plain triangular solve against
  ``np.linalg.solve`` of the dense triangle, and block-Jacobi at block size
  1 equal to Jacobi (``tests/test_cycles.py``'s host check).

The JAX side needs 8 host devices set before jax is imported, so it runs
once per module as a subprocess of this very file::

    python tests/test_torch_block_smoothers.py --jax-ref OUT.npz IN.npz
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

N_PODS, LANES = 2, 4
N = 8
MAX_COARSE = 30       # 3 levels: W/F revisit
TOL = 1e-7            # |Δ residual| / r0, the JAX suite's float64 bar
ITERS = 5
SMOOTHERS = ("block_jacobi", "hybrid_gs", "hybrid_gs_sym")
# (method, cycle, smoother, k): the whole product
CASES = [(m, c, s, k) for m in ("pcg", "solve") for c in ("V", "W", "F")
         for s in SMOOTHERS for k in (1, 3)]
# after the refresh: each smoother at both widths and both methods
REFRESH_CASES = [("pcg", "V", "block_jacobi", 1), ("solve", "W", "block_jacobi", 3),
                 ("pcg", "F", "hybrid_gs", 3), ("solve", "V", "hybrid_gs", 1),
                 ("pcg", "W", "hybrid_gs_sym", 1), ("solve", "F", "hybrid_gs_sym", 3)]
# a dist-born session on each side, before and after its update
BORN_CASES = [("pcg", "V", "block_jacobi", 1), ("solve", "W", "hybrid_gs", 3),
              ("pcg", "F", "hybrid_gs_sym", 3)]
# (kind, block size) of every factor the reference lowers densely
FACTORS = [("bj", 1), ("bj", 4), ("bj", 8), ("gs", 0), ("gsu", 0)]
FACTOR_RTOL = {"float64": 1e-12, "float32": 1e-5}


def _case_id(case):
    return "-".join(map(str, case))


def _drifted(A, csr_cls):
    """The reference suite's ``tests/test_streaming.py:_drift`` (scale 0.03,
    seed 1): A's values drifted on its frozen pattern, kept symmetric."""
    drift = np.random.default_rng(1)
    data = A.data * (1.0 + 0.03 * drift.random(A.nnz))
    At = csr_cls(A.shape, A.indptr.copy(), A.indices.copy(), data).T
    return 0.5 * (data + At.data)


def _inputs():
    """The port's setup of laplace_3d(N) (bit-identical to the
    reference's), a [n, 3] right-hand side, and the refreshed levels (the
    drift, Galerkin products re-run on the frozen P / R)."""
    from repro_torch.amg.csr import CSR
    from repro_torch.amg.hierarchy import refresh_values, setup
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.convert import hierarchy_to_arrays

    A = laplace_3d(N)
    h = setup(A, solver="rs", max_coarse=MAX_COARSE)
    rng = np.random.default_rng(11)
    B = np.stack([A.matvec(np.ones(A.nrows))]
                 + [rng.standard_normal(A.nrows) for _ in range(2)], axis=1)
    h_new = setup(A, solver="rs", max_coarse=MAX_COARSE)
    refresh_values(h_new, CSR(A.shape, A.indptr.copy(), A.indices.copy(),
                              _drifted(A, CSR)))
    return {**hierarchy_to_arrays(h), "B": B,
            **{"new_" + k: v for k, v in hierarchy_to_arrays(h_new).items()}}


def _refreshed(d):
    return {k[4:]: d[k] for k in d if k.startswith("new_")}


def _run(dh, fns, opts_cls, case, B):
    method, cycle, smoother, k = case
    b = B[:, 0] if k == 1 else B[:, :k]
    res = fns[method](dh, b, tol=0.0, maxiter=ITERS,
                      opts=opts_cls(cycle=cycle, smoother=smoother))
    if k == 1:
        return [np.asarray(res.residuals)]
    return [np.asarray(c.residuals) for c in res.columns]


def _born_side(amg, csr_mod, problems, dist_solve, cfg):
    """A dist-born session's histories: each BORN_CASES smoother through the
    session API, then ``update(delta=)`` and the cases again on the
    refreshed lowering."""
    A = problems.laplace_3d(N)
    rng = np.random.default_rng(11)
    B = np.stack([A.matvec(np.ones(A.nrows))]
                 + [rng.standard_normal(A.nrows) for _ in range(2)], axis=1)
    out = {}
    bound = None
    for i, (method, cycle, smoother, k) in enumerate(BORN_CASES):
        bound = amg.AMGSolver(cfg.replace(opts=amg.SolveOptions(
            cycle=cycle, smoother=smoother))).setup(A)
        b = B[:, 0] if k == 1 else B[:, :k]
        res = getattr(bound, method)(b, tol=0.0, maxiter=ITERS)
        cols = [res] if k == 1 else res.columns
        for j, c in enumerate(cols):
            out[f"born{i}_col{j}"] = np.asarray(c.residuals)
    out["update"] = np.array(bound.update(
        delta=_drifted(A, csr_mod.CSR) - A.data))
    fns = {"pcg": dist_solve.dist_pcg, "solve": dist_solve.dist_solve}
    for i, case in enumerate(BORN_CASES):
        for j, hist in enumerate(_run(bound.dist_hierarchy, fns,
                                      amg.SolveOptions, case, B)):
            out[f"born_refresh{i}_col{j}"] = hist
    return out


# --------------------------------------------------------------- JAX side
def _jax_reference(out_path, in_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro import amg
    from repro.amg import csr as csr_mod
    from repro.amg import dist_solve, problems
    from repro.amg.csr import CSR
    from repro.amg.hierarchy import Hierarchy, Level

    def hierarchy(d):
        levels = []
        for l in range(int(d["n_levels"])):
            ops = {}
            for op in ("A", "P", "R"):
                key = f"L{l}_{op}_"
                ops[op] = (CSR(tuple(int(s) for s in d[key + "shape"]),
                               d[key + "indptr"], d[key + "indices"],
                               d[key + "data"]) if key + "shape" in d
                           else None)
            levels.append(Level(**ops))
        return Hierarchy(solver=str(d["solver"]), levels=levels,
                         theta=float(d["theta"]))

    d = dict(np.load(in_path))
    B = d["B"]
    dh = dist_solve.DistHierarchy.build(hierarchy(d), N_PODS, LANES,
                                        strategy="auto", dtype=jnp.float64)
    out = {}
    for l, dl in enumerate(dh.levels):
        if dl.coarse_inv is None:
            for kind, bs in FACTORS:
                out[f"minv_L{l}_{kind}{bs}"] = dl.smoother_minv(kind, bs)
    fns = {"pcg": dist_solve.dist_pcg, "solve": dist_solve.dist_solve}
    for i, case in enumerate(CASES):
        for j, hist in enumerate(_run(dh, fns, amg.SolveOptions, case, B)):
            out[f"case{i}_col{j}"] = hist
    dh.refresh_values(hierarchy(_refreshed(d)).levels)
    for i, case in enumerate(REFRESH_CASES):
        for j, hist in enumerate(_run(dh, fns, amg.SolveOptions, case, B)):
            out[f"refresh{i}_col{j}"] = hist
    cfg = amg.AMGConfig(setup_backend="dist", backend="dist", n_pods=N_PODS,
                        lanes=LANES, dtype="float64", max_coarse=MAX_COARSE)
    out.update(_born_side(amg, csr_mod, problems, dist_solve, cfg))
    np.savez(out_path, **out)


# ------------------------------------------------------------- port side
torch = pytest.importorskip("torch") if __name__ != "__main__" else None


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Start the JAX side, run the port's dist-born side meanwhile, and
    return (inputs, reference outputs, the port's dist-born outputs)."""
    from repro_torch import amg
    from repro_torch.amg import csr as csr_mod
    from repro_torch.amg import dist_solve, problems

    tmp = tmp_path_factory.mktemp("jax_ref")
    inputs = _inputs()
    in_path, out_path = tmp / "in.npz", tmp / "out.npz"
    np.savez(in_path, **inputs)
    env = dict(os.environ)
    root = pathlib.Path(__file__).parents[1]
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, __file__, "--jax-ref", str(out_path), str(in_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        # a fresh session store, as the reference's subprocess has: sessions
        # on the same matrix share their levels, so another test file's
        # update in this process would be seen here (ROADMAP queue 3)
        amg.api.clear_sessions()
        cfg = amg.AMGConfig(backend="torch", setup_backend="dist",
                            n_pods=N_PODS, lanes=LANES, dtype="float64",
                            device="cpu", max_coarse=MAX_COARSE)
        born = _born_side(amg, csr_mod, problems, dist_solve, cfg)
    finally:
        stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    return inputs, dict(np.load(out_path)), born


@pytest.fixture(scope="module")
def dh(shared):
    from repro_torch.amg.dist_solve import DistHierarchy
    from repro_torch.convert import hierarchy_from_arrays

    return DistHierarchy.build(hierarchy_from_arrays(shared[0]), N_PODS,
                               LANES, strategy="auto", dtype=torch.float64,
                               device="cpu")


def _fns():
    from repro_torch.amg.dist_solve import dist_pcg, dist_solve
    return {"pcg": dist_pcg, "solve": dist_solve}


def _close(got, want, r0):
    assert got.shape == want.shape == (ITERS + 1,)
    diff = np.abs(got - want).max() / r0
    assert diff <= TOL, diff
    assert got[-1] < got[0]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kind,bs", FACTORS,
                         ids=[f"{k}{b}" for k, b in FACTORS])
def test_factor_application_matches_dense_minv(shared, dh, kind, bs, k,
                                               dtype):
    """Each non-coarsest level's sparse factor, placed in ``dtype`` and
    applied through the kernel wrapper (its plain version on the CPU),
    against the reference's dense ``smoother_minv(kind, bs) @ r``."""
    from repro_torch.kernels.smoother.ops import place_factor

    ref = shared[1]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    levels = [l for l, dl in enumerate(dh.levels) if dl.coarse_inv is None]
    assert len(levels) == 2
    for l in levels:
        minv = ref[f"minv_L{l}_{kind}{bs}"]              # [D, m, m]
        D, m, _ = minv.shape
        r = rng.standard_normal((D, m, k))
        want = minv @ r
        f = place_factor(dh.levels[l].smoother_factor(kind, bs), "cpu", dt)
        rt = torch.as_tensor(r if k > 1 else r[..., 0], dtype=dt)
        got = f.apply(rt, torch.zeros_like(rt), 1.0).double().numpy()
        got = got if k > 1 else got[..., None]
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= FACTOR_RTOL[dtype], (l, err)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_residual_histories_match_jax_dist(shared, dh, i):
    from repro_torch.amg.solve import SolveOptions

    ref = shared[1]
    hists = _run(dh, _fns(), SolveOptions, CASES[i], shared[0]["B"])
    assert len(hists) == CASES[i][3]
    for j, hist in enumerate(hists):
        want = ref[f"case{i}_col{j}"]
        _close(hist, want, want[0])


def test_refreshed_histories_match_jax_dist(shared):
    """The refresh beneath the cached block-smoother programs: their
    factors recomputed and copied into the tensors in place, the programs
    kept, and the histories against the reference's refreshed solve."""
    from repro_torch.amg.dist_solve import DistHierarchy
    from repro_torch.amg.solve import SolveOptions
    from repro_torch.convert import hierarchy_from_arrays

    inputs, ref, _ = shared
    dh = DistHierarchy.build(hierarchy_from_arrays(inputs), N_PODS, LANES,
                             strategy="auto", dtype=torch.float64,
                             device="cpu")
    for case in REFRESH_CASES:                  # programs and factors placed
        _run(dh, _fns(), SolveOptions, case, inputs["B"])
    n_programs = len(dh.programs)
    factors = {key: [t.data_ptr() for t in f.tensors()]
               for key, f in dh._factors.items()}
    def values(f):
        return getattr(f, f.VALUES[0])

    old = [values(f).clone() for f in dh._factors.values()]
    dh.refresh_values(hierarchy_from_arrays(_refreshed(inputs)).levels)
    assert len(dh.programs) == n_programs       # no Chebyshev program here
    assert {key: [t.data_ptr() for t in f.tensors()]
            for key, f in dh._factors.items()} == factors
    assert all(not torch.equal(o, values(f))
               for o, f in zip(old, dh._factors.values()))
    for i, case in enumerate(REFRESH_CASES):
        for j, hist in enumerate(_run(dh, _fns(), SolveOptions, case,
                                      inputs["B"])):
            want = ref[f"refresh{i}_col{j}"]
            _close(hist, want, want[0])


@pytest.mark.parametrize("phase", ["born", "born_refresh"])
def test_dist_born_histories_match_jax(shared, phase):
    """A dist-born session on each side (each its own partitioned setup),
    before and after ``update(delta=)``."""
    _, ref, port = shared
    assert str(port["update"]) == str(ref["update"]) == "refresh"
    for i, case in enumerate(BORN_CASES):
        for j in range(case[3]):
            want = ref[f"{phase}{i}_col{j}"]
            _close(port[f"{phase}{i}_col{j}"], want, want[0])


def test_factors_shared_across_option_sets(dh):
    """The port's counterpart of the reference suite's ``_arrs_ex`` check:
    block-Jacobi and hybrid GS run end to end and each lowers its factors
    once; hybrid_gs_sym reads the same forward factor as hybrid_gs; the
    base tensors are shared by reference; block_size keys block-Jacobi's
    programs only."""
    from repro_torch.amg.dist_solve import DistHierarchy, dist_solve
    from repro_torch.amg.solve import SolveOptions

    dh = DistHierarchy(dh.h, N_PODS, LANES, dh.levels, torch.float64,
                       torch.device("cpu"), True, "nap3", True)
    b = np.ones(dh.levels[0].A.row_part.n)
    for sm in ("block_jacobi", "hybrid_gs"):
        res = dist_solve(dh, b, tol=0.0, maxiter=3,
                         opts=SolveOptions(cycle="F", smoother=sm))
        assert res.residuals[-1] < res.residuals[0]
    assert set(dh._arrs_ex) == {("bj", 4), ("gs", 0)}
    before = dh.factor_bytes()
    assert before > 0 and dh.nbytes >= before
    sym = dh.run_arrays(SolveOptions(smoother="hybrid_gs_sym"))
    gs = dh.run_arrays(SolveOptions(smoother="hybrid_gs"))
    assert sym[0]["minv"] is gs[0]["minv"] and "minv_u" in sym[0]
    assert sym[0]["A"] is dh._arrs[0]["A"]
    assert "minv" not in sym[-1]                  # the coarsest never smooths
    assert dh.run_arrays(SolveOptions(block_size=8)) is dh._arrs
    assert dh.factor_bytes() > before             # the backward triangle
    key = dh.programs.key
    assert key("cycle", SolveOptions(smoother="block_jacobi"), None) != \
        key("cycle", SolveOptions(smoother="block_jacobi", block_size=8), None)
    for sm in ("jacobi", "hybrid_gs"):
        assert key("cycle", SolveOptions(smoother=sm), None) == \
            key("cycle", SolveOptions(smoother=sm, block_size=8), None)


def test_refresh_cuts_only_placed_factors_and_escalates_a_moved_pattern():
    """A refresh cuts local blocks and factors only on the levels where a
    block smoother placed one (a Jacobi-only session pays nothing); a
    placed triangle whose recomputed pattern no longer matches makes the
    update a re-setup, before any value is copied."""
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.api import SessionStore
    from repro_torch.amg.csr import CSR
    from repro_torch.amg.dist_solve import dist_pcg
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.amg.solve import SolveOptions

    A = laplace_3d(N)
    b = np.ones(A.nrows)
    cfg = AMGConfig(backend="torch", n_pods=N_PODS, lanes=LANES,
                    dtype="float64", device="cpu", max_coarse=MAX_COARSE)
    bound = AMGSolver(cfg, store=SessionStore(),
                      setup_store=SessionStore()).setup(A)
    assert bound.pcg(b).converged
    dh = bound.dist_hierarchy
    delta = _drifted(A, CSR) - A.data
    assert bound.update(delta=delta) == "refresh"
    assert all(dl._local_A is None for dl in dh.levels)
    opts = SolveOptions(smoother="hybrid_gs")
    assert dist_pcg(dh, b, opts=opts).converged
    assert set(dh._factors) == {(l, "gs", 0) for l in range(len(dh.levels) - 1)}
    vals0 = dh._factors[(0, "gs", 0)].vals.clone()
    assert bound.update(delta=delta) == "refresh"
    assert bound.dist_hierarchy is dh
    assert not torch.equal(dh._factors[(0, "gs", 0)].vals, vals0)
    assert all((dl._local_A is not None) == (dl.coarse_inv is None)
               and set(dl._factor_cache) <= {("gs", 0)} for dl in dh.levels)
    f = dh._factors[(0, "gs", 0)]
    f.host_cols = f.host_cols.copy()
    f.host_cols[0, -1, 0] = -1 - f.host_cols[0, -1, 0]
    vals1 = f.vals.clone()
    assert bound.update(delta=-delta) == "resetup"
    assert bound.last_update_reason == "pattern"
    assert torch.equal(f.vals, vals1)            # nothing copied
    assert bound.pcg(b).converged


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
def test_plain_tri_solve_matches_dense_solve(upper, k):
    """The level-scheduled plain version on random sparse triangles (rows of
    0 to 40 stored entries, so some are longer than a warp) against
    ``np.linalg.solve`` of each rank's dense triangle; its level sets
    against a row-by-row count."""
    from repro_torch.kernels.smoother.ref import dag_levels, level_schedule
    from repro_torch.kernels.smoother.smoother import tri_solve

    rng = np.random.default_rng(7)
    D, m, K = 3, 60, 40
    cols = np.full((D, m, K), -1, dtype=np.int32)
    vals = np.zeros((D, m, K))
    dense = np.zeros((D, m, m))
    for d in range(D):
        for i in range(m):
            cand = np.arange(i + 1, m) if upper else np.arange(i)
            c = np.sort(rng.choice(cand, size=min(len(cand),
                                                  int(rng.integers(0, K + 1))),
                                   replace=False))
            cols[d, i, :c.size] = c
            vals[d, i, :c.size] = rng.standard_normal(c.size) * 0.1
            dense[d, i, c] = vals[d, i, :c.size]
    diag = 1.0 + rng.random((D, m))
    dense[:, np.arange(m), np.arange(m)] = diag
    r = rng.standard_normal((D, m, k))
    x = rng.standard_normal((D, m, k))
    want = x + 0.7 * np.linalg.solve(dense, r)
    lev = dag_levels(cols, upper)
    for d in range(D):
        rows = range(m - 1, -1, -1) if upper else range(m)
        seen = np.zeros(m, dtype=np.int64)
        for i in rows:
            c = cols[d, i][cols[d, i] >= 0]
            seen[i] = seen[c].max() + 1 if c.size else 0
        assert np.array_equal(lev[d], seen)
    sched = level_schedule(cols, upper)
    assert sum(len(s) for s in sched) == D * m and len(sched) == lev.max() + 1
    t = {n: torch.as_tensor(v) for n, v in
         (("cols", cols), ("vals", vals), ("diag", diag))}
    sq = (lambda a: a) if k > 1 else (lambda a: a[..., 0])
    got = tri_solve(t["cols"], t["vals"], t["diag"], torch.as_tensor(sq(r)),
                    torch.as_tensor(sq(x)), 0.7, upper=upper).numpy()
    got = got if k > 1 else got[..., None]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("method", ["pcg", "solve"])
def test_block_jacobi_at_block_size_one_is_jacobi(dh, method):
    """Block-Jacobi with 1×1 blocks is weighted Jacobi: the same history
    (the reference suite checks it on the host, tests/test_cycles.py)."""
    from repro_torch.amg.solve import SolveOptions

    B = np.random.default_rng(3).standard_normal((dh.levels[0].A.row_part.n, 1))
    fn = _fns()[method]
    jac = fn(dh, B[:, 0], tol=0.0, maxiter=ITERS,
             opts=SolveOptions(smoother="jacobi"))
    bj = fn(dh, B[:, 0], tol=0.0, maxiter=ITERS,
            opts=SolveOptions(smoother="block_jacobi", block_size=1))
    assert np.abs(np.subtract(bj.residuals, jac.residuals)).max() \
        <= 1e-13 * jac.residuals[0]
    assert np.abs(bj.x - jac.x).max() <= 1e-13 * np.abs(jac.x).max()


def test_wrappers_check_their_operands():
    """Both wrappers refuse what their kernels do not take."""
    from repro_torch.kernels.smoother.smoother import block_diag_apply, tri_solve

    r = torch.zeros((2, 5), dtype=torch.float64)
    binv = torch.zeros((2, 2, 3, 3), dtype=torch.float64)
    assert block_diag_apply(binv, r, r, 1.0).shape == (2, 5)
    with pytest.raises(TypeError):
        block_diag_apply(binv.float(), r, r, 1.0)
    with pytest.raises(ValueError, match="blocks"):
        block_diag_apply(torch.zeros((2, 1, 3, 3), dtype=torch.float64), r, r)
    with pytest.raises(ValueError):
        block_diag_apply(binv, r, r[:, :4])
    cols = torch.full((2, 5, 2), -1, dtype=torch.int32)
    vals = torch.zeros((2, 5, 2), dtype=torch.float64)
    diag = torch.ones((2, 5), dtype=torch.float64)
    assert torch.equal(tri_solve(cols, vals, diag, r + 1, r, upper=False),
                       r + 1)
    with pytest.raises(TypeError):
        tri_solve(cols.long(), vals, diag, r, r, upper=True)
    with pytest.raises(ValueError):
        tri_solve(cols, vals, diag[:, :4], r, r, upper=True)


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "--jax-ref":
        sys.exit("usage: test_torch_block_smoothers.py --jax-ref OUT.npz IN.npz")
    _jax_reference(sys.argv[2], sys.argv[3])
