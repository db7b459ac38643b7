"""Streaming matrix sessions on ``backend="torch"``: ``A + ΔA`` updates that
refresh the lowered hierarchy in place beneath its compiled programs.

* The refreshed value planes (ELL, on/off split, BCSR re-tile), diagonals,
  Chebyshev bounds and coarse pseudo-inverse are bit-equal to the
  reference's refresh (``repro.amg.dist_spmv.DistOperator.refresh_values``
  on the reference's own lowering, in this process), and the device tensors
  are the build's, written in place.
* PCG after a refresh: the residual history matches the reference's host
  backend refreshed the same way (≤ 1e-7 of r0) and the solution a fresh
  setup on ``A + ΔA`` (≤ 1e-7, the bar of the reference's
  ``test_refresh_parity_vs_fresh_setup``; a fresh setup re-derives the
  interpolation from the new values, so its history differs from a
  refresh's, which keeps P frozen).
* The reference's session cases: pattern mismatch, one re-setup on an
  injected regression, update after eviction, the delta and data forms, the
  caller's matrix untouched, the store's update counters.

The reference's 8-device refreshed dist solve is compared in
``tests/test_torch_dist_solve.py`` (its JAX subprocess).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.amg import AMGConfig as RefAMGConfig  # noqa: E402
from repro.amg import AMGSolver as RefAMGSolver  # noqa: E402
from repro.amg import hierarchy as ref_hierarchy  # noqa: E402
from repro.amg import problems as ref_problems  # noqa: E402
from repro.amg.dist_solve import DistHierarchy as RefDistHierarchy  # noqa: E402
from repro.core import TPU_V5E as REF_TPU_V5E  # noqa: E402
from repro_torch.amg import (AMGConfig, AMGService, AMGSolver,  # noqa: E402
                             PatternMismatch, RefreshPolicy, setup)
from repro_torch.amg.api import (LRUPolicy, SessionStore,  # noqa: E402
                                 apply_update, clear_sessions,
                                 matrix_fingerprint)
from repro_torch.amg.api.registry import bind_hierarchy  # noqa: E402
from repro_torch.amg.csr import CSR  # noqa: E402
from repro_torch.amg.dist_solve import DistHierarchy  # noqa: E402
from repro_torch.amg.hierarchy import refresh_values  # noqa: E402
from repro_torch.amg.problems import laplace_3d  # noqa: E402

TOL = 1e-7
PLANES = ("ell_cols", "ell_vals", "on_cols", "on_vals", "off_cols",
          "off_vals", "bcsr_bcols", "bcsr_bvals", "bcsr_on_bcols",
          "bcsr_on_bvals")
DEVICE_PLANES = {"vals": "ell_vals", "on_vals": "on_vals",
                 "off_vals": "off_vals", "bvals": "bcsr_bvals",
                 "on_bvals": "bcsr_on_bvals"}


@pytest.fixture(autouse=True)
def _fresh_sessions():
    clear_sessions()
    yield
    clear_sessions()


@pytest.fixture(scope="module")
def problem():
    A = laplace_3d(8)
    b = np.random.default_rng(7).standard_normal(A.nrows)
    return A, b


def _drift(A, scale=0.03, seed=1):
    """A value-only drift on A's frozen pattern (SPD-safe: scales data), the
    reference suite's ``tests/test_streaming.py:_drift``."""
    rng = np.random.default_rng(seed)
    data = A.data * (1.0 + scale * rng.random(A.nnz))
    At = CSR(A.shape, A.indptr.copy(), A.indices.copy(), data).T
    return CSR(A.shape, A.indptr.copy(), A.indices.copy(),
               0.5 * (data + At.data))


def _cfg(**kw):
    return AMGConfig(**{**dict(backend="torch", n_pods=2, lanes=4,
                               dtype="float64", device="cpu", tol=1e-10,
                               max_coarse=30), **kw})


# ----------------------------------------------------- refreshed planes
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mesh", [(2, 4), (4, 2)])
@pytest.mark.parametrize("size", [8, 10])
def test_refreshed_planes_are_bit_equal_to_reference(size, mesh, dtype):
    np_dtype = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    A_ref = ref_problems.laplace_3d(size)
    h_ref = ref_hierarchy.setup(A_ref, solver="rs", max_coarse=30)
    h = setup(laplace_3d(size), solver="rs", max_coarse=30)
    lr_all = RefDistHierarchy._lower_levels(
        h_ref.levels, *mesh, params=REF_TPU_V5E, strategy="auto",
        strategies=("standard", "nap2", "nap3"), dtype=np_dtype)
    dh = DistHierarchy.build(h, *mesh, dtype=dtype, device="cpu")
    ptrs = [t.data_ptr() for a in dh._arrs for v in a.values()
            for t in (v.values() if isinstance(v, dict) else (v,))]
    A2 = _drift(h.levels[0].A)
    ref_hierarchy.refresh_values(h_ref, A2)
    refresh_values(h, A2)
    dh.refresh_values(h.levels)
    for lv, dl in zip(h_ref.levels, lr_all):
        for op in ("A", "P", "R"):
            if getattr(dl, op) is not None:
                getattr(dl, op).refresh_values(lambda d, M=getattr(lv, op): M)
    # dinv, rho and the coarse inverse as the reference's lowering of the
    # refreshed levels computes them (its refresh uses the same formulas)
    fresh = RefDistHierarchy._lower_levels(
        h_ref.levels, *mesh, params=REF_TPU_V5E, strategy="auto",
        strategies=("standard", "nap2", "nap3"), dtype=np_dtype)
    assert any(dl.A.block_size for dl in dh.levels)     # a BCSR re-tile
    for l, (lr, lf, lp, a) in enumerate(zip(lr_all, fresh, dh.levels,
                                            dh._arrs)):
        assert lp.rho == lf.rho, l
        np.testing.assert_array_equal(lp.dinv, lf.dinv)
        assert (lp.coarse_inv is None) == (lf.coarse_inv is None)
        if lp.coarse_inv is not None:
            np.testing.assert_array_equal(lp.coarse_inv, lf.coarse_inv)
            assert torch.equal(a["cinv"], torch.as_tensor(lp.coarse_inv).to(dtype))
        assert torch.equal(a["dinv"], torch.as_tensor(lp.dinv).to(dtype))
        for op in ("A", "P", "R"):
            orf, opt = getattr(lr, op), getattr(lp, op)
            if orf is None:
                assert opt is None
                continue
            for f in PLANES:
                x, y = getattr(orf, f), getattr(opt, f)
                assert (x is None) == (y is None), (l, op, f)
                if x is not None:
                    assert x.dtype == y.dtype and np.array_equal(x, y), \
                        (l, op, f)
            for dev, host in DEVICE_PLANES.items():
                if dev in a[op]:
                    assert torch.equal(a[op][dev], torch.as_tensor(
                        getattr(opt, host)).to(dtype)), (l, op, dev)
    assert ptrs == [t.data_ptr() for a in dh._arrs for v in a.values()
                    for t in (v.values() if isinstance(v, dict) else (v,))]


def test_refresh_checks_shapes_and_dtypes(problem):
    A, _ = problem
    h = setup(A, solver="rs", max_coarse=30)
    dh = DistHierarchy.build(h, 2, 4, dtype=torch.float64, device="cpu")
    op = dh.levels[0].A
    with pytest.raises(ValueError, match="device tensor"):
        op.copy_values(dict(dh._arrs[0]["A"], vals=torch.zeros(3)),
                       torch.float64)
    with pytest.raises(ValueError, match="device tensor"):
        op.copy_values(dh._arrs[0]["A"], torch.float32)


# ------------------------------------------------------ session updates
def test_refresh_parity_vs_host_refresh_and_fresh_setup(problem):
    A, b = problem
    cfg = _cfg()
    bound = AMGSolver(cfg).setup(A)
    host = RefAMGSolver(RefAMGConfig(tol=1e-10, max_coarse=30)).setup(A)
    bound.pcg(b)
    host.pcg(b)
    A2 = _drift(A)
    delta = A2.data - A.data
    h_before, dh_before = bound.hierarchy, bound.dist_hierarchy
    assert bound.update(delta=delta) == "refresh"
    assert host.update(delta=delta) == "refresh"
    assert bound.hierarchy is h_before and bound.dist_hierarchy is dh_before
    res, want = bound.pcg(b), host.pcg(b)
    assert res.converged and res.iterations == want.iterations
    assert np.abs(np.subtract(res.residuals, want.residuals)).max() \
        <= TOL * want.residuals[0]
    clear_sessions()
    fresh = AMGSolver(cfg.replace(backend="host")).setup(
        apply_update(A, delta=delta)).pcg(b)
    assert np.abs(res.x - fresh.x).max() <= TOL
    # the refreshed session answers for A + ΔA's fingerprint now
    clear_sessions()
    s = AMGSolver(cfg)
    bound2 = s.setup(A)
    bound2.update(A2)
    assert s.setup(A2) is bound2


def test_refresh_keeps_jacobi_programs_drops_chebyshev(problem):
    A, b = problem
    bound = AMGSolver(_cfg()).setup(A)
    cheb = AMGSolver(_cfg(opts=bound.opts.__class__(smoother="chebyshev"))) \
        .setup(A)
    bound.pcg(b)
    cheb.pcg(b)
    dh = bound.dist_hierarchy
    assert cheb.dist_hierarchy is dh             # one lowering, both opts
    jac = {k: p for k, p in zip(dh.programs.keys(), dh.programs.values())
           if k.smoother == "jacobi"}
    assert len(jac) == 2 and len(dh.programs) == 4
    assert bound.update(_drift(A)) == "refresh"
    assert dict(zip(dh.programs.keys(), dh.programs.values())) == jac
    A2 = bound._fine
    for s in (bound, cheb):
        r = s.pcg(b)
        assert np.linalg.norm(b - A2.matvec(r.x)) / np.linalg.norm(b) < 1e-9


def test_refresh_preserves_caller_matrix(problem):
    A, _ = problem
    before = A.data.copy()
    bound = AMGSolver(_cfg()).setup(A)
    bound.update(_drift(A))
    np.testing.assert_array_equal(A.data, before)


def test_pattern_mismatch_is_typed_and_refuses_refresh(problem):
    A, _ = problem
    bound = AMGSolver(_cfg()).setup(A)
    with pytest.raises(PatternMismatch):
        bound.update(A.prune(2.0))               # off-diagonals dropped
    with pytest.raises(PatternMismatch):
        bound.update(data=np.ones(3))
    with pytest.raises(ValueError, match="not both"):
        bound.update(A, delta=np.zeros(A.nnz))


def test_injected_regression_triggers_exactly_one_resetup(problem):
    A, b = problem
    store = SessionStore(LRUPolicy())
    cfg = _cfg(refresh=RefreshPolicy(regress_ratio=1.5, regress_slack=2))
    bound = AMGSolver(cfg, store=store).setup(A)
    base = bound.pcg(b).iterations
    assert bound.baseline_iterations == base
    assert bound.update(_drift(A, seed=2)) == "refresh"
    assert bound.baseline_iterations == base
    bound.last_iterations = int(1.5 * base + 3)
    dh_before = bound.dist_hierarchy
    assert bound.update(_drift(A, seed=3)) == "resetup"
    assert bound.baseline_iterations is None and bound._dist is None
    st = store.stats()
    assert st["resetups"] == 1 and st["refreshes"] == 1
    assert st["triggers"] == {"drift": 1, "regression": 1}
    assert bound.update(_drift(A, seed=4)) == "refresh"
    assert store.stats()["resetups"] == 1
    res = bound.pcg(b)                           # lowered anew, solves A4
    assert bound.dist_hierarchy is not dh_before and res.converged
    A4 = _drift(A, seed=4)
    assert np.linalg.norm(b - A4.matvec(res.x)) / np.linalg.norm(b) < 1e-9


def test_update_needs_a_streaming_session(problem):
    A, _ = problem
    bound = bind_hierarchy(setup(A, max_coarse=30), backend="torch",
                           dist=dict(n_pods=2, lanes=4, device="cpu",
                                     dtype=torch.float64))
    with pytest.raises(ValueError, match="streaming updates"):
        bound.update(_drift(A))


# -------------------------------------------------------- service routing
def test_service_update_keeps_matrix_id_stable(problem):
    A, b = problem
    svc = AMGService(_cfg())
    svc.register("m", A)
    t0 = svc.submit("m", b, method="pcg")
    svc.drain()
    A2 = _drift(A)
    assert svc.update("m", A2) == {"matrix": "m", "action": "refresh",
                                   "reason": "drift"}
    t1 = svc.submit("m", b, method="pcg")
    x = svc.drain()[t1.rid]
    assert np.linalg.norm(b - A2.matvec(x)) / np.linalg.norm(b) < 1e-8
    assert t0.done() and svc.stats["updates"] == 1
    st = svc.store.stats()
    assert st["refreshes"] == 1 and st["resetups"] == 0


def test_service_update_escalates_on_pattern_change(problem):
    A, _ = problem
    svc = AMGService(_cfg())
    svc.register("m", A)
    svc.bound_for("m")
    A_diag = A.prune(2.0)
    out = svc.update("m", A_diag)
    assert out["action"] == "resetup" and out["reason"] == "pattern"
    _, fp = svc._lookup_matrix("m")
    assert fp == matrix_fingerprint(A_diag)
    assert svc.store.stats()["triggers"]["pattern"] == 1


def test_update_after_eviction_runs_full_setup(problem):
    A, b = problem
    store = SessionStore(LRUPolicy(1))
    svc = AMGService(_cfg(), store=store)
    svc.register("m", A)
    svc.register("other", laplace_3d(6))
    svc.bound_for("m")
    svc.bound_for("other")                       # evicts m's session
    out = svc.update("m", _drift(A))
    assert out["action"] == "resetup" and out["reason"] == "evicted"
    assert store.stats()["triggers"] == {"evicted": 1}
    t = svc.submit("m", b, method="pcg")
    assert svc.drain()[t.rid].shape == b.shape


def test_delta_and_data_forms_compose(problem):
    A, _ = problem
    svc = AMGService(_cfg())
    svc.register("m", A)
    svc.bound_for("m")
    delta = np.zeros(A.nnz)
    delta[0] = 0.25
    assert svc.update("m", delta=delta)["action"] == "refresh"
    vals = A.data + delta
    assert svc.update("m", data=vals)["action"] == "refresh"
    got, _ = svc._lookup_matrix("m")
    np.testing.assert_array_equal(got.data, vals)
    np.testing.assert_array_equal(svc.bound_for("m")._fine.data, vals)
    with pytest.raises(ValueError, match="not both"):
        svc.update("m", A, delta=delta)


def test_session_store_update_counters():
    store = SessionStore(LRUPolicy())
    store.note_update("refresh", "drift")
    store.note_update("resetup", "regression")
    store.note_update("resetup", "pattern")
    st = store.stats()
    assert st["refreshes"] == 1 and st["resetups"] == 2
    assert st["triggers"] == {"drift": 1, "regression": 1, "pattern": 1}
    with pytest.raises(ValueError, match="unknown update action"):
        store.note_update("rebuild", "drift")
    store.put("a", 1)
    store.rekey("a", "b")
    assert store.keys() == ["b"] and store.get("b") == 1
