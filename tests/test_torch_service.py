"""``AMGService`` on ``backend="torch"`` (CPU), mirroring the reference suite's
``tests/test_service.py``: ticketed admission, coalescing into the multi-RHS
programs in chunks of at most ``max_rhs`` columns, per-request knobs,
priority scheduling, wire-only operation and session-store accounting.

Results are held against the reference's ``AMGService`` on
``backend="host"`` fed the same requests: iteration counts equal, solutions
and residual histories within 1e-7 (of max|x| and of r0).  Tests that wait
for the worker wait on an explicit event or on the service's condition,
never on a sleep.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.amg import AMGConfig as RefAMGConfig  # noqa: E402
from repro.amg import AMGService as RefAMGService  # noqa: E402
from repro_torch.amg import AMGConfig, AMGService  # noqa: E402
from repro_torch.amg.api import (BytesBudgetPolicy, ServiceClosed,  # noqa: E402
                                 SessionStore, clear_sessions, csr_to_wire,
                                 solve_request_to_wire)
from repro_torch.amg.api.service import _Group, _Pending  # noqa: E402
from repro_torch.amg.problems import laplace_3d  # noqa: E402

TOL = 1e-7


@pytest.fixture(autouse=True)
def _fresh_sessions():
    clear_sessions()
    yield
    clear_sessions()


@pytest.fixture(scope="module")
def problem():
    A = laplace_3d(6)
    b = A.matvec(np.ones(A.nrows))
    return A, b


def _cfg(**kw):
    return AMGConfig(**{**dict(backend="torch", n_pods=2, lanes=4,
                               dtype="float64", device="cpu"), **kw})


def _service(config=None, **kw):
    return AMGService(config or _cfg(), **kw)


def _ref_service(**kw):
    return RefAMGService(RefAMGConfig(), **kw)


def _same_x(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


# ------------------------------------------------------------- admission
def test_submit_validation(problem):
    A, b = problem
    svc = _service()
    svc.register("m", A)
    with pytest.raises(KeyError, match="unknown matrix_id"):
        svc.submit("nope", b)
    with pytest.raises(ValueError, match="unknown method"):
        svc.submit("m", b, method="gmres")
    with pytest.raises(ValueError, match="b must be"):
        svc.submit("m", b[:-1])
    with pytest.raises(ValueError, match="x0 must match"):
        svc.submit("m", b, x0=np.zeros(3))
    with pytest.raises(ValueError, match="unknown priority class"):
        svc.submit("m", b, priority="urgent")


def test_ticket_requires_worker_or_drain(problem):
    A, b = problem
    svc = _service()
    svc.register("m", A)
    t = svc.submit("m", b)
    assert not t.done()
    with pytest.raises(RuntimeError, match="drain"):
        t.result(timeout=0.1)
    out = svc.drain()
    assert t.done()
    np.testing.assert_array_equal(t.result(), out[t.rid])


def test_drain_groups_by_compatible_knobs_as_the_reference(problem):
    """Same (matrix, method, tol, maxiter) coalesces into one multi-RHS
    solve; a request with its own tol gets its own group — with the same
    answers and iteration counts as the reference's host service."""
    A, _ = problem
    rng = np.random.default_rng(0)
    bs = [rng.standard_normal(A.nrows) for _ in range(4)]
    got, want = {}, {}
    for make, out in ((_service, got), (_ref_service, want)):
        svc = make(max_rhs=8)
        svc.register("m", A)
        tickets = [svc.submit("m", bi, method="pcg") for bi in bs[:3]]
        tickets.append(svc.submit("m", bs[3], method="pcg", tol=1e-3))
        svc.drain()
        out["x"] = [t.result() for t in tickets]
        out["it"] = [t.diagnostics["iterations"] for t in tickets]
        out["stats"] = (svc.stats["batches"], svc.stats["batched_rhs"],
                        tickets[3].diagnostics["batch_cols"])
    assert got["stats"] == want["stats"] == (2, 3, 1)
    assert got["it"] == want["it"] and got["it"][3] < max(got["it"][:3])
    for g, w in zip(got["x"], want["x"]):
        _same_x(g, w)


def test_chunk_histories_match_the_reference(problem):
    """What one coalesced chunk runs — the k-column PCG through the
    ``*_m`` programs — against the reference host session's columns."""
    A, _ = problem
    rng = np.random.default_rng(9)
    B = rng.standard_normal((A.nrows, 5))
    svc, ref = _service(), _ref_service()
    for s in (svc, ref):
        s.register("m", A)
    res = svc.bound_for("m").pcg(B)
    want = ref.bound_for("m").pcg(B)
    dh = svc.bound_for("m").dist_hierarchy
    assert {(k.name, k.k) for k in dh.programs.keys()} == {
        ("pcg_init_m", 5), ("pcg_step_m", 5)}
    for c, w in zip(res.columns, want.columns):
        assert c.iterations == w.iterations
        assert np.abs(np.subtract(c.residuals, w.residuals)).max() \
            <= TOL * w.residuals[0]


def test_per_request_maxiter_and_x0_warm_start(problem):
    A, b = problem
    svc = _service()
    svc.register("m", A)
    capped = svc.submit("m", b, method="solve", tol=1e-14, maxiter=3)
    svc.drain()
    assert capped.diagnostics["iterations"] == 3
    assert not capped.diagnostics["converged"]
    assert svc.stats["unconverged"] == 1
    ref = svc.submit("m", b, method="pcg")
    svc.drain()
    warm = svc.submit("m", b, method="pcg", x0=ref.result())
    svc.drain()
    assert warm.diagnostics["iterations"] == 0
    assert warm.diagnostics["converged"]


def test_multi_rhs_payload_and_mixed_batch(problem):
    """[n, k] payloads ride the same multi-RHS solve as [n] requests; each
    request gets back its own columns, as from the reference."""
    A, b = problem
    rng = np.random.default_rng(1)
    B = np.stack([rng.standard_normal(A.nrows) for _ in range(2)], axis=1)
    out = []
    for make in (_service, _ref_service):
        svc = make(max_rhs=8)
        svc.register("m", A)
        t_multi = svc.submit("m", B, method="pcg")
        t_single = svc.submit("m", b, method="pcg")
        svc.drain()
        assert svc.stats["batches"] == 1 and svc.stats["batched_rhs"] == 3
        assert t_multi.result().shape == B.shape
        assert t_single.result().shape == b.shape
        out.append((t_multi.result(), t_single.result()))
    for g, w in zip(*out):
        _same_x(g, w)
    rel = np.linalg.norm(b - A.matvec(out[0][1])) / np.linalg.norm(b)
    assert rel < 1e-6


def test_max_rhs_chunks_columns(problem):
    A, _ = problem
    rng = np.random.default_rng(2)
    svc = _service(max_rhs=2)
    svc.register("m", A)
    for _ in range(5):
        svc.submit("m", rng.standard_normal(A.nrows))
    svc.drain()
    assert svc.stats["batches"] == 3               # 2 + 2 + 1
    assert svc.stats["batched_rhs"] == 4
    dh = svc.bound_for("m").dist_hierarchy
    assert {k.k for k in dh.programs.keys()} == {None, 2}   # a graph a width


# ------------------------------------------------------------- scheduling
def test_priority_classes_order_drain(problem):
    A, _ = problem
    rng = np.random.default_rng(3)
    svc = _service()
    svc.register("m", A)
    batch = svc.submit("m", rng.standard_normal(A.nrows), priority="batch")
    inter = svc.submit("m", rng.standard_normal(A.nrows), tol=1e-7,
                       priority="interactive")
    svc.drain()
    assert inter.diagnostics["batch"] < batch.diagnostics["batch"]


def test_priority_aging_prevents_starvation():
    svc = _service(priority_aging=0.5)
    old_batch = _Group(("m", "solve", 0.0, 1), created=0.0)
    old_batch.requests.append(_Pending(0, np.ones(2), None, 2, 0.0, None))
    fresh_inter = _Group(("m", "pcg", 0.0, 1), created=10.0)
    fresh_inter.requests.append(_Pending(1, np.ones(2), None, 0, 10.0, None))
    assert (svc._order_key(fresh_inter, 10.1)
            < svc._order_key(old_batch, 10.1 - 10.0 + 0.9))
    assert svc._order_key(old_batch, 10.1) < svc._order_key(fresh_inter, 10.1)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_worker_coalesces_across_bursts(problem):
    """Threaded mode: requests submitted in separate bursts inside one
    window ride ONE multi-RHS solve.  The window is a fake clock's: the
    worker cannot launch the group before the test moves the clock past it
    and wakes the worker."""
    A, _ = problem
    rng = np.random.default_rng(4)
    clock = FakeClock()
    svc = _service(max_rhs=8, coalesce_window=1.0, clock=clock)
    svc.register("m", A)
    bs = [rng.standard_normal(A.nrows) for _ in range(3)]
    with svc:
        tickets = []
        for bi in bs:                           # three bursts, 0.02 s apart
            tickets.append(svc.submit("m", bi, method="pcg"))
            clock.now += 0.02
        assert not any(t.done() for t in tickets)
        with svc._cond:
            clock.now += 1.0                    # the window has passed
            svc._cond.notify_all()
        xs = [t.result(timeout=120) for t in tickets]
    assert svc.stats["batches"] == 1
    assert svc.stats["batched_rhs"] == 3
    for bi, xi in zip(bs, xs):
        assert np.linalg.norm(bi - A.matvec(xi)) / np.linalg.norm(bi) < 1e-6
    with pytest.raises(RuntimeError, match="drain"):
        with svc:
            svc.drain()


def test_worker_runs_the_multi_rhs_programs_on_its_thread(problem):
    """The worker thread runs every solve; a done-callback (an explicit
    event) tells the test when."""
    A, _ = problem
    rng = np.random.default_rng(8)
    svc = _service(max_rhs=4)
    svc.register("m", A)
    done, threads = threading.Event(), set()
    tickets = [svc.submit("m", rng.standard_normal((A.nrows, 2)), method="pcg")
               for _ in range(3)]

    def landed(t):
        threads.add(threading.current_thread().name)
        if all(tk.done() for tk in tickets):
            done.set()

    for t in tickets:
        t.add_done_callback(landed)
    with svc:
        assert done.wait(timeout=120)
    assert threads == {"amg-service"}
    assert svc.stats["batches"] == 2 and svc.stats["batched_rhs"] == 6
    assert [t.diagnostics["batch_cols"] for t in tickets] == [4, 4, 2]


def test_worker_close_flushes_queue(problem):
    A, _ = problem
    svc = _service(coalesce_window=30.0)
    svc.register("m", A)
    svc.start()
    t = svc.submit("m", np.ones(A.nrows))
    svc.close()
    assert t.done()
    assert svc.stats["batches"] == 1


def test_close_fails_queued_tickets_with_service_closed(problem):
    A, _ = problem
    svc = _service(coalesce_window=60.0)
    svc.register("m", A)
    svc.start()
    tickets = [svc.submit("m", np.ones(A.nrows), rid=r) for r in (7, 8)]
    svc.close(flush=False)
    for t in tickets:
        assert t.done()
        assert isinstance(t.exception(), ServiceClosed)
        with pytest.raises(ServiceClosed):
            t.result(timeout=0)
    assert svc.stats["errors"] == 2
    assert svc.stats["batches"] == 0
    assert "ServiceClosed" in svc.diagnostics[7]["error"]
    svc2 = _service()
    svc2.register("m", A)
    t = svc2.submit("m", np.ones(A.nrows))
    svc2.close(flush=False)
    assert isinstance(t.exception(), ServiceClosed)


def test_ticket_done_callbacks_fire_once_each(problem):
    A, _ = problem
    svc = _service()
    svc.register("m", A)
    seen = []
    t = svc.submit("m", np.ones(A.nrows))
    t.add_done_callback(lambda tk: seen.append(("pre", tk.done())))
    svc.drain()
    assert seen == [("pre", True)]
    t.add_done_callback(lambda tk: seen.append(("post", tk.done())))
    assert seen == [("pre", True), ("post", True)]


def test_matrix_registry_is_bounded():
    mats = {f"m{i}": laplace_3d(4 + i) for i in range(3)}
    svc = _service(max_matrices=2)
    for mid, M in mats.items():
        svc.register(mid, M)
    assert sorted(svc._matrices.keys()) == ["m1", "m2"]
    with pytest.raises(KeyError) as ei:
        svc.submit("m0", np.ones(mats["m0"].nrows))
    assert "m1" in str(ei.value)
    rep = svc.report()
    assert rep.matrices["entries"] == 2
    assert rep.matrices["evictions"] == 1
    assert "matrices[lru]" in rep.summary()
    one = svc._matrices.stats()["bytes"] // 2
    svc2 = _service(max_matrix_bytes=int(one * 1.4))
    for mid, M in mats.items():
        svc2.register(mid, M)
    st = svc2._matrices.stats()
    assert st["policy"] == "bytes_budget"
    assert st["bytes"] <= int(one * 1.4)
    assert st["evictions"] >= 1


# ------------------------------------------------------------------- wire
def test_wire_only_operation(problem):
    """Register + solve purely through encoded payloads (every payload
    through a json byte hop), against the reference service fed the same
    payloads."""
    A, b = problem
    rng = np.random.default_rng(5)
    bs = [b] + [rng.standard_normal(A.nrows) for _ in range(2)]
    out = []
    for svc in (_service(_cfg(tol=1e-8)),
                RefAMGService(RefAMGConfig(tol=1e-8))):
        mid = svc.register_wire(json.loads(json.dumps(csr_to_wire(A))))
        tickets = [svc.submit_wire(json.loads(json.dumps(
            solve_request_to_wire(mid, bi, method="pcg")))) for bi in bs]
        svc.drain()
        assert svc.stats["wire_requests"] == 3
        assert svc.stats["batches"] == 1
        assert svc.register_wire(csr_to_wire(A)) == mid
        out.append((mid, [t.result() for t in tickets]))
    assert out[0][0] == out[1][0]                  # the same fingerprint id
    for g, w in zip(out[0][1], out[1][1]):
        _same_x(g, w)


# ------------------------------------------------------------- accounting
def test_store_accounting_hits_evictions_setup_cost(problem):
    A, b = problem
    A2 = laplace_3d(5)
    store = SessionStore(BytesBudgetPolicy(max_bytes=1))
    svc = _service(store=store)
    svc.register("m1", A)
    svc.register("m2", A2)
    svc.submit("m1", b)
    svc.drain()
    st = store.stats()
    assert st["misses"] == 1 and st["puts"] == 1
    assert st["evictions"] == 1
    assert st["setup_cost_evicted"] > 0
    assert svc.stats["setups"] == 1
    svc.submit("m1", b)
    svc.drain()
    assert store.stats()["misses"] == 2
    assert svc.stats["setups"] == 2
    store2 = SessionStore()
    svc2 = _service(store=store2)
    svc2.register("m1", A)
    svc2.register("m2", A2)
    svc2.submit("m1", b)
    svc2.drain()
    svc2.submit("m1", b)
    svc2.submit("m2", np.ones(A2.nrows))
    svc2.drain()
    st2 = store2.stats()
    assert st2["hits"] == 1 and st2["misses"] == 2
    assert st2["entries"] == 2 and st2["evictions"] == 0
    assert st2["bytes"] > 0 and st2["setup_cost_total"] > 0
    rep = svc2.report()
    assert rep.store["hits"] == 1
    assert set(rep.per_request) == set(svc2.diagnostics)
    assert "store[" in rep.summary()


def test_submit_copies_request_buffers(problem):
    A, b = problem
    svc = _service()
    svc.register("m", A)
    buf = b.copy()
    t1 = svc.submit("m", buf, method="pcg")
    buf[:] = 0.0
    t2 = svc.submit("m", buf + 1.0, method="pcg")
    svc.drain()
    rel = np.linalg.norm(b - A.matvec(t1.result())) / np.linalg.norm(b)
    assert rel < 1e-6
    assert t2.diagnostics["converged"]


def test_diagnostics_history_is_bounded(problem):
    A, b = problem
    svc = _service(_cfg(tol=1e-2, maxiter=2), diagnostics_limit=3)
    svc.register("m", A)
    for _ in range(5):
        svc.submit("m", b)
        svc.drain()
    assert len(svc.diagnostics) == 3
    assert svc.stats["requests"] == 5


def test_bytes_accounting_sees_lazy_torch_lowering(problem):
    A, b = problem
    store = SessionStore()
    svc = _service(_cfg(tol=1e-4), store=store)
    svc.register("m", A)
    bound = svc.bound_for("m")
    before = store.stats()["bytes"]
    svc.submit("m", b, method="pcg")
    svc.drain()
    assert bound._dist is not None
    assert store.stats()["bytes"] > before


def _store_session(cfg, A):
    """A session in a store of its own, its host setup in another (so the
    store's bytes are this session's alone), lowered."""
    from repro_torch.amg import AMGSolver
    store = SessionStore()
    bound = AMGSolver(cfg, store=store, setup_store=SessionStore()).setup(A)
    dh = bound.dist_hierarchy
    return store, bound, dh


def test_store_bytes_count_the_programs_state_buffers(problem):
    """A torch session's store bytes grow by the state buffers its program
    runs allocate, per width, and count its own lowering once: a float32
    session on the same host hierarchy holds a lowering of its own."""
    from repro_torch.amg import AMGSolver
    from repro_torch.amg.api import session_nbytes
    A, b = problem
    store, bound, dh = _store_session(_cfg(), A)
    before = store.stats()["bytes"]
    assert dh.programs.state_bytes() == 0
    bound.pcg(b)
    single = dh.programs.state_bytes()
    assert single > 0 and store.stats()["bytes"] == before + single
    bound.pcg(np.stack([b, 2 * b, 3 * b], axis=1))
    assert dh.programs.state_bytes() == 4 * single     # widths 1 and 3
    assert store.stats()["bytes"] == before + 4 * single
    assert dh.programs.pool_bytes() == 0               # no graph off the card
    b32 = AMGSolver(_cfg(dtype="float32"), store=store,
                    setup_store=SessionStore()).setup(A)
    b32.pcg(b)
    dh32 = b32.dist_hierarchy
    assert dh32 is not dh
    assert session_nbytes(b32) == session_nbytes(b32.hierarchy) + dh32.nbytes
    assert store.stats()["bytes"] == session_nbytes(bound) + session_nbytes(b32)


@pytest.mark.cuda
def test_store_bytes_include_the_graph_pool_on_the_card(problem):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, b = problem
    store, bound, dh = _store_session(_cfg(device="cuda"), A)
    levels = store.stats()["bytes"]
    bound.pcg(b)                                # captures pcg_init/pcg_step
    pool, state = dh.programs.pool_bytes(), dh.programs.state_bytes()
    assert pool > 0 and state > 0
    assert store.stats()["bytes"] == levels + state + pool


def test_error_lands_on_ticket(problem, monkeypatch):
    A, b = problem
    svc = _service()
    svc.register("m", A)
    t = svc.submit("m", b)
    monkeypatch.setattr(svc.solver, "setup",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("device fell over")))
    out = svc.drain()
    assert out == {} and svc.stats["errors"] == 1
    assert t.done()
    with pytest.raises(RuntimeError, match="device fell over"):
        t.result()
    assert "error" in svc.diagnostics[t.rid]


def test_float32_session_stages_once(problem):
    """A float32 torch session through the service stages b once in
    float32."""
    A, b = problem
    svc = _service(_cfg(dtype="float32", tol=1e-5))
    svc.register("m", A)
    t = svc.submit("m", b, method="pcg")
    svc.drain()
    assert t.diagnostics["converged"]
    rel = np.linalg.norm(b - A.matvec(t.result())) / np.linalg.norm(b)
    assert rel < 1e-4
    bound = svc.bound_for("m")
    assert bound.staging_dtype() == np.float32
    assert bound._check_b(b).dtype == np.float32


def test_block_smoother_through_service(problem):
    """The reference suite's ``test_dist_backend_through_service`` on the
    torch backend: the service drives a ``hybrid_gs_sym`` session (1×1 rank
    grid, float32) and stages b once in the session's staging dtype."""
    from repro_torch.amg import SolveOptions
    A, b = problem
    cfg = _cfg(n_pods=1, lanes=1, strategy="standard", dtype="float32",
               tol=1e-5, opts=SolveOptions(smoother="hybrid_gs_sym"))
    svc = _service(cfg)
    svc.register("m", A)
    t = svc.submit("m", b, method="pcg")
    svc.drain()
    assert t.diagnostics["converged"]
    rel = np.linalg.norm(b - A.matvec(t.result())) / np.linalg.norm(b)
    assert rel < 1e-4
    bound = svc.bound_for("m")
    assert bound.staging_dtype() == np.float32      # fp32 session
    assert bound._check_b(b).dtype == np.float32
    staged = bound._check_b(b.astype(np.float32))
    assert staged.dtype == np.float32               # converted exactly once
    assert bound.dist_hierarchy.factor_bytes() > 0


@pytest.mark.parametrize("smoother", ["block_jacobi", "hybrid_gs",
                                      "hybrid_gs_sym"])
def test_block_smoother_chunks_match_the_reference(problem, smoother):
    """A coalesced chunk of three requests (one of them [n, 2]) under each
    block smoother on 2×4 ranks, against the reference's host service with
    its smoother split into the same 8 row parts: the same iterations and
    answers, and the store counting the factors' bytes."""
    from repro.amg import SolveOptions as RefSolveOptions
    from repro_torch.amg import SolveOptions
    A, _ = problem
    rng = np.random.default_rng(4)
    reqs = [rng.standard_normal(A.nrows), rng.standard_normal((A.nrows, 2)),
            rng.standard_normal(A.nrows)]
    store = SessionStore()
    svc = _service(_cfg(opts=SolveOptions(smoother=smoother)), store=store)
    ref = RefAMGService(RefAMGConfig(opts=RefSolveOptions(
        smoother=smoother, smoother_parts=8)))
    got, want = {}, {}
    for s, out in ((svc, got), (ref, want)):
        s.register("m", A)
        tickets = [s.submit("m", r, method="pcg") for r in reqs]
        s.drain()
        out["x"] = [t.result() for t in tickets]
        out["it"] = [t.diagnostics["iterations"] for t in tickets]
    assert got["it"] == want["it"]
    for g, w in zip(got["x"], want["x"]):
        _same_x(g, w)
    dh = svc.bound_for("m").dist_hierarchy
    assert dh.factor_bytes() > 0
    assert store.stats()["bytes"] >= dh.nbytes >= dh.factor_bytes()
