"""The solve programs over static buffers (:mod:`repro_torch.amg.programs`).

On the CPU each program runs its body over the hierarchy's state buffers and
writes its outputs back into them; here that form is held bit-equal to the
eager program methods for all ten programs, float64 and float32, over five
calls each.  Also: the cache keys, the collective log and the launch counts
recorded at capture and added per replay (a stand-in graph object plays the
CUDA graph), the refresh dropping only the Chebyshev programs, and two
threads on one hierarchy serialised by its lock.

The ``cuda``-marked tests run the captured graphs on the card (skipped
where there is none)::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_programs.py
"""
import contextlib
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.amg import SolveOptions  # noqa: E402
from repro_torch.amg.dist_solve import (DistHierarchy, cycle_comm_stats,  # noqa: E402
                                        dist_pcg, dist_solve, dist_vcycle)
from repro_torch.amg.hierarchy import refresh_values, setup  # noqa: E402
from repro_torch.amg.problems import laplace_3d  # noqa: E402
from repro_torch.amg.programs import PROGRAMS, SIGNATURES  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels.spmv import ops  # noqa: E402
from repro_torch.kernels.spmv import spmv as spmv_mod  # noqa: E402

ITERS = 5
OPTS = {torch.float64: SolveOptions(),
        torch.float32: SolveOptions(cycle="W", smoother="chebyshev")}
CASES = [(name, k) for name in PROGRAMS
         for k in ((None,) if not name.endswith("_m") else (1, 3))]


@pytest.fixture(scope="module")
def problem():
    A = laplace_3d(8)
    return A, setup(A, solver="rs", max_coarse=30)


def _build(h, dtype=torch.float64, device="cpu", **kw):
    return DistHierarchy.build(h, 2, 4, dtype=dtype, device=device, **kw)


def _vec(dh, rng, k):
    n = dh.levels[0].A.row_part.n
    return dh.scatter(rng.standard_normal((n,) if k is None else (n, k)))


def _eager_calls(dh, name, k, opts, rng):
    """ITERS calls of ``name``'s eager method, chained as the drivers chain
    the programs; yields, per call, the state each program call leaves."""
    st = {"x": _vec(dh, rng, k), "b": _vec(dh, rng, k)}
    base = name.removesuffix("_m")
    fn = getattr(dh, name)
    if base == "pcg_step":
        st["r"], st["p"], st["rz"], _ = getattr(dh, "pcg_init" + name[8:])(
            st["x"], st["b"], opts)
    start = {n: t.clone() for n, t in st.items()}
    out = []
    for i in range(ITERS):
        if base in ("resid_norm", "vcycle", "pcg_init") and i:
            st["x"], st["b"] = _vec(dh, rng, k), _vec(dh, rng, k)
        ins, outs = SIGNATURES[base]
        got = fn(*(st[n] for n in ins), opts)
        got = got if isinstance(got, tuple) else (got,)
        st.update(zip(outs, got))
        out.append({n: st[n].clone() for n in outs})
        if base in ("resid_norm", "vcycle", "pcg_init"):
            out[-1].update(x=st["x"].clone(), b=st["b"].clone())
    return start, out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name,k", CASES, ids=[f"{n}-k{k}" for n, k in CASES])
def test_static_buffer_program_is_bit_equal_to_eager(problem, name, k, dtype):
    _, h = problem
    dh = _build(h, dtype)
    opts = OPTS[dtype]
    start, want = _eager_calls(dh, name, k, opts, np.random.default_rng(3))
    st = dh.programs.state(k)
    for n, t in start.items():
        st[n].copy_(t)
    prog = dh.programs.get(name, opts, k)
    assert prog.graph is None                   # the CPU runs the body
    for i, w in enumerate(want):
        if "b" in w and i:                      # the next inputs, as eager
            st["x"].copy_(w["x"])
            st["b"].copy_(w["b"])
        prog.run()
        for n, t in w.items():
            assert torch.equal(st[n], t), (i, n)
    assert st["x"].dtype == dtype


def test_cache_keys_separate_opts_width_and_dtype(problem):
    _, h = problem
    dh = _build(h)
    cache = dh.programs
    jac, cheb = SolveOptions(), SolveOptions(smoother="chebyshev")
    keys = {cache.key("pcg_step", jac, None), cache.key("pcg_step", cheb, None),
            cache.key("pcg_step_m", jac, 1), cache.key("pcg_step_m", jac, 3),
            cache.key("pcg_init", jac, None),
            _build(h, torch.float32).programs.key("pcg_step", jac, None)}
    assert len(keys) == 6
    assert cache.get("cycle", jac) is cache.get("cycle", SolveOptions())
    assert cache.get("cycle", jac) is not cache.get("cycle", cheb)
    dh.overlap = False                          # an apply knob the body reads
    assert cache.key("cycle", jac, None) != next(iter(cache.keys()))
    for bad in (("cycle_m", None), ("cycle", 2)):
        with pytest.raises(ValueError, match="width"):
            cache.get(bad[0], jac, bad[1])
    with pytest.raises(ValueError, match="unknown program"):
        cache.get("gmres", jac)
    assert cache.state(3)["x"].shape == (8, dh.levels[0].A.plan.local_n, 3)
    assert cache.state(None)["rnorm"].shape == (8,)


class StandInGraph:
    """Plays a torch.cuda.CUDAGraph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def counted_plain_spmv(monkeypatch):
    """The plain ELL SpMV noting one launch of ``ell_spmv`` per call, as the
    wrapper does where it launches on the card."""
    real = spmv_mod.ell_spmv_ref

    def plain(cols, vals, x):
        launches.note(spmv_mod.ell_spmv)
        return real(cols, vals, x)

    monkeypatch.setattr(spmv_mod, "ell_spmv_ref", plain)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def test_launch_counts_record_at_capture_add_per_replay(problem,
                                                        counted_plain_spmv):
    _, h = problem
    dh = _build(h)
    opts = SolveOptions()
    dh.pcg_step(*(_vec(dh, np.random.default_rng(0), None) for _ in range(3)),
                torch.ones(8, dtype=torch.float64), opts)
    per_call = ops.launch_counts()["ell_spmv"]      # one eager call
    assert per_call > 0
    ops.reset_launch_counts()
    with launches.recording() as tally:
        launches.note(spmv_mod.ell_spmv)
    assert tally[spmv_mod.ell_spmv] == 1 and ops.launch_counts()["ell_spmv"] == 0
    prog = dh.programs.get("pcg_step", opts)
    graph = StandInGraph()
    prog.capture(graph, contextlib.nullcontext())
    # neither the warm-up nor the capture is counted
    assert ops.launch_counts()["ell_spmv"] == 0
    assert prog.launches == {spmv_mod.ell_spmv: per_call}
    for i in range(1, 4):
        prog.run()
        assert graph.replays == prog.replays == i
        assert ops.launch_counts() == {"ell_spmv": i * per_call,
                                       "ell_spmm": 0, "bcsr_spmm": 0}
    # another thread's eager launches count on the wrapper meanwhile
    with launches.recording():
        t = threading.Thread(target=launches.note, args=(spmv_mod.ell_spmv,))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert ops.launch_counts()["ell_spmv"] == 3 * per_call + 1


def test_comm_log_under_replay_equals_eager(problem):
    _, h = problem
    dh = _build(h)
    opts = SolveOptions()
    b = np.random.default_rng(1).standard_normal(h.levels[0].A.nrows)
    dh.comm_log = []
    eager = dist_pcg(dh, b, tol=0.0, maxiter=3, opts=opts)   # CPU: the bodies
    want = list(dh.comm_log)
    assert want
    # the same solve through programs captured into stand-in graphs: their
    # collectives are recorded once, then logged once per replay
    dh2 = _build(h)
    for name in ("pcg_init", "pcg_step"):
        prog = dh2.programs.get(name, opts)
        prog.capture(StandInGraph(), contextlib.nullcontext())
    dh2.comm_log = []
    st = dh2.programs.state(None)
    dh2.load(st["b"], b)
    for name in ["pcg_init"] + ["pcg_step"] * 3:
        dh2.programs.run(name, opts)
    assert dh2.comm_log == want
    assert cycle_comm_stats(dh2, opts) == cycle_comm_stats(dh, opts)
    assert len(eager.residuals) == 4


def test_refresh_drops_only_chebyshev_programs(problem):
    A, _ = problem
    h = setup(A, solver="rs", max_coarse=30)
    dh = _build(h)
    b = np.ones(A.nrows)
    jac, cheb = SolveOptions(), SolveOptions(smoother="chebyshev")
    for opts in (jac, cheb):
        dist_pcg(dh, b, maxiter=2, opts=opts)
        dist_solve(dh, b, maxiter=1, opts=opts)
    dist_vcycle(dh, np.stack([b, b], axis=1), jac)
    before = {k: p for k, p in zip(dh.programs.keys(), dh.programs.values())}
    ptrs = [t.data_ptr() for a in dh._arrs for v in a.values()
            for t in (v.values() if isinstance(v, dict) else (v,))]
    assert {k.smoother for k in before} == {"jacobi", "chebyshev"}
    A2 = A.__class__(A.shape, A.indptr, A.indices, 1.5 * A.data)
    refresh_values(h, A2)
    dh.refresh_values(h.levels)
    kept = dict(zip(dh.programs.keys(), dh.programs.values()))
    assert set(kept) == {k for k in before if k.smoother == "jacobi"}
    assert all(kept[k] is before[k] for k in kept)
    assert ptrs == [t.data_ptr() for a in dh._arrs for v in a.values()
                    for t in (v.values() if isinstance(v, dict) else (v,))]
    assert torch.equal(dh._arrs[0]["A"]["vals"],
                       torch.as_tensor(dh.levels[0].A.ell_vals))
    res = dist_pcg(dh, b, tol=1e-10, opts=cheb)
    assert res.converged
    assert np.abs(A2.matvec(res.x) - b).max() < 1e-8


def test_two_threads_on_one_hierarchy_are_serialised(problem):
    """The programs share static buffers: solves on one hierarchy from
    several threads queue on its lock and each gets its own answer."""
    A, h = problem
    dh = _build(h)
    rng = np.random.default_rng(5)
    bs = [rng.standard_normal(A.nrows) for _ in range(6)]
    want = [dist_pcg(dh, b, tol=1e-10).x for b in bs]
    got = [None] * len(bs)

    def solve(i):
        got[i] = dist_pcg(dh, bs[i], tol=1e-10).x

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=solve, args=(i,))
                   for i in range(len(bs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eager_pcg(dh, b, opts, iters):
    """The PCG history through the eager program bodies."""
    x = dh.scatter(np.zeros_like(b))
    r, p, rz, rn = dh.pcg_init(x, dh.scatter(b), opts)
    hist = [float(rn[0])]
    for _ in range(iters):
        x, r, p, rz, rn = dh.pcg_step(x, r, p, rz, opts)
        hist.append(float(rn[0]))
    return hist, dh.gather(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_is_bit_equal_to_eager_on_the_card(problem, cuda, dtype):
    A, h = problem
    dh = _build(h, dtype, device=cuda)
    b = np.random.default_rng(2).standard_normal(A.nrows)
    opts = SolveOptions()
    hist, x = _eager_pcg(dh, b, opts, 6)
    ops.reset_launch_counts()
    res = dist_pcg(dh, b, tol=0.0, maxiter=6, opts=opts)
    assert res.residuals == hist and np.array_equal(res.x, x)
    assert dh.programs.get("pcg_step", opts).graph is not None
    assert dh.programs.captures[("pcg_step", None)] == 1
    # launches counted per replay: the captured pcg_step's once per step
    step = dh.programs.get("pcg_step", opts).launches
    init = dh.programs.get("pcg_init", opts).launches
    counts = ops.launch_counts()
    for w, name in ((spmv_mod.ell_spmv, "ell_spmv"),):
        assert counts[name] == init[w] + 6 * step[w] > 0
    # again: replays only, no capture
    dist_pcg(dh, b, tol=0.0, maxiter=6, opts=opts)
    assert dh.programs.captures[("pcg_step", None)] == 1


@pytest.mark.cuda
def test_refresh_recaptures_chebyshev_graphs_on_the_card(cuda):
    """A refresh that drops every graph (here all Chebyshev) leaves a cache
    that captures again into a fresh pool."""
    A = laplace_3d(8)
    h = setup(A, solver="rs", max_coarse=30)
    dh = _build(h, device=cuda)
    b = np.ones(A.nrows)
    cheb = SolveOptions(smoother="chebyshev")
    dist_pcg(dh, b, maxiter=3, opts=cheb)
    assert dh.programs.pool_bytes() > 0
    refresh_values(h, A.__class__(A.shape, A.indptr, A.indices, 2.0 * A.data))
    dh.refresh_values(h.levels)
    assert len(dh.programs) == 0
    res = dist_pcg(dh, b, tol=1e-10, opts=cheb)
    assert res.converged and dh.programs.captures[("pcg_step", None)] == 2
    assert np.abs(2.0 * A.matvec(res.x) - b).max() < 1e-8


@pytest.mark.cuda
def test_side_stream_apply_is_bit_equal_to_one_stream(problem, cuda):
    _, h = problem
    dh = _build(h, device=cuda)
    op, arrs = dh.levels[0].A, dh._arrs[0]["A"]
    x = _vec(dh, np.random.default_rng(4), None)
    one = op.apply(arrs, x, overlap=True)
    two = op.apply(arrs, x, overlap=True, side=torch.cuda.Stream(cuda))
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.cuda
def test_capture_from_a_worker_thread(problem, cuda):
    """A worker thread captures while the main thread allocates, launches
    and synchronises its own stream (legal beside a thread-local capture,
    refused beside a global one)."""
    A, h = problem
    dh = _build(h, device=cuda)
    b = np.ones(A.nrows)
    out = {}

    def worker():
        out["res"] = dist_pcg(dh, b, tol=1e-10)

    t = threading.Thread(target=worker)
    own = torch.cuda.Stream(cuda)
    t.start()
    size = 1 << 16
    while t.is_alive():
        with torch.cuda.stream(own):
            y = torch.ones(size, device=cuda) * 2.0
        own.synchronize()
        assert float(y[0]) == 2.0
        size += 4096                  # fresh sizes: new device allocations
        t.join(timeout=0.001)
    t.join(timeout=300)
    assert not t.is_alive() and out["res"].converged
    assert dh.programs.get("pcg_step", SolveOptions()).graph is not None


@pytest.mark.cuda
def test_two_threads_on_one_session_on_the_card(problem, cuda):
    A, h = problem
    dh = _build(h, device=cuda)
    rng = np.random.default_rng(6)
    bs = [rng.standard_normal(A.nrows) for _ in range(4)]
    want = [dist_pcg(dh, b, tol=1e-10).x for b in bs]
    got = [None] * len(bs)
    threads = [threading.Thread(target=lambda i=i: got.__setitem__(
        i, dist_pcg(dh, bs[i], tol=1e-10).x)) for i in range(len(bs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


FAILED_CAPTURE = """
import numpy as np, torch
from repro_torch.amg import SolveOptions
from repro_torch.amg.dist_solve import DistHierarchy
from repro_torch.amg.hierarchy import setup
from repro_torch.amg.problems import laplace_3d

real = DistHierarchy.resid_norm
seen = []

def syncing(self, x, b, o):
    out = real(self, x, b, o)
    if torch.cuda.is_current_stream_capturing():
        seen.append(1)
        float(out[0])                   # a host read: illegal in a capture
    return out

DistHierarchy.resid_norm = syncing
dh = DistHierarchy.build(setup(laplace_3d(8), max_coarse=30), 2, 4,
                         dtype=torch.float64, device="cuda")
try:
    dh.programs.get("resid_norm", SolveOptions())
except RuntimeError as e:
    assert seen and len(dh.programs) == 0, (seen, len(dh.programs))
    print("RAISED", type(e).__name__)
else:
    print("NO ERROR")
"""


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """A capture that fails raises and caches nothing (run in a process of
    its own: a broken capture may leave the context unusable)."""
    import os
    import pathlib
    import subprocess

    env = dict(os.environ)
    src = str(pathlib.Path(__file__).parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", FAILED_CAPTURE],
                         capture_output=True, text=True, env=env, timeout=300)
    assert "RAISED" in out.stdout, (out.stdout, out.stderr[-2000:])
