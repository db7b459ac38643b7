"""The slice as a whole: a dist-born session of the port
(``AMGConfig(backend="torch", setup_backend="dist", device="cpu")``, f64)
against the reference's dist-born JAX session
(``AMGConfig(setup_backend="dist", backend="dist")``) on ``laplace_3d(8)``,
a 2×4 mesh of 8 host devices, x64 on.  Each side runs its own partitioned
setup from the same matrix.

* ``born_partitioned``: no host hierarchy on either side, and the port's
  lowering bit-equal to the reference's ``from_partitioned`` lowering
  (ELL arrays, ``dinv``, ``coarse_inv``), with the same selection table and
  setup records (but their wall-clock seconds);
* residual histories ≤ 1e-7 of r0 for PCG and the stationary solve, V/W/F,
  Jacobi and Chebyshev, k = 1 and k = 3, through the session API; again
  after both sides ``update()`` with the reference suite's ``_drift``;
* ``setup_selection`` and ``session_cache`` as the reference's
  ``tests/dist_setup_script.py`` checks them.

The JAX side needs 8 host devices set before jax is imported, so it runs
once per module as a subprocess of this very file::

    python tests/test_torch_dist_born.py --jax-ref OUT.npz

The ``cuda``-marked tests hold a dist-born session on the card against the
host-setup session's lowering, its replayed graphs against the eager
bodies, and its setup audit.
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
# (method, cycle, smoother, k): every cycle with both smoothers, both
# methods and both widths
CASES = [
    ("pcg", "V", "jacobi", 1),
    ("pcg", "W", "chebyshev", 3),
    ("pcg", "F", "jacobi", 1),
    ("pcg", "F", "chebyshev", 3),
    ("solve", "V", "chebyshev", 1),
    ("solve", "W", "jacobi", 3),
    ("solve", "F", "chebyshev", 1),
    ("solve", "V", "jacobi", 3),
]
# after the drift update, through the refreshed lowering
REFRESH_CASES = [
    ("pcg", "V", "jacobi", 1),
    ("pcg", "W", "chebyshev", 3),
    ("solve", "F", "jacobi", 3),
]
LOWERED = ("ell_cols", "ell_vals", "on_cols", "on_vals", "off_cols",
           "off_vals")
RECORD_FIELDS = ("level", "inter_msgs", "intra_msgs", "inter_bytes",
                 "intra_bytes", "n_halo_rows", "on_nnz", "off_nnz")


def _case_id(case):
    return "-".join(map(str, case))


def _problem(pkg):
    """laplace_3d(N), its [n, 3] right-hand side and the drifted values
    (tests/test_streaming.py:_drift, scale 0.03, seed 1), from ``pkg``'s
    own CSR and problem modules."""
    A = pkg.problems.laplace_3d(N)
    rng = np.random.default_rng(11)
    B = np.stack([A.matvec(np.ones(A.nrows))]
                 + [rng.standard_normal(A.nrows) for _ in range(2)], axis=1)
    drift = np.random.default_rng(1)
    data = A.data * (1.0 + 0.03 * drift.random(A.nnz))
    At = pkg.csr.CSR(A.shape, A.indptr.copy(), A.indices.copy(), data).T
    return A, B, 0.5 * (data + At.data) - A.data


def _run_session(bound, case, B):
    method, _, _, k = case
    b = B[:, 0] if k == 1 else B[:, :k]
    res = getattr(bound, method)(b, tol=0.0, maxiter=ITERS)
    if k == 1:
        return [np.asarray(res.residuals)]
    return [np.asarray(c.residuals) for c in res.columns]


def _run_dist(dh, fns, opts_cls, case, B):
    method, cycle, smoother, k = case
    b = B[:, 0] if k == 1 else B[:, :k]
    res = fns[method](dh, b, tol=0.0, maxiter=ITERS,
                      opts=opts_cls(cycle=cycle, smoother=smoother))
    if k == 1:
        return [np.asarray(res.residuals)]
    return [np.asarray(c.residuals) for c in res.columns]


def _session_side(pkg, cfg, solve_mod):
    """Everything both sides record, in the same order: the lowering, the
    selection table and records, the session cache's sharing, the case
    histories, the update and the refreshed histories."""
    A, B, delta = _problem(pkg)
    out = {}
    bound = pkg.AMGSolver(cfg).setup(A)
    dh = bound.dist_hierarchy
    out["born_partitioned"] = np.array(
        [bound.hierarchy is None, dh.h is None, bound.n == A.nrows])
    for l, dl in enumerate(dh.levels):
        for op in ("A", "P", "R"):
            dop = getattr(dl, op)
            if dop is not None:
                for f in LOWERED:       # copies: the update rewrites them
                    out[f"low_L{l}_{op}_{f}"] = np.array(getattr(dop, f))
                out[f"low_L{l}_{op}_strategy"] = np.array(dop.strategy)
        out[f"low_L{l}_dinv"] = np.array(dl.dinv)
        if dl.coarse_inv is not None:
            out[f"low_L{l}_cinv"] = np.array(dl.coarse_inv)
    rows = dh.selection_table()
    out["sel"] = np.array([f"{r['level']}:{r['op']}:{r['strategy']}"
                           for r in rows])
    out["sel_ok"] = np.array([r["modeled"][r["strategy"]]
                              == min(r["modeled"].values())
                              for r in rows if r["op"].startswith("spgemm")])
    out["records"] = np.array([[getattr(r, f) for f in RECORD_FIELDS]
                               for r in dh.setup_records], dtype=np.float64)
    out["record_ops"] = np.array([f"{r.op}:{r.strategy}"
                                  for r in dh.setup_records])
    # session cache: same (matrix, config) → same bound solver; solve knobs
    # share the lowering; a dtype-only change re-lowers but must not re-run
    # the partitioned setup loop
    calls = []
    orig = pkg.dist_setup.dist_setup_partitioned
    pkg.dist_setup.dist_setup_partitioned = \
        lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        bound2 = pkg.AMGSolver(cfg.replace(maxiter=7)).setup(A)
        bound32 = pkg.AMGSolver(cfg.replace(dtype="float32")).setup(A)
    finally:
        pkg.dist_setup.dist_setup_partitioned = orig
    out["session_cache"] = np.array([
        pkg.AMGSolver(cfg).setup(A) is bound, bound2 is not bound,
        bound2.dist_hierarchy is dh, bound32.dist_hierarchy is not dh,
        not calls])
    for i, case in enumerate(CASES):
        opts = pkg.SolveOptions(cycle=case[1], smoother=case[2])
        bc = pkg.AMGSolver(cfg.replace(opts=opts)).setup(A)
        out[f"case{i}_shares"] = np.array(bc.dist_hierarchy is dh)
        for j, hist in enumerate(_run_session(bc, case, B)):
            out[f"case{i}_col{j}"] = hist
    out["update"] = np.array(bound.update(delta=delta))
    fns = {"pcg": solve_mod.dist_pcg, "solve": solve_mod.dist_solve}
    for i, case in enumerate(REFRESH_CASES):
        for j, hist in enumerate(_run_dist(bound.dist_hierarchy, fns,
                                           pkg.SolveOptions, case, B)):
            out[f"refresh{i}_col{j}"] = hist
    return out


class _Pkg:
    """One package's modules under the names :func:`_session_side` uses."""

    def __init__(self, root):
        import importlib
        amg = importlib.import_module(root + ".amg")
        self.AMGSolver = amg.AMGSolver
        self.SolveOptions = amg.SolveOptions
        self.problems = importlib.import_module(root + ".amg.problems")
        self.csr = importlib.import_module(root + ".amg.csr")
        self.dist_setup = importlib.import_module(root + ".amg.dist_setup")


# --------------------------------------------------------------- JAX side
def _jax_reference(out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.amg import AMGConfig
    from repro.amg import dist_solve

    cfg = AMGConfig(setup_backend="dist", backend="dist", n_pods=N_PODS,
                    lanes=LANES, dtype="float64", max_coarse=MAX_COARSE)
    np.savez(out_path, **_session_side(_Pkg("repro"), cfg, dist_solve))


# ------------------------------------------------------------- port side
torch = pytest.importorskip("torch") if __name__ != "__main__" else None


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    from repro_torch.amg import AMGConfig
    from repro_torch.amg import dist_solve
    from repro_torch.amg.api import clear_sessions

    out_path = tmp_path_factory.mktemp("jax_ref") / "out.npz"
    env = dict(os.environ)
    root = pathlib.Path(__file__).parents[1]
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, __file__, "--jax-ref", str(out_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        # a fresh session store, as the reference's subprocess has: sessions
        # on the same matrix share their levels, so another test file's
        # update in this process would be seen here (ROADMAP queue 3)
        clear_sessions()
        cfg = AMGConfig(backend="torch", setup_backend="dist", n_pods=N_PODS,
                        lanes=LANES, dtype="float64", device="cpu",
                        max_coarse=MAX_COARSE)
        port = _session_side(_Pkg("repro_torch"), cfg, dist_solve)
    finally:
        stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    return port, dict(np.load(out_path))


def test_born_partitioned_lowering_matches_jax(shared):
    """OK born_partitioned: no host hierarchy on either side, and the port's
    lowering of its own partitioned setup is bit-equal to the reference's
    ``from_partitioned`` lowering of its own."""
    port, ref = shared
    assert port["born_partitioned"].all() and ref["born_partitioned"].all()
    low = sorted(k for k in ref if k.startswith("low_"))
    assert low and sorted(k for k in port if k.startswith("low_")) == low
    for k in low:
        assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape, k
        assert np.array_equal(port[k], ref[k]), k


def test_setup_selection_matches_jax(shared):
    """OK setup_selection: every coarsening level recorded both Galerkin
    SpGEMM selections (each the modeled minimum), and the selection table
    and measured exchange counters equal the reference's."""
    port, ref = shared
    sel = list(port["sel"])
    assert sel == list(ref["sel"])
    levels = {int(s.split(":")[0]) for s in sel}
    for l in range(len(levels) - 1):
        for op in ("spgemm_AP", "spgemm_PtAP"):
            assert any(s.startswith(f"{l}:{op}:") for s in sel), (l, op)
    assert port["sel_ok"].all() and port["sel_ok"].size >= 2
    assert list(port["record_ops"]) == list(ref["record_ops"])
    assert np.array_equal(port["records"], ref["records"])


def test_session_cache_matches_jax(shared):
    """OK session_cache: the same sharing on both sides (a solve-knob change
    shares the lowering; a dtype-only change re-lowers without re-running
    the partitioned setup loop)."""
    port, ref = shared
    assert port["session_cache"].all()
    assert np.array_equal(port["session_cache"], ref["session_cache"])
    assert all(port[f"case{i}_shares"] for i in range(len(CASES)))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_residual_histories_match_jax_dist_born(shared, i):
    port, ref = shared
    k = CASES[i][3]
    for j in range(k):
        got, want = port[f"case{i}_col{j}"], ref[f"case{i}_col{j}"]
        assert got.shape == want.shape == (ITERS + 1,)
        assert np.abs(got - want).max() / want[0] <= TOL, j
        assert got[-1] < got[0]


def test_refreshed_histories_match_jax_dist_born(shared):
    """Both sides ``update(delta=ΔA)``: a refresh through the cached NAP
    schedules, then the same histories again."""
    port, ref = shared
    assert str(port["update"]) == str(ref["update"]) == "refresh"
    for i, case in enumerate(REFRESH_CASES):
        for j in range(case[3]):
            got, want = port[f"refresh{i}_col{j}"], ref[f"refresh{i}_col{j}"]
            assert got.shape == want.shape == (ITERS + 1,)
            assert np.abs(got - want).max() / want[0] <= TOL, (i, j)


def test_dist_born_session_has_no_global_csr():
    """``bound.A`` refuses (no global fine-grid CSR exists), each rank's
    block holds only its own rows, the store counts the lowering's bytes,
    and a refresh without the partitioned levels escalates to a re-setup."""
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.api import SessionStore, session_nbytes
    from repro_torch.amg.problems import laplace_3d

    A = laplace_3d(6)
    cfg = AMGConfig(backend="torch", setup_backend="dist", n_pods=N_PODS,
                    lanes=LANES, dtype="float64", device="cpu")
    store, setups = SessionStore(), SessionStore()
    bound = AMGSolver(cfg, store=store, setup_store=setups).setup(A)
    with pytest.raises(ValueError, match="setup_backend='dist'"):
        bound.A
    assert bound.hierarchy is None and bound.n == A.nrows
    for lv in bound._plevels:
        for blk, (lo, hi) in zip(lv.A.blocks, (lv.A.part.local_range(d)
                                               for d in range(N_PODS * LANES))):
            rows = np.flatnonzero(np.diff(blk.indptr))
            assert rows.min() >= lo and rows.max() < hi
    assert session_nbytes(bound) == bound.dist_hierarchy.nbytes > 0
    b = np.ones(A.nrows)
    assert bound.pcg(b).converged
    bound._plevels = None                      # as if evicted
    assert bound.update(data=2.0 * A.data) == "resetup"
    assert bound.last_update_reason == "evicted"
    res = bound.pcg(b, tol=1e-10)
    assert res.converged
    assert np.abs(2.0 * A.matvec(res.x) - b).max() < 1e-8


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_sessions(cuda, n=16):
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.api import SessionStore
    from repro_torch.amg.problems import laplace_3d

    A = laplace_3d(n)
    cfg = AMGConfig(backend="torch", setup_backend="dist", n_pods=N_PODS,
                    lanes=LANES, dtype="float64", device=str(cuda))
    kw = dict(store=SessionStore(), setup_store=SessionStore())
    born = AMGSolver(cfg, **kw).setup(A)
    host = AMGSolver(cfg.replace(setup_backend="host"), **kw).setup(A)
    return A, born, host


@pytest.mark.cuda
def test_dist_born_lowering_equals_host_setup_on_the_card(cuda):
    A, born, host = _card_sessions(cuda)
    dh, dh_host = born.dist_hierarchy, host.dist_hierarchy
    assert born.hierarchy is None and dh.device.type == "cuda"
    assert dh.kernel_table() == dh_host.kernel_table()
    for a, c, ta, tc in zip(dh.levels, dh_host.levels, dh._arrs,
                            dh_host._arrs):
        for op in ("A", "P", "R"):
            if getattr(a, op) is None:
                continue
            assert np.array_equal(getattr(a, op).ell_cols,
                                  getattr(c, op).ell_cols)
            for name in ("on_cols", "off_cols"):
                assert torch.equal(ta[op][name], tc[op][name])
            for name in ("on_vals", "off_vals"):
                assert (ta[op][name] - tc[op][name]).abs().max() <= 1e-12
        assert (ta["dinv"] - tc["dinv"]).abs().max() <= 1e-12
    b = np.random.default_rng(0).standard_normal(A.nrows)
    r, rh = born.pcg(b), host.pcg(b)
    assert r.iterations == rh.iterations
    assert np.abs(np.subtract(r.residuals, rh.residuals)).max() \
        <= TOL * rh.residuals[0]


@pytest.mark.cuda
def test_dist_born_graphs_are_bit_equal_to_eager_on_the_card(cuda):
    from repro_torch.amg.solve import SolveOptions

    A, born, _ = _card_sessions(cuda)
    dh = born.dist_hierarchy
    b = np.random.default_rng(2).standard_normal(A.nrows)
    opts = SolveOptions()
    x = dh.scatter(np.zeros_like(b))
    r, p, rz, rn = dh.pcg_init(x, dh.scatter(b), opts)
    hist = [float(rn[0])]
    for _ in range(6):
        x, r, p, rz, rn = dh.pcg_step(x, r, p, rz, opts)
        hist.append(float(rn[0]))
    res = born.pcg(b, tol=0.0, maxiter=6)
    assert res.residuals == hist
    assert np.array_equal(res.x, dh.gather(x))
    assert dh.programs.get("pcg_step", opts).graph is not None


@pytest.mark.cuda
def test_dist_born_setup_audit_on_the_card(cuda):
    from repro_torch.analysis import audit_captured, audit_setup

    A, born, _ = _card_sessions(cuda)
    rows, violations = audit_setup(born._plevels,
                                   born.dist_hierarchy.setup_records)
    assert rows and violations == [], [str(v) for v in violations]
    born.pcg(np.ones(A.nrows))
    assert all(a.ok for a in audit_captured(born.dist_hierarchy))
    assert born.update(data=1.01 * A.data) == "refresh"
    assert born.pcg(np.ones(A.nrows)).converged


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "--jax-ref":
        sys.exit("usage: test_torch_dist_born.py --jax-ref OUT.npz")
    _jax_reference(sys.argv[2])
