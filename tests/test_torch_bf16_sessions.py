"""bfloat16 sessions as a whole: the port's distributed solve in bfloat16 on
the CPU against the reference's bfloat16 ``backend="dist"`` path on a 2×4
mesh of 8 host devices, both fed the identical hierarchy through
:mod:`repro_torch.convert` (``laplace_3d(8)``, 3 levels).

* The lowering is bit-equal: every bfloat16 value plane (ELL, its on/off
  split, BCSR blocks), ``dinv``, ``cinv``, the Chebyshev bound ρ and the
  block-Jacobi factor (the port's bs×bs block inverses against the
  diagonal blocks of the reference's dense ``smoother_minv("bj", 4)`` in
  bfloat16: both the float64 inverse of the same blocks, rounded once),
  for strategy auto and nap3.
* PCG to 1e-5 over V/W/F × Jacobi/Chebyshev × k = 1 and 3, overlap on and
  off, strategy auto and nap3, and with the block smoothers
  (``block_jacobi``, ``hybrid_gs``, ``hybrid_gs_sym``): iterations within
  ±1 of the reference's, |log(r_i / r_i^ref)| ≤ 0.6 at every common i,
  and the float64 true residual of the returned x within 2× of the
  reference's (where the reference's own session stops short of 1e-5 in
  MAXITER, the log bar over the common iterations and the true residual).
* The stationary solve, 10 fixed iterations, with the same log bar
  (Jacobi, Chebyshev and ``hybrid_gs_sym``).
* The same after both sides refresh their lowering with the drift of
  ``tests/test_torch_dist_solve.py`` (``hybrid_gs_sym`` among them), and
  for a dist-born session (``setup_backend="dist"``, Jacobi and
  ``hybrid_gs_sym``) through the session API.

Why those bars: the reference's Pallas kernels sum a row in bfloat16, the
port's in float32 rounded once, so the two cannot be bit-equal; the
reference's own bf16-against-f32 histories differ by up to 0.29 in
|log(r_i^bf16 / r_i^f32)| at laplace_3d(12), and 0.6 is twice that.

Port-only checks in bfloat16: every halo is bit-equal to ``x[need]``, every
apply's and program's collective log equals the signature the selected
strategies predict, the layout choice per level equals float32's, and the
refused combinations name their ROADMAP items.

The JAX side needs 8 host devices set before jax is imported, so it runs
once per module as two subprocesses of this very file, each compiling half
of the reference's programs, while the port's side runs beside them::

    python tests/test_torch_bf16_sessions.py --jax-ref OUT.npz IN.npz PART
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
TOL = 1e-5
MAXITER = 40
STATIONARY_ITERS = 10
LOG_BAR = 0.6         # |log(r_i / r_i^ref)|: twice the reference's own
                      # bf16-against-f32 gap (0.29)
ITER_SLACK = 1
TRUE_RATIO = 2.0
STRATEGIES = ("auto", "nap3")
# (method, cycle, smoother, k, overlap, strategy): PCG over every cycle,
# smoother and width, each overlap and strategy with both widths
CASES = [
    ("pcg", "V", "jacobi", 1, True, "auto"),
    ("pcg", "V", "jacobi", 3, False, "nap3"),
    ("pcg", "V", "chebyshev", 1, False, "auto"),
    ("pcg", "V", "chebyshev", 3, True, "nap3"),
    ("pcg", "W", "jacobi", 1, True, "nap3"),
    ("pcg", "W", "jacobi", 3, False, "auto"),
    ("pcg", "W", "chebyshev", 1, False, "nap3"),
    ("pcg", "W", "chebyshev", 3, True, "auto"),
    ("pcg", "F", "jacobi", 1, False, "auto"),
    ("pcg", "F", "jacobi", 3, True, "nap3"),
    ("pcg", "F", "chebyshev", 1, True, "nap3"),
    ("pcg", "F", "chebyshev", 3, False, "auto"),
    ("solve", "V", "jacobi", 1, True, "auto"),
    ("solve", "W", "chebyshev", 3, False, "nap3"),
    ("solve", "F", "jacobi", 3, True, "auto"),
    ("pcg", "V", "block_jacobi", 1, True, "auto"),
    ("pcg", "V", "hybrid_gs", 3, False, "nap3"),
    ("pcg", "W", "hybrid_gs_sym", 1, True, "nap3"),
    ("solve", "V", "hybrid_gs_sym", 1, False, "auto"),
]
# after the refresh (strategy auto, overlap on)
REFRESH_CASES = [
    ("pcg", "V", "chebyshev", 1, True, "auto"),
    ("pcg", "W", "jacobi", 3, True, "auto"),
    ("pcg", "F", "hybrid_gs_sym", 1, True, "auto"),
]
# the dist-born sessions' smoothers (PCG, V, one RHS)
BORN_SMOOTHERS = ("jacobi", "hybrid_gs_sym")
VALUE_PLANES = ("vals", "on_vals", "off_vals", "bvals", "on_bvals")
BJ_SIZE = 4           # block_jacobi's block size (SolveOptions' default)


def _case_id(case):
    return "-".join(map(str, case))


def _inputs():
    """The problem both sides solve: the port's setup of laplace_3d(N)
    (bit-identical to the reference's), a [n, 3] right-hand side, and the
    refreshed levels of tests/test_torch_dist_solve.py's drift."""
    from repro_torch.amg.csr import CSR
    from repro_torch.amg.hierarchy import refresh_values, setup
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.convert import hierarchy_to_arrays

    A = laplace_3d(N)
    h = setup(A, solver="rs", max_coarse=MAX_COARSE)
    rng = np.random.default_rng(11)
    # column 0 is A·v for a v that bfloat16 cannot hold exactly (A·ones
    # would let a stationary solve land on x = ones and a residual of 0)
    B = np.stack([A.matvec(1.0 + 0.5 * rng.random(A.nrows))]
                 + [rng.standard_normal(A.nrows) for _ in range(2)], axis=1)
    drift = np.random.default_rng(1)
    data = A.data * (1.0 + 0.03 * drift.random(A.nnz))
    At = CSR(A.shape, A.indptr.copy(), A.indices.copy(), data).T
    h_new = setup(A, solver="rs", max_coarse=MAX_COARSE)
    refresh_values(h_new, CSR(A.shape, A.indptr.copy(), A.indices.copy(),
                              0.5 * (data + At.data)))
    return {**hierarchy_to_arrays(h), "B": B,
            **{"new_" + k: v for k, v in hierarchy_to_arrays(h_new).items()}}


def _refreshed(d):
    return {k[4:]: d[k] for k in d if k.startswith("new_")}


def _true_residual(A, b, x):
    """‖b − A x‖ / ‖b‖ in float64 of the returned x, per column."""
    x = np.asarray(x, dtype=np.float64).reshape(b.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    r = b - np.stack([A.matvec(x[:, j]) for j in range(x.shape[1])], axis=1)
    return np.linalg.norm(r, axis=0) / np.linalg.norm(b, axis=0)


def _record(out, key, res, k, A, b):
    """A result's per-column histories, iterations and true residuals."""
    cols = [res] if k == 1 else list(res.columns)
    for j, c in enumerate(cols):
        out[f"{key}_col{j}"] = np.asarray(c.residuals, dtype=np.float64)
        out[f"{key}_it{j}"] = np.array(int(c.iterations))
    out[f"{key}_true"] = _true_residual(A, b, res.x)


def _run(dh, fns, opts_cls, case, B, out, key, A):
    method, cycle, smoother, k, overlap, _ = case
    dh.overlap = overlap
    opts = opts_cls(cycle=cycle, smoother=smoother)
    b = B[:, 0] if k == 1 else B[:, :k]
    if method == "pcg":
        res = fns["pcg"](dh, b, tol=TOL, maxiter=MAXITER, opts=opts)
    else:
        res = fns["solve"](dh, b, tol=0.0, maxiter=STATIONARY_ITERS, opts=opts)
    _record(out, key, res, k, A, b)


# what each of the two reference subprocesses records: part 0 the lowering,
# the even cases and the refresh, part 1 the odd cases and the dist-born
# session; the port's side records all of it (part None)
PARTS = (0, 1)


def _bj_blocks(dh, level, binv_of):
    """Level ``level``'s block-Jacobi factor as ``[D, nb, bs, bs]`` float32
    (bs = BJ_SIZE), the entries past the level's rows zero: ``binv_of(dh,
    level)`` gives the port's block inverses or the reference's dense
    ``[D, m, m]`` factor, whose diagonal blocks are cut out."""
    f = np.asarray(binv_of(dh, level), dtype=np.float32)
    m = dh.levels[level].A.rows_local
    nb, bs = -(-m // BJ_SIZE), BJ_SIZE
    out = np.zeros((f.shape[0], nb, bs, bs), dtype=np.float32)
    for b in range(nb):
        n = min(bs, m - b * bs)
        src = (f[:, b, :n, :n] if f.ndim == 4 else
               f[:, b * bs:b * bs + n, b * bs:b * bs + n])
        out[:, b, :n, :n] = src
    return out


def _side(h, h_new, B, build, fns, opts_cls, to_np, born, binv_of,
          part=None):
    """Everything both sides record, under the same keys: the lowering of
    each strategy (with the block-Jacobi factor, ``binv_of``), every case,
    the refreshed cases and the dist-born sessions (``born(A, b,
    smoother)`` → its result); ``part`` picks a share."""
    out = {}
    A = h.levels[0].A
    built = {s: build(h, s) for s in STRATEGIES}
    for s, dh in built.items():
        if part == 1:
            break
        for l, (dl, a) in enumerate(zip(dh.levels, dh._arrs)):
            for op in ("A", "P", "R"):
                for name in VALUE_PLANES:
                    if op in a and name in a[op]:
                        out[f"low_{s}_L{l}_{op}_{name}"] = to_np(a[op][name])
            out[f"low_{s}_L{l}_dinv"] = to_np(a["dinv"])
            if "cinv" in a:
                out[f"low_{s}_L{l}_cinv"] = to_np(a["cinv"])
            out[f"low_{s}_L{l}_rho"] = np.array(float(dl.rho))
            if "cinv" not in a:
                out[f"low_{s}_L{l}_binv"] = _bj_blocks(dh, l, binv_of)
    for i, case in enumerate(CASES):
        if part is None or i % 2 == part:
            _run(built[case[5]], fns, opts_cls, case, B, out, f"case{i}", A)
    if part != 1:
        dh = built["auto"]
        dh.refresh_values(h_new.levels)
        for i, case in enumerate(REFRESH_CASES):
            _run(dh, fns, opts_cls, case, B, out, f"refresh{i}",
                 h_new.levels[0].A)
    if part != 0:
        for sm in BORN_SMOOTHERS:
            _record(out, f"born_{sm}", born(A, B[:, 0], sm), 1, A, B[:, 0])
    return out


# --------------------------------------------------------------- JAX side
def _jax_reference(out_path, in_path, part):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax.numpy as jnp

    from repro.amg import AMGConfig, AMGSolver
    from repro.amg.csr import CSR
    from repro.amg.dist_solve import DistHierarchy, dist_pcg, dist_solve
    from repro.amg.hierarchy import Hierarchy, Level
    from repro.amg.solve import SolveOptions

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

    def born(A, b, smoother):
        cfg = AMGConfig(backend="dist", setup_backend="dist", n_pods=N_PODS,
                        lanes=LANES, dtype="bfloat16", max_coarse=MAX_COARSE,
                        tol=TOL, pcg_maxiter=MAXITER,
                        opts=SolveOptions(smoother=smoother))
        return AMGSolver(cfg).setup(A).pcg(b)

    def binv_of(dh, level):
        # the dense factor the reference's run_arrays places, in bfloat16
        minv = dh.levels[level].smoother_minv("bj", BJ_SIZE)
        return minv.astype(jnp.bfloat16).astype(np.float32)

    d = dict(np.load(in_path))
    out = _side(hierarchy(d), hierarchy(_refreshed(d)), d["B"],
                lambda h, s: DistHierarchy.build(h, N_PODS, LANES, strategy=s,
                                                 dtype=jnp.bfloat16),
                {"pcg": dist_pcg, "solve": dist_solve}, SolveOptions,
                lambda a: np.asarray(a).astype(np.float32), born, binv_of,
                part)
    np.savez(out_path, **out)


# ------------------------------------------------------------- port side
torch = pytest.importorskip("torch") if __name__ != "__main__" else None


def _port_side(inputs):
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.api import clear_sessions
    from repro_torch.amg.dist_solve import DistHierarchy, dist_pcg, dist_solve
    from repro_torch.amg.solve import SolveOptions
    from repro_torch.convert import hierarchy_from_arrays

    def born(A, b, smoother):
        # a fresh session store: sessions on one matrix share their levels
        clear_sessions()
        cfg = AMGConfig(backend="torch", setup_backend="dist", n_pods=N_PODS,
                        lanes=LANES, dtype="bfloat16", device="cpu",
                        max_coarse=MAX_COARSE, tol=TOL, pcg_maxiter=MAXITER,
                        opts=SolveOptions(smoother=smoother))
        return AMGSolver(cfg).setup(A).pcg(b)

    def binv_of(dh, level):
        return dh._factor(level, "bj", BJ_SIZE).binv.float().numpy()

    return _side(hierarchy_from_arrays(inputs),
                 hierarchy_from_arrays(_refreshed(inputs)), inputs["B"],
                 lambda h, s: DistHierarchy.build(
                     h, N_PODS, LANES, strategy=s, dtype=torch.bfloat16,
                     device="cpu"),
                 {"pcg": dist_pcg, "solve": dist_solve}, SolveOptions,
                 lambda t: t.float().numpy(), born, binv_of)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_ref")
    inputs = _inputs()
    in_path = tmp / "in.npz"
    np.savez(in_path, **inputs)
    env = dict(os.environ)
    root = pathlib.Path(__file__).parents[1]
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    procs = [(tmp / f"out{p}.npz", subprocess.Popen(
        [sys.executable, __file__, "--jax-ref", str(tmp / f"out{p}.npz"),
         str(in_path), str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
        for p in PARTS]
    ref = {}
    try:
        port = _port_side(inputs)
    finally:
        for out_path, proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, \
                f"stdout:\n{stdout}\nstderr:\n{stderr}"
            ref.update(np.load(out_path))
    return port, ref


def _check_runs(port, ref, key, k, pcg=True):
    """The module's bars; a PCG column the reference's own session did
    not bring to TOL within MAXITER is held to the log bar over the common
    iterations (and the true residual) only."""
    for j in range(k):
        got, want = port[f"{key}_col{j}"], ref[f"{key}_col{j}"]
        assert np.isfinite(got).all() and got[-1] < got[0]
        if pcg and want[-1] / want[0] < TOL:
            it, it_ref = int(port[f"{key}_it{j}"]), int(ref[f"{key}_it{j}"])
            assert abs(it - it_ref) <= ITER_SLACK, (j, it, it_ref)
            assert got[-1] / got[0] < TOL
        n = min(got.size, want.size)
        gap = np.abs(np.log(got[:n] / want[:n])).max()
        assert gap <= LOG_BAR, (j, gap)
    ratio = port[f"{key}_true"] / ref[f"{key}_true"]
    assert ((ratio <= TRUE_RATIO) & (ratio >= 1 / TRUE_RATIO)).all(), ratio


def test_lowering_is_bit_equal_to_jax_bf16(shared):
    """Every bfloat16 value plane, dinv and cinv of both strategies' lowering
    equals the reference's bit for bit (float64 → bfloat16 rounds the same
    way on both sides), and so do ρ and the block-Jacobi factor of every
    level that smooths."""
    port, ref = shared
    low = sorted(k for k in ref if k.startswith("low_"))
    assert low and sorted(k for k in port if k.startswith("low_")) == low
    assert any("bvals" in k for k in low)          # a BCSR level among them
    assert sum(k.endswith("_binv") for k in low) == 2 * (
        sum(k.endswith("_dinv") for k in low) // 2 - 1)
    for k in low:
        assert port[k].shape == ref[k].shape, k
        assert np.array_equal(port[k], ref[k]), k


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_histories_match_jax_bf16(shared, i):
    port, ref = shared
    case = CASES[i]
    _check_runs(port, ref, f"case{i}", case[3], pcg=case[0] == "pcg")


@pytest.mark.parametrize("i", range(len(REFRESH_CASES)),
                         ids=[_case_id(c) for c in REFRESH_CASES])
def test_refreshed_histories_match_jax_bf16(shared, i):
    port, ref = shared
    _check_runs(port, ref, f"refresh{i}", REFRESH_CASES[i][3])


def test_dist_born_session_matches_jax_bf16(shared):
    port, ref = shared
    _check_runs(port, ref, "born_jacobi", 1)


def test_dist_born_block_smoother_session_matches_jax_bf16(shared):
    port, ref = shared
    _check_runs(port, ref, "born_hybrid_gs_sym", 1)


# ---------------------------------------------------------- port alone
@pytest.fixture(scope="module")
def port_bf16():
    from repro_torch.amg.dist_solve import DistHierarchy
    from repro_torch.amg.hierarchy import setup
    from repro_torch.amg.problems import laplace_3d

    h = setup(laplace_3d(N), solver="rs", max_coarse=MAX_COARSE)
    return h, {s: DistHierarchy.build(h, N_PODS, LANES, strategy=s,
                                      dtype=torch.bfloat16, device="cpu")
               for s in ("standard", "nap2", "nap3", "auto")}


@pytest.mark.parametrize("strategy", ["standard", "nap2", "nap3"])
@pytest.mark.parametrize("k", [None, 3])
def test_bf16_halos_are_x_of_need(port_bf16, strategy, k):
    """Each operator's halo exchange on bfloat16 data is pure index work:
    rank d's halo is ``x[need[d]]`` bit for bit (zeros past it)."""
    from repro_torch.amg.dist import rect_vector_graph
    from repro_torch.core.nap_collectives import halo_exchange

    h, built = port_bf16
    dh = built[strategy]
    rng = np.random.default_rng(3)
    for l, (dl, a) in enumerate(zip(dh.levels, dh._arrs)):
        lv = h.levels[l]
        for op, M in (("A", lv.A), ("P", lv.P), ("R", lv.R)):
            dop = getattr(dl, op)
            if dop is None or dop.halo_empty:
                continue
            n = dop.col_part.n
            x = rng.standard_normal((n,) + (() if k is None else (k,)))
            xb = torch.as_tensor(x).to(torch.bfloat16)
            xs = torch.as_tensor(dop.scatter_x(xb.float().numpy())).to(
                torch.bfloat16)
            arrs = a[op]
            halo = halo_exchange(xs, dop.plan, arrs["send"], arrs["recv"],
                                 arrs["psel"] if dop.plan.pool_sel is not None
                                 else None)
            assert halo.dtype == torch.bfloat16
            graph = rect_vector_graph(M, dop.row_part, dop.col_part)
            for d in range(N_PODS * LANES):
                need = np.sort(graph.need[d])
                assert torch.equal(halo[d, :need.size], xb[need]), (l, op, d)
                assert not halo[d, need.size:].any()


def test_bf16_collective_logs_follow_the_signatures(port_bf16):
    """Every apply of every level's A/P/R logs its plan's halo signature,
    and every program its expected collective counts, in bfloat16."""
    from collections import Counter

    from repro_torch.amg.solve import SolveOptions
    from repro_torch.core.nap_collectives import halo_signature

    _, built = port_bf16
    dh = built["auto"]
    for l, dl in enumerate(dh.levels):
        for op in ("A", "P", "R"):
            dop = getattr(dl, op)
            if dop is None:
                continue
            want = [] if dop.halo_empty else list(halo_signature(dop.plan))
            assert dh.trace_apply(l, op) == want, (l, op)
            assert dh.trace_apply(l, op, k=3) == want, (l, op)
    for smoother in ("jacobi", "chebyshev"):
        opts = SolveOptions(cycle="W", smoother=smoother)
        for name in ("resid_norm", "cycle", "vcycle", "pcg_init", "pcg_step",
                     "pcg_step_m"):
            got = Counter(dh.trace_program(name, opts))
            assert dict(got) == dh.expected_collectives(opts, name), name


def test_bf16_layouts_are_float32s(port_bf16):
    """The per-level ELL/BCSR choice reads only the pattern, so a bfloat16
    lowering picks what a float32 one picks (as in the reference)."""
    from repro_torch.amg.dist_solve import DistHierarchy

    h, built = port_bf16
    f32 = DistHierarchy.build(h, N_PODS, LANES, dtype=torch.float32,
                              device="cpu")
    assert built["auto"].kernel_table() == f32.kernel_table()
    assert any(r["kernel"] == "bcsr" for r in f32.kernel_table())
    # byte accounting reads the element size: a bf16 value plane counts 2
    # bytes an element, half the f32 one; index arrays are the same
    from repro_torch.amg.dist_spmv import VALUE_PLANES

    def planes(dh):
        out = {}
        for l, a in enumerate(dh._arrs):
            for key, v in a.items():
                for name, t in (v.items() if isinstance(v, dict)
                                else ((key, v),)):
                    out[(l, key, name)] = t
        return out

    # a fresh lowering: the fixture's have run programs, whose state
    # buffers nbytes counts too
    bf16 = DistHierarchy.build(h, N_PODS, LANES, dtype=torch.bfloat16,
                               device="cpu")
    p16, p32 = planes(bf16), planes(f32)
    assert p16.keys() == p32.keys()
    values = 0
    for key, t in p16.items():
        if key[2] in VALUE_PLANES or key[2] in ("dinv", "cinv"):
            assert t.dtype == torch.bfloat16 and t.element_size() == 2, key
            values += t.numel() * 2
        else:
            assert t.dtype == p32[key].dtype and torch.equal(t, p32[key]), key
    assert f32.nbytes - bf16.nbytes == values


def test_bf16_service_update_and_wire():
    """A bfloat16 config through ``AMGService`` (six requests coalesced into
    one k = 6 solve), AMGWire on the loopback answering what the in-process
    service answers, and a session ``update`` that refreshes."""
    from repro_torch.amg import AMGConfig, AMGService, AMGSolver
    from repro_torch.amg.api import (clear_sessions, csr_to_wire,
                                     solve_request_to_wire)
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.serve import AMGWireClient, ServerThread, TenantSpec
    from repro_torch.serve.workload import rel_residual

    clear_sessions()
    A = laplace_3d(N)
    cfg = AMGConfig(backend="torch", dtype="bfloat16", device="cpu",
                    n_pods=N_PODS, lanes=LANES, max_coarse=MAX_COARSE,
                    tol=TOL)
    rng = np.random.default_rng(5)
    bs = [rng.standard_normal(A.nrows) for _ in range(6)]
    svc = AMGService(cfg, max_rhs=8, coalesce_window=0.5)
    svc.register("a", A)
    tickets = [svc.submit("a", b, method="pcg") for b in bs]
    svc.drain()
    xs = [t.result(timeout=0) for t in tickets]
    assert svc.stats["batches"] == 1 and svc.stats["batched_rhs"] == 6
    for t, x, b in zip(tickets, xs, bs):
        assert t.diagnostics["converged"] and x.dtype == np.float32
        assert rel_residual(A, x, b) <= 2.0**-5
    assert svc.bound_for("a").dist_hierarchy.dtype == torch.bfloat16
    with ServerThread({"t": TenantSpec(config=cfg)}) as srv, \
            AMGWireClient.connect(srv.host, srv.port) as c:
        mid = c.register("t", csr_to_wire(A))["matrix"]
        x, d = c.solve("t", solve_request_to_wire(mid, bs[0], method="pcg"),
                       timeout=120)
    one = AMGService(cfg)
    one.register("a", A)
    ticket = one.submit("a", bs[0], method="pcg")
    one.drain()
    assert d["converged"] and np.array_equal(x, ticket.result(timeout=0))
    # last: sessions on one matrix share their host levels (ROADMAP
    # queue 3), so the refresh is seen by every session on A after it
    bound = AMGSolver(cfg).setup(A)
    assert bound.update(delta=0.01 * A.data) == "refresh"
    res = bound.pcg(bs[0])
    assert res.converged and res.residuals[-1] / res.residuals[0] < TOL
    clear_sessions()


def test_bf16_launcher_harness():
    """``launch/serve.py --solver amg --dtype bfloat16`` on the CPU: every
    request converges to the bfloat16 default tolerance, 1e-5."""
    from repro_torch.amg.api import clear_sessions
    from repro_torch.launch import serve
    from repro_torch.serve.workload import default_tol

    assert default_tol("torch", dtype="bfloat16") == 1e-5
    clear_sessions()
    stats = serve.main(["--solver", "amg", "--amg-backend", "torch",
                        "--device", "cpu", "--n-pods", str(N_PODS),
                        "--lanes", str(LANES), "--n", "6", "--dtype",
                        "bfloat16", "--requests", "4", "--method", "pcg"])
    clear_sessions()
    assert stats["requests"] == 4 and stats["errors"] == 0
    assert stats["unconverged"] == 0


def test_bf16_refusals_name_their_roadmap_items():
    """bfloat16 takes every smoother on stacked ranks and Jacobi and
    Chebyshev on process ranks; what it still refuses, float32 refuses too:
    a block smoother with one process per rank (item 12).  The run arrays
    of a bfloat16 lowering carry its block smoothers' factors in
    bfloat16."""
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.amg.solve import SolveOptions

    base = dict(backend="torch", dtype="bfloat16", device="cpu",
                n_pods=N_PODS, lanes=LANES)
    for sm in ("block_jacobi", "hybrid_gs", "hybrid_gs_sym"):
        assert AMGConfig(**base, opts=SolveOptions(smoother=sm)).dtype == "bfloat16"
        for dtype in ("bfloat16", "float32"):
            with pytest.raises(NotImplementedError, match="item 12"):
                AMGConfig(**dict(base, dtype=dtype), ranks="process",
                          opts=SolveOptions(smoother=sm))
    for sm in ("jacobi", "chebyshev"):
        assert AMGConfig(**base, ranks="process",
                         opts=SolveOptions(smoother=sm)).ranks == "process"
    bound = AMGSolver(AMGConfig(**base, max_coarse=MAX_COARSE)).setup(
        laplace_3d(6))
    arrs = bound.dist_hierarchy.run_arrays(SolveOptions(smoother="hybrid_gs_sym"))
    factors = [a[name] for a in arrs for name in ("minv", "minv_u") if name in a]
    assert factors and all(f.vals.dtype == f.diag.dtype == torch.bfloat16
                           for f in factors)
    bj = bound.dist_hierarchy.run_arrays(SolveOptions(smoother="block_jacobi"))
    assert all(a["minv"].binv.dtype == torch.bfloat16 for a in bj if "minv" in a)


if __name__ == "__main__":
    if len(sys.argv) != 5 or sys.argv[1] != "--jax-ref":
        sys.exit("usage: test_torch_bf16_sessions.py --jax-ref OUT.npz IN.npz "
                 "PART")
    _jax_reference(sys.argv[2], sys.argv[3], int(sys.argv[4]))
