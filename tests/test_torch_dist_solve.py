"""The slice as a whole: the port's distributed solve on the CPU against the
reference's JAX ``backend="dist"`` path on a 2×4 mesh of 8 host devices,
both in float64 and fed the identical hierarchy through
:mod:`repro_torch.convert`.  Residual histories (and solutions) must agree
to ≤ 1e-7 of r0 across PCG and stationary solve, V/W/F cycles, Jacobi and
Chebyshev, one RHS and k = 3, both overlap modes, and strategy auto / nap3;
and again after both sides refresh their lowered hierarchy in place with the
same drifted values (``DistHierarchy.refresh_values``, A + ΔA with the
reference suite's ``_drift``).

The JAX side needs 8 host devices set before jax is imported, so it runs
once per module as a subprocess of this very file::

    python tests/test_torch_dist_solve.py --jax-ref OUT.npz IN.npz
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

N_PODS, LANES = 2, 4
TOL = 1e-7            # |Δ residual| / r0, the JAX suite's float64 bar
ITERS = 5
# (method, cycle, smoother, k, overlap, strategy): every value of every
# knob appears, each cycle with both smoothers
CASES = [
    ("pcg", "V", "jacobi", 1, True, "auto"),
    ("pcg", "V", "chebyshev", 3, False, "nap3"),
    ("pcg", "W", "chebyshev", 1, True, "nap3"),
    ("pcg", "F", "jacobi", 3, True, "auto"),
    ("solve", "V", "chebyshev", 1, True, "auto"),
    ("solve", "W", "jacobi", 3, False, "auto"),
    ("solve", "F", "chebyshev", 1, False, "nap3"),
    ("solve", "F", "jacobi", 3, True, "nap3"),
]
CYCLES = ("V", "W", "F")
# after the refresh (strategy auto, overlap on): both smoothers, both widths
REFRESH_CASES = [
    ("pcg", "V", "jacobi", 1, True, "auto"),
    ("pcg", "W", "chebyshev", 3, True, "auto"),
    ("solve", "F", "jacobi", 3, True, "auto"),
]


def _case_id(case):
    return "-".join(map(str, case))


def _inputs():
    """The problem both sides solve: the port's setup of laplace_3d(8)
    (bit-identical to the reference's) and a [n, 3] right-hand side."""
    from repro_torch.amg.hierarchy import setup
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.convert import hierarchy_to_arrays

    from repro_torch.amg.csr import CSR
    from repro_torch.amg.hierarchy import refresh_values

    A = laplace_3d(8)
    h = setup(A, solver="rs", max_coarse=30)      # 3 levels: W/F differ
    rng = np.random.default_rng(11)
    B = np.stack([A.matvec(np.ones(A.nrows))]
                 + [rng.standard_normal(A.nrows) for _ in range(2)], axis=1)
    # the refreshed levels both sides lower their values from: the drift of
    # the reference suite's tests/test_streaming.py:_drift, scale 0.03,
    # seed 1, Galerkin products re-run on the frozen P/R
    drift = np.random.default_rng(1)
    data = A.data * (1.0 + 0.03 * drift.random(A.nnz))
    At = CSR(A.shape, A.indptr.copy(), A.indices.copy(), data).T
    h_new = setup(A, solver="rs", max_coarse=30)
    refresh_values(h_new, CSR(A.shape, A.indptr.copy(), A.indices.copy(),
                              0.5 * (data + At.data)))
    return {**hierarchy_to_arrays(h), "B": B,
            **{"new_" + k: v for k, v in hierarchy_to_arrays(h_new).items()}}


def _refreshed(d):
    """The refreshed levels' arrays out of :func:`_inputs`' dict."""
    return {k[4:]: d[k] for k in d if k.startswith("new_")}


def _run(dh, solve_fns, opts_cls, case, B):
    method, cycle, smoother, k, _, _ = case
    opts = opts_cls(cycle=cycle, smoother=smoother)
    b = B[:, 0] if k == 1 else B[:, :k]
    fn = solve_fns[method]
    res = fn(dh, b, tol=0.0, maxiter=ITERS, opts=opts)
    if k == 1:
        return [np.asarray(res.residuals)], res.x[:, None]
    return [np.asarray(c.residuals) for c in res.columns], res.x


# --------------------------------------------------------------- JAX side
def _jax_reference(out_path, in_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.amg.csr import CSR
    from repro.amg.dist_solve import (DistHierarchy, cycle_comm_stats,
                                      dist_pcg, dist_solve)
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

    d = dict(np.load(in_path))
    h = hierarchy(d)
    B = d["B"]
    out = {}
    built = {}
    for i, case in enumerate(CASES):
        overlap, strategy = case[4], case[5]
        if strategy not in built:
            built[strategy] = DistHierarchy.build(
                h, N_PODS, LANES, strategy=strategy, dtype=jnp.float64)
            for c in CYCLES:
                st = cycle_comm_stats(built[strategy], SolveOptions(cycle=c))
                out[f"stats_{strategy}_{c}"] = np.array(
                    [st[k] for k in ("inter_msgs", "intra_msgs",
                                     "coarse_inter_msgs")])
        dh = built[strategy]
        dh.overlap = overlap
        hists, x = _run(dh, {"pcg": dist_pcg, "solve": dist_solve},
                        SolveOptions, case, B)
        for j, hist in enumerate(hists):
            out[f"case{i}_col{j}"] = hist
        out[f"case{i}_x"] = x
    dh = built["auto"]
    dh.overlap = True
    dh.refresh_values(hierarchy(_refreshed(d)).levels)
    for i, case in enumerate(REFRESH_CASES):
        hists, _ = _run(dh, {"pcg": dist_pcg, "solve": dist_solve},
                        SolveOptions, case, B)
        for j, hist in enumerate(hists):
            out[f"refresh{i}_col{j}"] = hist
    np.savez(out_path, **out)


# ------------------------------------------------------------- port side
torch = pytest.importorskip("torch") if __name__ != "__main__" else None


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_ref")
    inputs = _inputs()
    in_path, out_path = tmp / "in.npz", tmp / "out.npz"
    np.savez(in_path, **inputs)
    env = dict(os.environ)
    root = pathlib.Path(__file__).parents[1]
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, __file__, "--jax-ref", str(out_path), str(in_path)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return inputs, dict(np.load(out_path))


@pytest.fixture(scope="module")
def port_hierarchies(shared):
    from repro_torch.amg.dist_solve import DistHierarchy
    from repro_torch.convert import hierarchy_from_arrays

    h = hierarchy_from_arrays(shared[0])
    return {s: DistHierarchy.build(h, N_PODS, LANES, strategy=s,
                                   dtype=torch.float64, device="cpu")
            for s in ("auto", "nap3")}


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_residual_histories_match_jax_dist(shared, port_hierarchies, i):
    from repro_torch.amg.dist_solve import dist_pcg, dist_solve
    from repro_torch.amg.solve import SolveOptions

    inputs, ref = shared
    case = CASES[i]
    dh = port_hierarchies[case[5]]
    dh.overlap = case[4]
    hists, x = _run(dh, {"pcg": dist_pcg, "solve": dist_solve},
                    SolveOptions, case, inputs["B"])
    assert len(hists) == case[3]
    for j, hist in enumerate(hists):
        want = ref[f"case{i}_col{j}"]
        assert hist.shape == want.shape == (ITERS + 1,)
        diff = np.abs(hist - want).max() / want[0]
        assert diff <= TOL, (j, diff)
        assert hist[-1] < hist[0]
    xr = ref[f"case{i}_x"]
    assert np.abs(x - xr).max() <= TOL * np.abs(xr).max()


@pytest.mark.parametrize("strategy", ["auto", "nap3"])
def test_cycle_comm_stats_match_jax_dist(shared, port_hierarchies, strategy):
    from repro_torch.amg.dist_solve import cycle_comm_stats
    from repro_torch.amg.solve import SolveOptions

    ref = shared[1]
    for c in CYCLES:
        st = cycle_comm_stats(port_hierarchies[strategy], SolveOptions(cycle=c))
        got = [st[k] for k in ("inter_msgs", "intra_msgs", "coarse_inter_msgs")]
        assert got == list(ref[f"stats_{strategy}_{c}"]), c


def test_refreshed_histories_match_jax_dist(shared):
    """The port's refresh beneath its cached programs (Chebyshev ones
    dropped, Jacobi ones kept) against the reference's refreshed dist
    solve."""
    from repro_torch.amg.dist_solve import (DistHierarchy, dist_pcg,
                                            dist_solve)
    from repro_torch.amg.solve import SolveOptions
    from repro_torch.convert import hierarchy_from_arrays

    inputs, ref = shared
    dh = DistHierarchy.build(hierarchy_from_arrays(inputs), N_PODS, LANES,
                             strategy="auto", dtype=torch.float64,
                             device="cpu")
    fns = {"pcg": dist_pcg, "solve": dist_solve}
    for case in REFRESH_CASES:                  # programs cached before
        _run(dh, fns, SolveOptions, case, inputs["B"])
    n_programs = len(dh.programs)
    dh.refresh_values(hierarchy_from_arrays(_refreshed(inputs)).levels)
    assert len(dh.programs) == n_programs - 2     # the two Chebyshev ones
    assert {k.smoother for k in dh.programs.keys()} == {"jacobi"}
    for i, case in enumerate(REFRESH_CASES):
        hists, _ = _run(dh, fns, SolveOptions, case, inputs["B"])
        for j, hist in enumerate(hists):
            want = ref[f"refresh{i}_col{j}"]
            assert hist.shape == want.shape == (ITERS + 1,)
            assert np.abs(hist - want).max() / want[0] <= TOL, (i, j)


def test_session_api_matches_host_backend(shared):
    """``AMGSolver(AMGConfig(backend="torch", device="cpu"))`` end to end,
    single and multi-RHS PCG, against the numpy host backend."""
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d

    A = laplace_3d(8)
    B = shared[0]["B"]
    cfg = AMGConfig(backend="torch", n_pods=N_PODS, lanes=LANES,
                    dtype="float64", device="cpu", max_coarse=30)
    bound = AMGSolver(cfg).setup(A)
    host = AMGSolver(AMGConfig(backend="host", max_coarse=30)).setup(A)
    assert bound.hierarchy is host.hierarchy       # one shared setup
    r, rh = bound.pcg(B[:, 0]), host.pcg(B[:, 0])
    assert r.converged and r.iterations == rh.iterations
    assert np.abs(np.subtract(r.residuals, rh.residuals)).max() \
        <= TOL * rh.residuals[0]
    m = bound.pcg(B)
    for j in range(B.shape[1]):
        single = bound.pcg(B[:, j])
        assert m.columns[j].iterations == single.iterations
        assert np.abs(m.x[:, j] - single.x).max() <= TOL * np.abs(single.x).max()
    assert bound.dist_hierarchy.nbytes > 0


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "--jax-ref":
        sys.exit("usage: test_torch_dist_solve.py --jax-ref OUT.npz IN.npz")
    _jax_reference(sys.argv[2], sys.argv[3])
