"""One process per rank: the port's ``torch.distributed`` back-end on the CPU.

Eight gloo processes on a 2×4 rank grid (``repro_torch.launch.ranks.spawn``,
``device="cpu"``) run one battery, once per module; each rank writes its
results to an ``.npz`` and the assertions run here in the parent:

* halos — ``standard``, ``nap2`` and ``nap3``, one RHS and k = 3, on
  ``laplace_3d(6)``, on a random sparse operator some of whose ranks need
  nothing, and on a block-diagonal one that moves nothing: rank d's halo is
  bit-equal to ``x[need]`` and to row d of the stacked ``halo_exchange``,
  and its log is the strategy's signature;
* reductions — ``hier_psum`` (flat, nap3) within 1e-13 of the stacked total
  in float64 and bit-identical on every rank; ``hier_all_gather`` bit-equal
  to the stacked one;
* bfloat16 — the same halos on bfloat16 data bit-equal to ``x[need]`` and
  to the stacked halo, each rank's log the signature; ``hier_psum`` (flat,
  nap3) of bfloat16 partials bit-equal to the stacked one (a bfloat16 sum
  between the processes runs in float32 and rounds once, as the stacked
  ``.sum`` does); a bfloat16 PCG with Jacobi and one with Chebyshev
  (``laplace_3d(8)``, tol 1e-5) bit-equal to the stacked bfloat16 session
  on every rank;
* the slice — ``AMGSolver(AMGConfig(backend="torch", ranks="process", ...))``
  on float64 ``laplace_3d(8)``, PCG and the stationary solve over V/W/F ×
  Jacobi/Chebyshev, k = 1 and 3, strategy ``auto`` and ``nap3``: residual
  histories and solutions within 1e-7 of r0 of the reference's JAX
  ``backend="dist"`` on 8 host devices (x64), histories identical on every
  rank;
* the audit of the ten programs of (V, Jacobi) on each rank: 0 violations;
* the refusals.

The JAX side needs 8 host devices set before jax is imported, so it runs
as a subprocess of this very file, beside the ranks::

    python tests/test_torch_process_ranks.py --jax-ref OUT.npz IN.npz
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

N_PODS, LANES = 2, 4
D = N_PODS * LANES
TOL = 1e-7            # |Δ residual| / r0, the JAX suite's float64 bar
ITERS = 5
DEADLINE = 180.0      # seconds: a hang fails the module, not the suite
STRATEGIES = ("standard", "nap2", "nap3")
MATRICES = ("laplace", "random", "blockdiag")
# (method, cycle, smoother, k, strategy): every cycle with both smoothers
# and both methods, and every (k, strategy) pair under each method
CASES = [
    ("pcg", "V", "jacobi", 1, "auto"), ("solve", "V", "jacobi", 3, "nap3"),
    ("pcg", "V", "chebyshev", 3, "nap3"), ("solve", "V", "chebyshev", 1, "auto"),
    ("pcg", "W", "jacobi", 3, "auto"), ("solve", "W", "jacobi", 1, "nap3"),
    ("pcg", "W", "chebyshev", 1, "nap3"), ("solve", "W", "chebyshev", 3, "auto"),
    ("pcg", "F", "jacobi", 1, "nap3"), ("solve", "F", "jacobi", 3, "auto"),
    ("pcg", "F", "chebyshev", 3, "auto"), ("solve", "F", "chebyshev", 1, "nap3"),
]
SETUP = dict(max_coarse=30)          # 3 levels: W and F differ from V
BF16_TOL = 1e-5
# (smoother, strategy, k) of the bfloat16 PCG runs
BF16_CASES = [("jacobi", "auto", 1), ("chebyshev", "nap3", 3)]


def _case_id(case):
    return "-".join(map(str, case))


def _rhs(n):
    rng = np.random.default_rng(11)
    return rng.standard_normal((n, 3))


def _halo_matrix(name):
    """The operators the halo battery exchanges over (numpy, every rank
    builds the same)."""
    from repro_torch.amg.csr import CSR
    from repro_torch.amg.problems import laplace_3d

    if name == "laplace":
        return laplace_3d(6)
    n = 200
    rng = np.random.default_rng(5)
    r, c = np.nonzero(rng.random((n, n)) < 0.03)
    if name == "random":
        # ranks 0-2 (rows < 75) couple only within their own rows
        keep = (r >= 75) | (c // 25 == r // 25)
    else:                                         # block-diagonal
        keep = c // 25 == r // 25
    r, c = r[keep], c[keep]
    return CSR.from_coo(r, c, rng.standard_normal(r.size), (n, n))


# ------------------------------------------------------------ rank side
def _battery(ranks, out_dir):
    """Every rank's battery (runs in the spawned processes)."""
    import torch

    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.dist import rect_vector_graph
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.amg.solve import SolveOptions
    from repro_torch.analysis.comm_audit import audit_hierarchy, rank_traffic
    from repro_torch.core.nap_collectives import (build_halo_plan,
                                                  halo_exchange,
                                                  hier_all_gather, hier_psum,
                                                  rank_groups)
    from repro_torch.core.topology import Partition, Topology

    d = ranks.rank
    out = {}

    def idx(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.int64)

    # halos
    for name in MATRICES:
        A = _halo_matrix(name)
        part = Partition.balanced(A.nrows, Topology(N_PODS, LANES))
        graph = rect_vector_graph(A, part, part)
        need = np.sort(graph.need[d])
        xg = np.random.default_rng(7).standard_normal((A.nrows, 3))
        for strategy in STRATEGIES:
            plan = build_halo_plan(graph, N_PODS, LANES, strategy)
            xs = np.zeros((D, plan.local_n, 3))
            for q in range(D):
                lo, hi = part.local_range(q)
                xs[q, : hi - lo] = xg[lo:hi]
            for k in (1, 3):
                x = torch.from_numpy(xs[..., 0] if k == 1 else xs)
                send, recv, psel = (idx(plan.send_idx), idx(plan.recv_sel),
                                    idx(plan.pool_sel))
                stacked = halo_exchange(x, plan, send, recv, psel)
                log = []
                mine = halo_exchange(
                    x[d:d + 1], plan, send[d:d + 1], recv[d:d + 1],
                    None if psel is None else psel[d:d + 1], log=log,
                    ranks=ranks)
                key = f"{name}_{strategy}_{k}"
                out[f"halo_{key}"] = mine[0].numpy()
                out[f"stacked_{key}"] = stacked[d].numpy()
                out[f"need_{key}"] = xg[need, 0] if k == 1 else xg[need]
                out[f"log_{key}"] = np.array(log)
                out[f"total_{key}"] = np.array(plan.total_halo)
                # the same exchange on bfloat16 data
                xb = x.to(torch.bfloat16)
                stacked = halo_exchange(xb, plan, send, recv, psel)
                log = []
                mine = halo_exchange(
                    xb[d:d + 1], plan, send[d:d + 1], recv[d:d + 1],
                    None if psel is None else psel[d:d + 1], log=log,
                    ranks=ranks)
                assert mine.dtype == torch.bfloat16
                need_b = torch.from_numpy(out[f"need_{key}"]).to(torch.bfloat16)
                out[f"bf16_halo_{key}"] = mine[0].float().numpy()
                out[f"bf16_stacked_{key}"] = stacked[d].float().numpy()
                out[f"bf16_need_{key}"] = need_b.float().numpy()
                out[f"bf16_log_{key}"] = np.array(log)

    # reductions
    rng = np.random.default_rng(9)
    for shape in ((D, 5), (D, 3, 2)):
        v = torch.from_numpy(rng.standard_normal(shape) * 1e3)
        tag = "x".join(map(str, shape[1:]))
        for strategy in ("flat", "nap3"):
            out[f"psum_{strategy}_{tag}"] = hier_psum(
                v[d:d + 1], N_PODS, LANES, strategy, ranks=ranks)[0].numpy()
            out[f"psum_stacked_{strategy}_{tag}"] = hier_psum(
                v, N_PODS, LANES, strategy)[d].numpy()
            out[f"gather_{strategy}_{tag}"] = hier_all_gather(
                v[d:d + 1], N_PODS, LANES, strategy, ranks=ranks)[0].numpy()
            out[f"gather_stacked_{strategy}_{tag}"] = hier_all_gather(
                v, N_PODS, LANES, strategy)[d].numpy()
            # bfloat16 partials of mixed magnitudes
            vb = (v * torch.from_numpy(
                10.0 ** rng.integers(-3, 3, shape))).to(torch.bfloat16)
            got = hier_psum(vb[d:d + 1], N_PODS, LANES, strategy, ranks=ranks)
            assert got.dtype == torch.bfloat16
            out[f"bf16_psum_{strategy}_{tag}"] = got[0].float().numpy()
            out[f"bf16_psum_stacked_{strategy}_{tag}"] = hier_psum(
                vb, N_PODS, LANES, strategy)[d].float().numpy()

    # the slice through the session entry point
    A = laplace_3d(8)
    B = _rhs(A.nrows)
    for i, (method, cycle, smoother, k, strategy) in enumerate(CASES):
        cfg = AMGConfig(backend="torch", ranks="process", n_pods=N_PODS,
                        lanes=LANES, dtype="float64", device="cpu",
                        strategy=strategy, **SETUP,
                        opts=SolveOptions(cycle=cycle, smoother=smoother))
        bound = AMGSolver(cfg).setup(A)
        res = getattr(bound, method)(B[:, 0] if k == 1 else B[:, :k],
                                     tol=0.0, maxiter=ITERS)
        cols = [res] if k == 1 else res.columns
        out[f"case{i}_hist"] = np.array([c.residuals for c in cols])
        out[f"case{i}_x"] = res.x[:, None] if k == 1 else res.x
    dh = bound.dist_hierarchy

    # bfloat16 PCG against the stacked bfloat16 session, on every rank
    rhs = A.matvec(1.0 + 0.5 * np.random.default_rng(4).random(A.nrows))
    Bb = np.stack([rhs, B[:, 1], B[:, 2]], axis=1)
    for i, (smoother, strategy, k) in enumerate(BF16_CASES):
        cfg = AMGConfig(backend="torch", ranks="process", n_pods=N_PODS,
                        lanes=LANES, dtype="bfloat16", device="cpu",
                        strategy=strategy, tol=BF16_TOL, **SETUP,
                        opts=SolveOptions(smoother=smoother))
        rk = Bb[:, 0] if k == 1 else Bb[:, :k]
        bound16 = AMGSolver(cfg).setup(A)
        runs = {"": bound16.pcg(rk),
                "stacked_": AMGSolver(cfg.replace(ranks="stacked")).setup(
                    A).pcg(rk)}
        for pre, res in runs.items():
            cols = [res] if k == 1 else res.columns
            for j, c in enumerate(cols):
                out[f"bf16_{pre}case{i}_col{j}"] = np.asarray(c.residuals)
                out[f"bf16_{pre}case{i}_conv{j}"] = np.array(c.converged)
            out[f"bf16_{pre}case{i}_x"] = np.asarray(res.x, dtype=np.float32)
        if i == 0:
            # one iteration's tally: the dots' sums travel as float32
            traffic = rank_traffic(bound16.dist_hierarchy)
            ranks16 = bound16.dist_hierarchy.ranks
            for part, pick in (("dot", lambda t: t == ("dot",)),
                               ("halo", lambda t: t != ("dot",))):
                out[f"bf16_{part}_elements"] = np.array(sum(
                    n for (_, t), n in ranks16.sent.items() if pick(t)))
                out[f"bf16_{part}_bytes"] = np.array(sum(
                    n for (_, t), n in ranks16.sent_bytes.items() if pick(t)))
            out["bf16_traffic_bytes"] = np.array(sum(traffic["bytes"].values()))
    out["devices"] = np.array(sorted({str(t.device) for a in dh._arrs
                                      for v in a.values()
                                      for t in (v.values() if isinstance(
                                          v, dict) else (v,))}))
    out["leading"] = np.array(sorted({a["A"]["cols"].shape[0]
                                      for a in dh._arrs}))

    # the audit of one (cycle, smoother), and one iteration's traffic
    audits, violations = audit_hierarchy(dh, pairs=[("V", "jacobi")])
    out["audits"] = np.array(len(audits))
    out["violations"] = np.array([str(v) for v in violations] or [""])
    traffic = rank_traffic(dh)
    out["traffic_slow"] = np.array(traffic["elements"].get("slow", 0))
    out["traffic_fast"] = np.array(traffic["elements"].get("fast", 0))

    # the refusals that need a group
    refused = []
    try:
        bound.update(A)
    except NotImplementedError as e:
        refused.append("update" if "item 12" in str(e) else str(e))
    try:
        rank_groups(3, 3)
    except ValueError as e:
        refused.append("world" if "needs 9" in str(e) else str(e))
    other = laplace_3d(7) if d == 3 else A
    try:
        AMGSolver(AMGConfig(backend="torch", ranks="process", n_pods=N_PODS,
                            lanes=LANES, device="cpu")).setup(other)
    except ValueError as e:
        refused.append("fingerprint" if "disagree" in str(e) else str(e))
    out["refused"] = np.array(refused)
    np.savez(os.path.join(out_dir, f"rank{d}.npz"), **out)
    return d


def _raise_on_rank_1(ranks):
    if ranks.rank == 1:
        raise ValueError("rank 1 refuses")
    ranks.gather_objects(None)          # waits for rank 1 until killed


# --------------------------------------------------------------- JAX side
def _jax_reference(out_path, in_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.amg.csr import CSR
    from repro.amg.dist_solve import DistHierarchy, dist_pcg, dist_solve
    from repro.amg.hierarchy import Hierarchy, Level
    from repro.amg.solve import SolveOptions

    d = dict(np.load(in_path))
    levels = []
    for l in range(int(d["n_levels"])):
        ops = {}
        for op in ("A", "P", "R"):
            key = f"L{l}_{op}_"
            ops[op] = (CSR(tuple(int(s) for s in d[key + "shape"]),
                           d[key + "indptr"], d[key + "indices"],
                           d[key + "data"]) if key + "shape" in d else None)
        levels.append(Level(**ops))
    h = Hierarchy(solver=str(d["solver"]), levels=levels,
                  theta=float(d["theta"]))
    B = d["B"]
    built, out = {}, {}
    fns = {"pcg": dist_pcg, "solve": dist_solve}
    for i, (method, cycle, smoother, k, strategy) in enumerate(CASES):
        if strategy not in built:
            built[strategy] = DistHierarchy.build(
                h, N_PODS, LANES, strategy=strategy, dtype=jnp.float64)
        res = fns[method](built[strategy], B[:, 0] if k == 1 else B[:, :k],
                          tol=0.0, maxiter=ITERS,
                          opts=SolveOptions(cycle=cycle, smoother=smoother))
        cols = [res] if k == 1 else res.columns
        out[f"case{i}_hist"] = np.array([c.residuals for c in cols])
        out[f"case{i}_x"] = np.asarray(res.x)[:, None] if k == 1 \
            else np.asarray(res.x)
    np.savez(out_path, **out)


# ------------------------------------------------------------ the parent
torch = pytest.importorskip("torch") if __name__ != "__main__" else None


@pytest.fixture(scope="module")
def ranks_run(tmp_path_factory):
    """The reference's histories (a JAX subprocess) and every rank's
    battery results, run side by side."""
    from repro_torch.amg import AMGConfig
    from repro_torch.amg.hierarchy import setup
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.convert import hierarchy_to_arrays
    from repro_torch.launch.ranks import spawn

    tmp = tmp_path_factory.mktemp("process_ranks")
    A = laplace_3d(8)
    h = setup(A, **AMGConfig(**SETUP).setup_kwargs())
    in_path, ref_path = tmp / "in.npz", tmp / "ref.npz"
    np.savez(in_path, **hierarchy_to_arrays(h), B=_rhs(A.nrows))
    env = dict(os.environ)
    root = pathlib.Path(__file__).parents[1]
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    jax_ref = subprocess.Popen(
        [sys.executable, __file__, "--jax-ref", str(ref_path), str(in_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        done = spawn(_battery, N_PODS, LANES, (str(tmp),), deadline=DEADLINE)
        stdout, stderr = jax_ref.communicate(timeout=DEADLINE)
    finally:
        if jax_ref.poll() is None:
            jax_ref.kill()
            jax_ref.communicate()
    assert done == list(range(D))
    assert jax_ref.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(D)]
    return ranks, dict(np.load(ref_path))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("matrix", MATRICES)
def test_halo_is_bit_equal_to_need_and_to_stacked(ranks_run, matrix,
                                                  strategy, k):
    from repro_torch.core.nap_collectives import HALO_SIGNATURES

    key = f"{matrix}_{strategy}_{k}"
    empty_ranks = 0
    for out in ranks_run[0]:
        halo, need = out[f"halo_{key}"], out[f"need_{key}"]
        assert np.array_equal(halo, out[f"stacked_{key}"])
        assert np.array_equal(halo[: len(need)], need)
        assert not halo[len(need):].any()
        assert tuple(out[f"log_{key}"]) == HALO_SIGNATURES[strategy]
        empty_ranks += len(need) == 0
    if matrix == "random":
        assert empty_ranks == 3          # ranks 0-2 need nothing
    if matrix == "blockdiag":
        assert empty_ranks == D and int(ranks_run[0][0][f"total_{key}"]) == 0


@pytest.mark.parametrize("shape", ["5", "3x2"])
@pytest.mark.parametrize("strategy", ["flat", "nap3"])
def test_reductions_match_stacked(ranks_run, strategy, shape):
    outs = ranks_run[0]
    got = outs[0][f"psum_{strategy}_{shape}"]
    want = outs[0][f"psum_stacked_{strategy}_{shape}"]
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    for out in outs:
        assert np.array_equal(out[f"psum_{strategy}_{shape}"], got)
        assert np.array_equal(out[f"gather_{strategy}_{shape}"],
                              out[f"gather_stacked_{strategy}_{shape}"])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("matrix", MATRICES)
def test_bf16_halo_is_bit_equal_to_need_and_to_stacked(ranks_run, matrix,
                                                       strategy, k):
    """bfloat16 halos move as float32 ones do, by index steps: rank d's
    is ``x[need]`` bit for bit (zeros past it) and the stacked halo's row
    d, and each rank logs the strategy's signature."""
    from repro_torch.core.nap_collectives import HALO_SIGNATURES

    key = f"{matrix}_{strategy}_{k}"
    for out in ranks_run[0]:
        halo, need = out[f"bf16_halo_{key}"], out[f"bf16_need_{key}"]
        assert np.array_equal(halo, out[f"bf16_stacked_{key}"])
        assert np.array_equal(halo[: len(need)], need)
        assert not halo[len(need):].any()
        assert tuple(out[f"bf16_log_{key}"]) == HALO_SIGNATURES[strategy]


@pytest.mark.parametrize("shape", ["5", "3x2"])
@pytest.mark.parametrize("strategy", ["flat", "nap3"])
def test_bf16_reductions_equal_stacked(ranks_run, strategy, shape):
    """``hier_psum`` of bfloat16 partials of mixed magnitudes between the
    processes equals the stacked sum bit for bit on every rank."""
    for out in ranks_run[0]:
        assert np.array_equal(out[f"bf16_psum_{strategy}_{shape}"],
                              out[f"bf16_psum_stacked_{strategy}_{shape}"])


def test_bf16_traffic_counts_the_bytes_sent(ranks_run):
    """One bfloat16 PCG iteration's tally on process ranks: the halos send
    2 bytes an element; the dots' sums 4 (they travel as float32), so the
    dots' bytes exceed 2 an element (their gathers of summed pieces move
    bfloat16); ``rank_traffic``'s bytes are the total."""
    for out in ranks_run[0]:
        assert out["bf16_dot_elements"] > 0 and out["bf16_halo_elements"] > 0
        assert (2 * out["bf16_dot_elements"] < out["bf16_dot_bytes"]
                <= 4 * out["bf16_dot_elements"])
        assert out["bf16_halo_bytes"] == 2 * out["bf16_halo_elements"]
        assert out["bf16_traffic_bytes"] == (out["bf16_dot_bytes"]
                                             + out["bf16_halo_bytes"])


@pytest.mark.parametrize("i", range(len(BF16_CASES)),
                         ids=["-".join(map(str, c)) for c in BF16_CASES])
def test_bf16_pcg_equals_the_stacked_session_on_every_rank(ranks_run, i):
    """A bfloat16 PCG on process ranks converges to 1e-5 with the stacked
    bfloat16 session's history and x, bit for bit, on every rank."""
    k = BF16_CASES[i][2]
    first = ranks_run[0][0]
    for out in ranks_run[0]:
        for j in range(k):
            hist = out[f"bf16_case{i}_col{j}"]
            assert bool(out[f"bf16_case{i}_conv{j}"])
            assert hist[-1] / hist[0] < BF16_TOL
            assert np.array_equal(hist, out[f"bf16_stacked_case{i}_col{j}"])
            assert np.array_equal(hist, first[f"bf16_case{i}_col{j}"])
        assert np.array_equal(out[f"bf16_case{i}_x"],
                              out[f"bf16_stacked_case{i}_x"])


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_histories_match_jax_dist_on_every_rank(ranks_run, i):
    outs, ref = ranks_run
    hist, want = outs[0][f"case{i}_hist"], ref[f"case{i}_hist"]
    assert hist.shape == want.shape == (CASES[i][3], ITERS + 1)
    for j in range(hist.shape[0]):
        assert np.abs(hist[j] - want[j]).max() / want[j, 0] <= TOL, j
        assert hist[j, -1] < hist[j, 0]
    xr = ref[f"case{i}_x"]
    for out in outs:
        assert np.array_equal(out[f"case{i}_hist"], hist)
        assert np.abs(out[f"case{i}_x"] - xr).max() <= TOL * np.abs(xr).max()


def test_each_rank_holds_its_own_slice_on_the_cpu(ranks_run):
    for out in ranks_run[0]:
        assert list(out["devices"]) == ["cpu"]
        assert list(out["leading"]) == [1]


def test_each_rank_audits_clean(ranks_run):
    for d, out in enumerate(ranks_run[0]):
        assert list(out["violations"]) == [""], (d, out["violations"])
        assert int(out["audits"]) >= 10
        # one PCG iteration crosses both groups on every rank
        assert int(out["traffic_slow"]) > 0 and int(out["traffic_fast"]) > 0


def test_refusals_inside_the_ranks(ranks_run):
    for out in ranks_run[0]:
        assert list(out["refused"]) == ["update", "world", "fingerprint"]


def test_refusals_without_ranks():
    from repro_torch.amg import AMGConfig, AMGService, AMGSolver
    from repro_torch.amg.solve import SolveOptions
    from repro_torch.serve.server import AMGWireServer, TenantSpec

    cfg = AMGConfig(backend="torch", ranks="process", n_pods=N_PODS,
                    lanes=LANES, device="cpu")
    assert AMGConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict()["ranks"] == "process"
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        AMGSolver(cfg)
    for bad in (dict(setup_backend="dist"),
                *(dict(opts=SolveOptions(smoother=s)) for s in (
                    "block_jacobi", "hybrid_gs", "hybrid_gs_sym"))):
        for dtype in ("float32", "bfloat16"):
            with pytest.raises(NotImplementedError, match="item 12"):
                cfg.replace(dtype=dtype, **bad)
    # bfloat16 runs on process ranks with Jacobi and Chebyshev
    for smoother in ("jacobi", "chebyshev"):
        assert cfg.replace(dtype="bfloat16", opts=SolveOptions(
            smoother=smoother)).dtype == "bfloat16"
    with pytest.raises(NotImplementedError, match="item 12"):
        AMGService(cfg)
    with pytest.raises(NotImplementedError, match="item 12"):
        AMGWireServer({"alpha": TenantSpec(config=cfg)})
    with pytest.raises(ValueError, match="backend='torch'"):
        AMGConfig(ranks="process")
    with pytest.raises(ValueError, match="ranks must be"):
        cfg.replace(ranks="threads")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cfg.replace(device="cuda")


def test_a_failing_rank_fails_the_spawn_within_its_deadline():
    from repro_torch.launch.ranks import RankFailure, spawn

    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 1 refuses"):
        spawn(_raise_on_rank_1, 1, 2, deadline=60.0)
    assert time.monotonic() - t0 < 60.0


def _nccl_rank(ranks, size):
    """One rank of a 1×2 NCCL solve, and the stacked session of the same
    problem on this rank's card."""
    from repro_torch.amg import AMGConfig, AMGSolver
    from repro_torch.amg.problems import laplace_3d

    A = laplace_3d(size)
    b = np.random.default_rng(0).standard_normal(A.nrows)
    cfg = AMGConfig(backend="torch", ranks="process", n_pods=1, lanes=2,
                    dtype="float64", tol=1e-8)
    bound = AMGSolver(cfg).setup(A)
    res = bound.pcg(b)
    ref = AMGSolver(cfg.replace(ranks="stacked")).setup(A).pcg(b)
    dev = {str(t.device) for a in bound.dist_hierarchy._arrs
           for v in a.values()
           for t in (v.values() if isinstance(v, dict) else (v,))}
    return {"backend": ranks.backend, "devices": sorted(dev),
            "hist": list(res.residuals), "ref": list(ref.residuals),
            "x": res.x, "ref_x": ref.x}


@pytest.mark.cuda
def test_nccl_one_card_per_rank_matches_stacked():
    """NCCL needs a card of its own for every rank: a 1×2 solve at
    ``laplace_3d(16)`` against the stacked session (two or more cards)."""
    from repro_torch.launch.ranks import spawn

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs one card per rank: two cards")
    outs = spawn(_nccl_rank, 1, 2, (16,), backend="nccl", deadline=DEADLINE)
    for r, out in enumerate(outs):
        assert out["backend"] == "nccl" and out["devices"] == [f"cuda:{r}"]
        assert len(out["hist"]) == len(out["ref"])
        r0 = out["ref"][0]
        assert max(abs(a - b) for a, b in zip(out["hist"], out["ref"])) \
            <= TOL * r0
        assert out["hist"] == outs[0]["hist"]
        assert np.abs(out["x"] - out["ref_x"]).max() \
            <= TOL * np.abs(out["ref_x"]).max()


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "--jax-ref":
        sys.exit("usage: test_torch_process_ranks.py --jax-ref OUT.npz IN.npz")
    _jax_reference(sys.argv[2], sys.argv[3])
