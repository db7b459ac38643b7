"""The port's collectives on rank-stacked tensors: the halo of every
strategy equals ``x[need]`` bit for bit (one RHS and ``[m, k]``, empty
halos included), every exchange logs exactly its strategy's signature, and
the NAP-3 all-reduce / hierarchical all-gather compute the flat results.

``hier_all_to_all`` (flat and NAP-3 on 1×8, 2×4 and 4×2): bit-equal to the
reference's under ``shard_map`` on 8 host devices (a JAX subprocess of this
file) on the chunk pattern ``100·d + e`` of ``tests/multidev_script.py`` and
on random chunks, bit-equal across strategies, each logging its signature;
and its process form on 8 gloo ranks bit-equal to the stacked form::

    python tests/test_torch_nap_collectives.py --jax-ref OUT.npz
"""
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

A2A_MESHES = [(1, 8), (2, 4), (4, 2)]
A2A_STRATEGIES = ("flat", "nap3")


def _a2a_inputs():
    """``[8, 8, ...]`` chunks (sender, destination): the pattern chunk
    ``d → e`` = ``100·d + e`` (three copies) and random ``[2, 3]`` ones."""
    D = 8
    pattern = np.zeros((D, D, 3), np.float32)
    for d in range(D):
        for e in range(D):
            pattern[d, e] = 100 * d + e
    rand = np.random.default_rng(6).standard_normal((D, D, 2, 3))
    return {"pattern": pattern, "random": rand.astype(np.float32)}


def _jax_reference(out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.core.compat import shard_map
    from repro.core.nap_collectives import hier_all_to_all as jhier_all_to_all

    out = {}
    for mesh_shape in A2A_MESHES:
        mesh = jax.make_mesh(mesh_shape, ("pod", "lane"))
        spec = P(("pod", "lane"))
        for strategy in A2A_STRATEGIES:
            f = jax.jit(shard_map(
                lambda a, s=strategy: jhier_all_to_all(a[0], "pod", "lane",
                                                       s)[None],
                mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False))
            for name, x in _a2a_inputs().items():
                key = f"{name}_{mesh_shape[0]}x{mesh_shape[1]}_{strategy}"
                out[key] = np.asarray(f(x))
    np.savez(out_path, **out)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "--jax-ref":
        sys.exit("usage: test_torch_nap_collectives.py --jax-ref OUT.npz")
    _jax_reference(sys.argv[2])
    sys.exit(0)

torch = pytest.importorskip("torch")

from repro_torch.amg.csr import CSR  # noqa: E402
from repro_torch.amg.dist import vector_comm_graph  # noqa: E402
from repro_torch.amg.problems import laplace_3d  # noqa: E402
from repro_torch.core.nap_collectives import (  # noqa: E402
    ALL_TO_ALL_SIGNATURES, GATHER_SIGNATURES, HALO_SIGNATURES,
    REDUCE_SIGNATURES, all_to_all_signature, build_halo_plan, halo_exchange,
    halo_signature, hier_all_gather, hier_all_to_all, hier_psum)
from repro_torch.core.topology import Partition, Topology  # noqa: E402

MESHES = [(1, 1), (2, 4), (4, 2)]
STRATEGIES = ["standard", "nap2", "nap3"]


def _random_sparse(n, seed, density=0.02):
    rng = np.random.default_rng(seed)
    nnz = int(n * n * density)
    r = np.concatenate([np.arange(n), rng.integers(0, n, nnz)])
    c = np.concatenate([np.arange(n), rng.integers(0, n, nnz)])
    return CSR.from_coo(r, c, np.ones(r.size), (n, n))


def _block_diagonal(n, topo):
    """An operator aligned to the partition: no rank needs any other's x."""
    part = Partition.balanced(n, topo)
    rows, cols = [], []
    for d in range(topo.n_procs):
        lo, hi = part.local_range(d)
        ii, jj = np.meshgrid(np.arange(lo, hi), np.arange(lo, hi))
        rows.append(ii.ravel())
        cols.append(jj.ravel())
    r, c = np.concatenate(rows), np.concatenate(cols)
    return CSR.from_coo(r, c, np.ones(r.size), (n, n))


def _plan_tensors(plan):
    psel = None if plan.pool_sel is None else torch.as_tensor(
        plan.pool_sel, dtype=torch.int64)
    return (torch.as_tensor(plan.send_idx, dtype=torch.int64),
            torch.as_tensor(plan.recv_sel, dtype=torch.int64), psel)


def _stacked(part, x):
    """Global ``[n(, k)]`` → ``[D, local_n(, k)]`` (zero-padded rows)."""
    D = part.topo.n_procs
    out = np.zeros((D, part.max_local_size) + x.shape[1:])
    for d in range(D):
        lo, hi = part.local_range(d)
        out[d, : hi - lo] = x[lo:hi]
    return torch.as_tensor(out)


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("matrix", ["laplace", "random", "empty"])
def test_halo_equals_needed_entries_bitwise(matrix, mesh, strategy, k):
    n_pods, lanes = mesh
    topo = Topology(n_nodes=n_pods, ppn=lanes)
    A = {"laplace": lambda: laplace_3d(6),
         "random": lambda: _random_sparse(150, seed=n_pods * 7 + lanes),
         "empty": lambda: _block_diagonal(96, topo)}[matrix]()
    part = Partition.balanced(A.nrows, topo)
    graph = vector_comm_graph(A, part)
    plan = build_halo_plan(graph, n_pods, lanes, strategy)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((A.nrows,) if k is None else (A.nrows, k))
    log = []
    halo = halo_exchange(_stacked(part, x), plan, *_plan_tensors(plan),
                         log=log).numpy()
    assert log == list(HALO_SIGNATURES[strategy])
    D = topo.n_procs
    ext = x.shape[1:]
    assert halo.shape == (D, plan.halo_len) + ext
    for d in range(D):
        need = np.sort(graph.need[d])
        assert np.array_equal(halo[d, : need.size], x[need]), d
        assert not halo[d, need.size:].any(), d      # -1 slots: exact 0
    if matrix == "empty" or D == 1:
        assert plan.total_halo == 0 and halo_signature(plan) == ()
    else:
        assert plan.total_halo > 0
        assert halo_signature(plan) == HALO_SIGNATURES[strategy]


@pytest.mark.parametrize("shape", [(), (5,), (3, 2)])
@pytest.mark.parametrize("strategy", ["flat", "nap3"])
@pytest.mark.parametrize("mesh", MESHES)
def test_hier_psum_is_the_all_reduce(mesh, strategy, shape):
    D = mesh[0] * mesh[1]
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((D,) + shape))
    log = []
    out = hier_psum(x, *mesh, strategy=strategy, log=log)
    assert log == list(REDUCE_SIGNATURES[strategy])
    assert out.shape == x.shape
    want = x.sum(dim=0)
    for d in range(D):
        # the NAP-3 form sums lanes first, then pods: order differs
        torch.testing.assert_close(out[d], want, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("strategy", ["flat", "nap3"])
@pytest.mark.parametrize("mesh", MESHES)
def test_hier_all_gather_is_pod_major(mesh, strategy, k):
    D = mesh[0] * mesh[1]
    m = 3
    x = torch.arange(D * m * (k or 1), dtype=torch.float64).reshape(
        (D, m) + (() if k is None else (k,)))
    log = []
    out = hier_all_gather(x, *mesh, strategy=strategy, log=log)
    assert log == list(GATHER_SIGNATURES[strategy])
    for d in range(D):
        assert torch.equal(out[d], x.reshape((D * m,) + x.shape[2:]))


# ----------------------------------------------------------- all-to-all
def _a2a_rank(ranks):
    """One gloo rank: every mesh and strategy over the 8 processes, against
    the stacked form's row (runs in the spawned processes)."""
    from repro_torch.core.nap_collectives import rank_groups

    d = ranks.rank
    out = {}
    for n_pods, lanes in A2A_MESHES:
        mesh = rank_groups(n_pods, lanes)
        for strategy in A2A_STRATEGIES:
            for name, x in _a2a_inputs().items():
                x = torch.from_numpy(x)
                log = []
                mine = hier_all_to_all(x[d:d + 1], n_pods, lanes, strategy,
                                       log=log, ranks=mesh)
                key = f"{name}_{n_pods}x{lanes}_{strategy}"
                out[key] = (mine[0].numpy(), hier_all_to_all(
                    x, n_pods, lanes, strategy)[d].numpy(), tuple(log))
    return out


@pytest.fixture(scope="module")
def a2a_runs(tmp_path_factory):
    """The reference's all-to-alls (a JAX subprocess) and every gloo rank's,
    run side by side."""
    from repro_torch.launch.ranks import spawn

    out_path = tmp_path_factory.mktemp("a2a_ref") / "out.npz"
    env = dict(os.environ)
    root = pathlib.Path(__file__).parents[1]
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    jax_ref = subprocess.Popen(
        [sys.executable, __file__, "--jax-ref", str(out_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = spawn(_a2a_rank, 2, 4, deadline=120.0)
        stdout, stderr = jax_ref.communicate(timeout=300)
    finally:
        if jax_ref.poll() is None:
            jax_ref.kill()
            jax_ref.communicate()
    assert jax_ref.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    return dict(np.load(out_path)), ranks


@pytest.mark.parametrize("strategy", A2A_STRATEGIES)
@pytest.mark.parametrize("mesh", A2A_MESHES)
def test_hier_all_to_all_is_bit_equal_to_the_reference(a2a_runs, mesh,
                                                       strategy):
    ref = a2a_runs[0]
    D = mesh[0] * mesh[1]
    for name, x in _a2a_inputs().items():
        log = []
        got = hier_all_to_all(torch.from_numpy(x), *mesh, strategy, log=log)
        assert log == list(ALL_TO_ALL_SIGNATURES[strategy])
        want = ref[f"{name}_{mesh[0]}x{mesh[1]}_{strategy}"]
        assert got.shape == want.shape and np.array_equal(got.numpy(), want)
        if name == "pattern":
            for e in range(D):
                for d in range(D):
                    assert (got[e, d] == 100 * d + e).all(), (e, d)


@pytest.mark.parametrize("shape", [(), (5,), (3, 2)])
@pytest.mark.parametrize("mesh", A2A_MESHES + [(1, 1), (3, 2)])
def test_hier_all_to_all_nap3_is_bit_equal_to_flat(mesh, shape):
    D = mesh[0] * mesh[1]
    x = torch.as_tensor(np.random.default_rng(D).standard_normal(
        (D, D) + shape))
    logs = {s: [] for s in A2A_STRATEGIES}
    out = {s: hier_all_to_all(x, *mesh, s, log=logs[s])
           for s in A2A_STRATEGIES}
    assert torch.equal(out["nap3"], out["flat"])
    assert torch.equal(out["flat"], x.transpose(0, 1))
    for s in A2A_STRATEGIES:
        assert tuple(logs[s]) == all_to_all_signature(s)


def test_hier_all_to_all_refuses_bad_input():
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="unknown strategy"):
        hier_all_to_all(x, 2, 4, "nap2")
    with pytest.raises(ValueError, match="8 chunks for 6 ranks"):
        hier_all_to_all(x, 2, 3)
    other_grid = types.SimpleNamespace(n_pods=4, lanes=2)
    with pytest.raises(ValueError, match="2 x 4 grid over 4 x 2 ranks"):
        hier_all_to_all(x[:1], 2, 4, "nap3", ranks=other_grid)


@pytest.mark.parametrize("strategy", A2A_STRATEGIES)
@pytest.mark.parametrize("mesh", A2A_MESHES)
def test_hier_all_to_all_on_gloo_ranks_is_bit_equal_to_stacked(a2a_runs,
                                                              mesh, strategy):
    ref, ranks = a2a_runs
    for name in _a2a_inputs():
        key = f"{name}_{mesh[0]}x{mesh[1]}_{strategy}"
        for d, out in enumerate(ranks):
            mine, stacked, log = out[key]
            assert log == ALL_TO_ALL_SIGNATURES[strategy]
            assert np.array_equal(mine, stacked)
            assert np.array_equal(mine, ref[key][d])
