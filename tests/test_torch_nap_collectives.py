"""The port's collectives on rank-stacked tensors: the halo of every
strategy equals ``x[need]`` bit for bit (one RHS and ``[m, k]``, empty
halos included), every exchange logs exactly its strategy's signature, and
the NAP-3 all-reduce / hierarchical all-gather compute the flat results."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.amg.csr import CSR  # noqa: E402
from repro_torch.amg.dist import vector_comm_graph  # noqa: E402
from repro_torch.amg.problems import laplace_3d  # noqa: E402
from repro_torch.core.nap_collectives import (  # noqa: E402
    GATHER_SIGNATURES, HALO_SIGNATURES, REDUCE_SIGNATURES, build_halo_plan,
    halo_exchange, halo_signature, hier_all_gather, hier_psum)
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
