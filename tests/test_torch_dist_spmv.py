"""``DistOperator.apply`` on rank-stacked tensors (CPU, float64): square A
(ELL and BCSR layouts) and rectangular P/R, every strategy, both the
overlapped ``A_on·x + A_off·halo`` form and the fused serial form, one RHS
and ``[n, k]`` — all against ``CSR.matvec`` at 1e-12, with the collective
log of each apply equal to the operator's halo signature."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.amg.csr import CSR  # noqa: E402
from repro_torch.amg.dist_spmv import build_dist_operator  # noqa: E402
from repro_torch.amg.hierarchy import setup  # noqa: E402
from repro_torch.amg.problems import laplace_3d, laplace_3d_7pt  # noqa: E402
from repro_torch.core.topology import Partition, Topology  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ops_by_kind():
    """Square A (a 27-point and a 7-point level), rectangular P and R."""
    h = setup(laplace_3d_7pt(6), solver="rs", max_coarse=30)
    A27 = laplace_3d(7)
    lv = h.levels[0]
    return {"A27": (A27, None, None), "A7c": (h.levels[1].A, None, None),
            "P": (lv.P, lv.A.nrows, lv.P.ncols),
            "R": (lv.R, lv.P.ncols, lv.A.nrows)}


def _apply(op, x, overlap, use_kernel=None):
    log = []
    arrs = op.to_device(CPU, torch.float64)
    xd = torch.as_tensor(op.scatter_x(x, dtype=np.float64))
    y = op.apply(arrs, xd, use_kernel=use_kernel is not False,
                 overlap=overlap, log=log)
    assert y.shape[:2] == (op.n_devices, op.rows_local)
    return op.gather_y(y.numpy()), log


def _matvec(M, x):
    if x.ndim == 1:
        return M.matvec(x)
    return np.stack([M.matvec(x[:, j]) for j in range(x.shape[1])], axis=1)


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("strategy", ["standard", "nap2", "nap3"])
@pytest.mark.parametrize("kind", ["A27", "A7c", "P", "R", "A27-bcsr8",
                                  "A27-bcsr16"])
def test_apply_matches_csr_matvec(ops_by_kind, kind, strategy, overlap, k):
    M, nrows, ncols = ops_by_kind[kind.split("-")[0]]
    topo = Topology(n_nodes=2, ppn=4)
    row_part = Partition.balanced(nrows or M.nrows, topo)
    col_part = Partition.balanced(ncols or M.ncols, topo)
    op = build_dist_operator(M, 2, 4, strategy, row_part=row_part,
                             col_part=col_part, dtype=np.float64)
    if "bcsr" in kind:
        op.lower_bcsr(int(kind[len("A27-bcsr"):]))
        assert op.local_kernel == "bcsr"
    rng = np.random.default_rng(3)
    x = rng.standard_normal((M.ncols,) if k is None else (M.ncols, k))
    y, log = _apply(op, x, overlap)
    want = _matvec(M, x)
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    assert not op.halo_empty
    assert log == list(op.expected_signature)
    # the plain versions, asked for explicitly, give the same product
    y_plain, _ = _apply(op, x, overlap, use_kernel=False)
    np.testing.assert_allclose(y_plain, y, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("overlap", [True, False])
def test_empty_halo_apply_runs_no_exchange(overlap):
    """A partition-aligned block-diagonal operator (8×1 rank grid): the
    apply logs no collective and still matches the dense product."""
    n = 96
    topo = Topology(n_nodes=8, ppn=1)
    part = Partition.balanced(n, topo)
    rng = np.random.default_rng(0)
    dense = np.zeros((n, n))
    for d in range(8):
        lo, hi = part.local_range(d)
        dense[lo:hi, lo:hi] = rng.normal(size=(hi - lo, hi - lo))
    r, c = np.nonzero(dense)
    M = CSR.from_coo(r, c, dense[r, c], (n, n))
    op = build_dist_operator(M, 8, 1, "standard", dtype=np.float64)
    assert op.halo_empty and op.onoff_nnz()["off_nnz"] == 0
    x = rng.normal(size=n)
    op_bcsr = copy.copy(op)
    op_bcsr.lower_bcsr(8)
    for o in (op, op_bcsr):             # the ELL and the BCSR on-part
        y, log = _apply(o, x, overlap)
        assert log == [] and o.expected_signature == ()
        np.testing.assert_allclose(y, dense @ x, rtol=0, atol=1e-12)


def test_program_collective_logs_follow_the_signatures():
    """One program's collective log, recorded through
    ``DistHierarchy.comm_log``, is exactly what the selected strategies
    predict: the residual norm is one A apply then one all-reduce, and a
    PCG step's counts follow the V-cycle's structure."""
    from collections import Counter

    from repro_torch.amg import SolveOptions, pcg
    from repro_torch.amg.dist_solve import DistHierarchy, dist_pcg
    from repro_torch.core.nap_collectives import (gather_signature,
                                                  halo_signature,
                                                  reduce_signature)

    A = laplace_3d(8)
    h = setup(A, solver="rs", max_coarse=30)
    dh = DistHierarchy.build(h, 2, 4, dtype=torch.float64, device="cpu")
    opts = SolveOptions()
    b = dh.scatter(np.ones(A.nrows))
    x = torch.zeros_like(b)
    dh.comm_log = []
    dh.resid_norm(x, b, opts)
    assert dh.comm_log == (list(halo_signature(dh.levels[0].A.plan))
                           + list(reduce_signature("nap3")))
    r, z, rz, _ = dh.pcg_init(x, b, opts)
    dh.comm_log = []
    dh.pcg_step(x, r, z, rz, opts)
    want = Counter()
    for dl in dh.levels:
        if dl.coarse_inv is not None:
            want.update(gather_signature("nap3"))
            continue
        for _ in range(opts.presweeps + opts.postsweeps + 1):
            want.update(halo_signature(dl.A.plan))
        want.update(halo_signature(dl.R.plan) + halo_signature(dl.P.plan))
    want.update(halo_signature(dh.levels[0].A.plan))     # A·p
    want.update(reduce_signature("nap3") * 3)            # pAp, |r|, r·z
    assert Counter(dh.comm_log) == want and sum(want.values()) > 0
    dh.comm_log = None
    # the free function binds the same lowering through the torch backend
    bh = np.ones(A.nrows)
    got = pcg(h, bh, tol=1e-8, backend="torch", dist=dh)
    ref = dist_pcg(dh, bh, tol=1e-8)
    assert got.converged and got.residuals == ref.residuals
