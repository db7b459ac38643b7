"""The port's numpy copies against the reference: bit-identical host setup
(every level's A/P/R/AP) and bit-identical lowering (strategies, ELL and
on/off blocks, BCSR blocks, halo-plan index arrays, smoother data) on 2×4
and 4×2 rank grids."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.amg import hierarchy as ref_hierarchy  # noqa: E402
from repro.amg import problems as ref_problems  # noqa: E402
from repro.amg.dist_solve import DistHierarchy as RefDistHierarchy  # noqa: E402
from repro.core import BLUE_WATERS as REF_BLUE_WATERS  # noqa: E402
from repro.core import TPU_V5E as REF_TPU_V5E  # noqa: E402
from repro_torch.amg import hierarchy as port_hierarchy  # noqa: E402
from repro_torch.amg import problems as port_problems  # noqa: E402
from repro_torch.amg.dist_solve import DistHierarchy  # noqa: E402
from repro_torch.core import BLUE_WATERS, TPU_V5E  # noqa: E402

PROBLEMS = [("laplace_3d", 8, "rs"), ("laplace_3d", 10, "rs"),
            ("laplace_3d_7pt", 6, "rs"), ("laplace_3d", 8, "sa")]
CSR_FIELDS = ("indptr", "indices", "data")
OP_ARRAYS = ("ell_cols", "ell_vals", "on_cols", "on_vals", "off_cols",
             "off_vals", "send_idx", "recv_sel", "pool_sel", "bcsr_bcols",
             "bcsr_bvals", "bcsr_on_bcols", "bcsr_on_bvals")
PLAN_FIELDS = ("strategy", "n_pods", "lanes", "local_n", "halo_len",
               "pool_len", "contrib_len", "total_halo")


def _setups(name, size, solver):
    ref = ref_hierarchy.setup(getattr(ref_problems, name)(size),
                              solver=solver, max_coarse=30)
    port = port_hierarchy.setup(getattr(port_problems, name)(size),
                                solver=solver, max_coarse=30)
    return ref, port


def _same_csr(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert tuple(a.shape) == tuple(b.shape), what
    for f in CSR_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f"{what}.{f}"


def _same_array(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert a.dtype == b.dtype and a.shape == b.shape, \
        f"{what}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("name,size,solver", PROBLEMS)
def test_setup_is_bit_identical(name, size, solver):
    ref, port = _setups(name, size, solver)
    assert port.n_levels == ref.n_levels >= 2
    for l, (lr, lp) in enumerate(zip(ref.levels, port.levels)):
        for op in ("A", "P", "R", "AP"):
            _same_csr(getattr(lr, op), getattr(lp, op), f"L{l}.{op}")


@pytest.mark.parametrize("mesh", [(2, 4), (4, 2)])
@pytest.mark.parametrize("strategy,machine", [
    ("auto", "tpu_v5e"), ("auto", "blue_waters"), ("standard", "tpu_v5e"),
    ("nap2", "tpu_v5e"), ("nap3", "tpu_v5e")])
@pytest.mark.parametrize("name,size,solver", PROBLEMS[:3])
def test_lower_levels_is_bit_identical(name, size, solver, strategy, machine,
                                       mesh):
    ref, port = _setups(name, size, solver)
    kw = dict(strategy=strategy, strategies=("standard", "nap2", "nap3"),
              dtype=np.float64)
    # tpu_v5e is the default machine model; blue_waters makes "auto" pick
    # node-aware strategies on more levels
    ref_params, params = {"tpu_v5e": (REF_TPU_V5E, TPU_V5E),
                          "blue_waters": (REF_BLUE_WATERS, BLUE_WATERS)}[machine]
    lr_all = RefDistHierarchy._lower_levels(ref.levels, *mesh,
                                            params=ref_params, **kw)
    lp_all = DistHierarchy._lower_levels(port.levels, *mesh, params=params,
                                         **kw)
    assert len(lr_all) == len(lp_all)
    for l, (lr, lp) in enumerate(zip(lr_all, lp_all)):
        assert lp.strategies == lr.strategies, l
        assert lp.modeled == lr.modeled, l
        assert lp.local_kernel == lr.local_kernel, l
        assert lp.comm_stats == lr.comm_stats, l
        assert lp.onoff == lr.onoff, l
        assert lp.rho == lr.rho, l
        _same_array(lr.dinv, lp.dinv, f"L{l}.dinv")
        _same_array(lr.coarse_inv, lp.coarse_inv, f"L{l}.coarse_inv")
        for op in ("A", "P", "R"):
            orf, opt = getattr(lr, op), getattr(lp, op)
            if orf is None:
                assert opt is None
                continue
            assert opt.block_size == orf.block_size
            assert opt.rows_local == orf.rows_local
            for f in PLAN_FIELDS:
                assert getattr(opt.plan, f) == getattr(orf.plan, f), \
                    f"L{l}.{op}.plan.{f}"
            _same_array(orf.plan.pool_sel, opt.plan.pool_sel,
                        f"L{l}.{op}.plan.pool_sel")
            for f in OP_ARRAYS:
                _same_array(getattr(orf, f), getattr(opt, f), f"L{l}.{op}.{f}")


@pytest.mark.parametrize("mesh", [(2, 4), (4, 2)])
def test_local_square_block_is_bit_identical(mesh):
    from repro.amg.dist_spmv import local_square_block as ref_block
    from repro.core.topology import Partition as RefPartition
    from repro.core.topology import Topology as RefTopology
    from repro_torch.amg.dist_spmv import local_square_block
    from repro_torch.core.topology import Partition, Topology

    ref, port = _setups("laplace_3d", 8, "rs")
    for lr, lp in zip(ref.levels, port.levels):
        pr = RefPartition.balanced(lr.A.nrows, RefTopology(*mesh))
        pp = Partition.balanced(lp.A.nrows, Topology(*mesh))
        for d in range(mesh[0] * mesh[1]):
            _same_csr(ref_block(lr.A, pr, d), local_square_block(lp.A, pp, d),
                      f"rank {d}")


def test_lowering_covers_every_strategy_and_layout():
    """The bit-equality grid above is not vacuous: on these problems the
    model picks all three strategies somewhere and some level lowers to
    BCSR (with the default TPU_V5E params too)."""
    _, port = _setups("laplace_3d", 10, "rs")
    seen, kernels = set(), set()
    for params in (BLUE_WATERS, TPU_V5E):
        for mesh in ((2, 4), (4, 2)):
            lv = DistHierarchy._lower_levels(
                port.levels, *mesh, params=params, strategy="auto",
                strategies=("standard", "nap2", "nap3"), dtype=np.float64)
            seen |= {s for dl in lv for s in dl.strategies.values()}
            kernels |= {dl.A.local_kernel for dl in lv}
    assert seen == {"standard", "nap2", "nap3"}, seen
    assert kernels == {"ell", "bcsr"}, kernels


@pytest.mark.parametrize("seed", range(4))
def test_layout_heuristic_matches_reference(seed):
    from repro.kernels.spmv.ops import select_dist_kernel as ref_dist
    from repro.kernels.spmv.ops import select_local_kernel as ref_local
    from repro_torch.kernels.spmv.ops import (select_dist_kernel,
                                              select_local_kernel)

    rng = np.random.default_rng(seed)
    D, n, K = 3, 40, 9
    base = rng.integers(0, 48, size=(D, n, 1))
    cols = (base + rng.integers(0, 12, size=(D, n, K))).astype(np.int32)
    cols[rng.random((D, n, K)) < 0.2 * seed] = -1
    assert select_dist_kernel(cols) == ref_dist(cols)
    for d in range(D):
        assert select_local_kernel(cols[d]) == ref_local(cols[d])
