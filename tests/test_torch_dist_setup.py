"""The port's partitioned setup phase on the CPU.

The ten non-slow tests of ``tests/test_dist_setup.py`` on the port's modules
(matrix comm-graph semantics, setup-SpGEMM selection, phase costs, the
rank-faithful matrix-row exchange under all three schedules, exact parity of
the partitioned setup loop with the host setup, the transpose exchange, the
``setup_backend`` knob), then the port held against the reference on the
same inputs:

* ``dist_setup_partitioned``: every block's ``indptr``/``indices``/``data``
  bit-equal, every record equal but its wall-clock ``*seconds``;
* ``matrix_halo_exchange``: the same halo rows and counters per strategy;
* ``refresh_partitioned_values``: bit-equal blocks after the same drift;
* ``DistHierarchy.from_partitioned`` fed the reference's levels through
  ``convert.partitioned_*``: ELL/BCSR arrays, ``dinv`` and ``coarse_inv``
  bit-equal to the reference's lowering of its own levels, and within 1e-12
  of the port's host-setup lowering with the same strategies and kernels;
* ``audit_setup``: clean, and it catches a tampered counter or strategy.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.amg import dist_setup as ref_ds  # noqa: E402
from repro.amg import problems as ref_problems  # noqa: E402
from repro.amg.csr import CSR as RefCSR  # noqa: E402
from repro.amg.dist import matrix_comm_graph as ref_matrix_comm_graph  # noqa: E402
from repro.amg.dist_solve import DistHierarchy as RefDistHierarchy  # noqa: E402
from repro.analysis.comm_audit import audit_setup as ref_audit_setup  # noqa: E402
from repro.core import BLUE_WATERS as REF_BLUE_WATERS  # noqa: E402
from repro.core import Partition as RefPartition  # noqa: E402
from repro.core import Topology as RefTopology  # noqa: E402
from repro.core.nap_collectives import (  # noqa: E402
    build_matrix_halo_plan as ref_build_matrix_halo_plan,
    matrix_halo_exchange as ref_matrix_halo_exchange)
from repro_torch.amg import AMGConfig, setup  # noqa: E402
from repro_torch.amg.csr import CSR  # noqa: E402
from repro_torch.amg.dist import (MATRIX_ENTRY, MATRIX_ROW_HEADER,  # noqa: E402
                                  OpComm, analyze_hierarchy,
                                  matrix_comm_graph, phase_costs,
                                  row_partition)
from repro_torch.amg.dist_setup import (BlockMatrix,  # noqa: E402
                                        dist_setup_partitioned,
                                        refresh_partitioned_values,
                                        split_rows, transpose_blocks)
from repro_torch.amg.dist_solve import DistHierarchy  # noqa: E402
from repro_torch.amg.problems import laplace_3d, laplace_3d_7pt  # noqa: E402
from repro_torch.analysis import audit_setup  # noqa: E402
from repro_torch.convert import (partitioned_from_arrays,  # noqa: E402
                                 partitioned_to_arrays)
from repro_torch.core import BLUE_WATERS, Partition, Topology, select  # noqa: E402
from repro_torch.core.nap_collectives import (build_matrix_halo_plan,  # noqa: E402
                                              matrix_halo_exchange)

# the reference suite's partitioned-setup cases (test_dist_setup.py:174-177)
SETUP_CASES = [(8, 2, 4, False), (6, 2, 2, True)]
CSR_FIELDS = ("indptr", "indices", "data")
OP_ARRAYS = ("ell_cols", "ell_vals", "on_cols", "on_vals", "off_cols",
             "off_vals", "send_idx", "recv_sel", "pool_sel", "bcsr_bcols",
             "bcsr_bvals", "bcsr_on_bcols", "bcsr_on_bvals")
SECONDS = ("seconds", "on_seconds", "off_seconds")


def _case_id(case):
    return "n{}-{}x{}{}".format(case[0], case[1], case[2],
                                "-aggressive" if case[3] else "")


def _assemble(bm: BlockMatrix):
    acc = bm.blocks[0]
    for b in bm.blocks[1:]:
        acc = acc.add(b)
    return acc


def _setups(n, npods, lanes, aggressive):
    """The port's and the reference's partitioned setups of laplace_3d(n)."""
    port = dist_setup_partitioned(laplace_3d(n), npods, lanes,
                                  params=BLUE_WATERS, aggressive=aggressive)
    ref = ref_ds.dist_setup_partitioned(ref_problems.laplace_3d(n), npods,
                                        lanes, params=REF_BLUE_WATERS,
                                        aggressive=aggressive)
    return port, ref


def _same_csr(a, b, what):
    assert tuple(a.shape) == tuple(b.shape), what
    for f in CSR_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f"{what}.{f}"


def _same_levels(port, ref):
    assert len(port) == len(ref)
    for l, (lp, lr) in enumerate(zip(port, ref)):
        for op in ("A", "P", "R", "AP"):
            mp, mr = getattr(lp, op), getattr(lr, op)
            assert (mp is None) == (mr is None), (l, op)
            if mp is None:
                continue
            assert np.array_equal(mp.part.offsets, mr.part.offsets), (l, op)
            for d, (bp, br) in enumerate(zip(mp.blocks, mr.blocks)):
                _same_csr(bp, br, f"L{l}.{op}.rank{d}")


def _record(rec):
    return {k: v for k, v in dataclasses.asdict(rec).items()
            if k not in SECONDS}


def _ref_levels(d):
    """The reference's ``PartitionedLevel`` s from
    :func:`partitioned_to_arrays`' dict (the test-side inverse for the
    reference's package)."""
    topo = RefTopology(n_nodes=int(d["n_pods"]), ppn=int(d["lanes"]))
    parts = [RefPartition(n=int(d[f"L{l}_offsets"][-1]), topo=topo,
                          offsets=np.array(d[f"L{l}_offsets"]))
             for l in range(int(d["n_levels"]))]
    levels = []
    for l in range(int(d["n_levels"])):
        ops = {}
        for op, shift in (("A", 0), ("P", 0), ("R", 1), ("AP", 0)):
            if f"L{l}_{op}_r0_shape" not in d:
                ops[op] = None
                continue
            blocks = [RefCSR(tuple(int(s) for s in d[f"L{l}_{op}_r{r}_shape"]),
                             *(np.array(d[f"L{l}_{op}_r{r}_{f}"])
                               for f in CSR_FIELDS))
                      for r in range(topo.n_procs)]
            ops[op] = ref_ds.BlockMatrix(blocks, parts[l + shift])
        levels.append(ref_ds.PartitionedLevel(**ops))
    return levels


# --------------------------------------------------------------------------
# matrix_comm_graph semantics + selection consistency
# --------------------------------------------------------------------------


def test_matrix_comm_graph_semantics():
    """need[p] = rows of B for rank p's off-process A columns; weights are
    whole-row byte sizes of B."""
    A = laplace_3d_7pt(4)
    h = setup(A, solver="rs", max_coarse=10)
    P = h.levels[0].P
    topo = Topology(n_nodes=2, ppn=2)
    part = row_partition(A, topo)
    g = matrix_comm_graph(A, P, part)
    assert g.partition is part                    # B rows follow A's part
    np.testing.assert_allclose(
        g.weights, np.diff(P.indptr) * MATRIX_ENTRY + MATRIX_ROW_HEADER)
    for p in range(topo.n_procs):
        lo, hi = part.local_range(p)
        sl = slice(int(A.indptr[lo]), int(A.indptr[hi]))
        cols = A.indices[sl]
        expect = np.unique(cols[(cols < lo) | (cols >= hi)])
        np.testing.assert_array_equal(g.need[p], expect)


def test_matrix_comm_graph_rectangular_b_part():
    """Pᵀ·(AP): A=R on the coarse partition, B=AP rows on the fine one."""
    A = laplace_3d(6)
    h = setup(A, solver="rs", max_coarse=30)
    R, AP = h.levels[0].R, h.levels[0].AP
    topo = Topology(n_nodes=2, ppn=2)
    cpart = Partition.balanced(R.nrows, topo)
    fpart = Partition.balanced(AP.nrows, topo)
    g = matrix_comm_graph(R, AP, cpart, b_part=fpart)
    assert g.partition is fpart
    assert g.weights.size == AP.nrows
    for p in range(topo.n_procs):
        rlo, rhi = cpart.local_range(p)
        blo, bhi = fpart.local_range(p)
        np.testing.assert_array_equal(
            g.need[p], R.offproc_columns(blo, bhi, rlo, rhi))


def test_analyze_hierarchy_spgemm_matches_select():
    """analyze_hierarchy's spgemm_AP/spgemm_PtAP rows reproduce a by-hand
    matrix_comm_graph + select on the same level operators."""
    A = laplace_3d(6)
    h = setup(A, solver="rs", max_coarse=30)
    topo = Topology(n_nodes=4, ppn=4)
    ops = {(o.level, o.op): o for o in
           analyze_hierarchy(h, topo, BLUE_WATERS)}
    for l, lv in enumerate(h.levels):
        if lv.P is None:
            continue
        part = row_partition(lv.A, topo)
        cpart = Partition.balanced(lv.P.ncols, topo)
        byhand = {
            "spgemm_AP": matrix_comm_graph(lv.A, lv.P, part),
            "spgemm_PtAP": matrix_comm_graph(lv.R, lv.AP, cpart,
                                             b_part=part),
        }
        for op, g in byhand.items():
            sel = select(g, BLUE_WATERS)
            got = ops[(l, op)].selection
            assert got.strategy == sel.strategy
            assert got.times == pytest.approx(sel.times)


def test_phase_costs_skips_missing_times():
    """An op selected over a strategy subset must not poison the per-level
    table with inf."""
    A = laplace_3d(6)
    h = setup(A, solver="rs", max_coarse=30)
    topo = Topology(n_nodes=2, ppn=2)
    part = row_partition(h.levels[0].A, topo)
    g = matrix_comm_graph(h.levels[0].A, h.levels[0].P, part)
    partial = OpComm(0, "spgemm_AP",
                     g, select(g, BLUE_WATERS, ("standard", "nap2")))
    full = OpComm(0, "spgemm_PtAP", g, select(g, BLUE_WATERS))
    costs = phase_costs([partial, full], 1)["setup"][0]
    for v in costs.values():
        assert np.isfinite(v)
    # the missing nap3 entry contributes nothing from the partial op
    assert costs["nap3"] == pytest.approx(full.selection.times["nap3"])
    assert costs["standard"] == pytest.approx(
        partial.selection.times["standard"] + full.selection.times["standard"])


# --------------------------------------------------------------------------
# Matrix-row halo exchange (MatrixHaloPlan)
# --------------------------------------------------------------------------


def _exchange_inputs(pkg_setup, pkg_problems, pkg_dist, pkg_topo, split):
    A = pkg_problems.laplace_3d(6)
    h = pkg_setup(A, solver="rs", max_coarse=30)
    P = h.levels[0].P
    topo = pkg_topo(n_nodes=2, ppn=4)
    part = pkg_dist.row_partition(A, topo)
    g = pkg_dist.matrix_comm_graph(A, P, part)
    Pb = split(P, part)

    def get_row(rank, i):
        blk = Pb.blocks[rank]
        sl = slice(int(blk.indptr[i]), int(blk.indptr[i + 1]))
        return blk.indices[sl], blk.data[sl]

    return P, topo, g, get_row


def test_matrix_halo_exchange_all_strategies():
    """Every schedule delivers exactly the needed B rows with exact values;
    node-aware schedules cross the network with no more bytes (de-dup) and
    no more messages than standard."""
    from repro_torch.amg import dist, problems

    P, topo, g, get_row = _exchange_inputs(setup, problems, dist, Topology,
                                           split_rows)
    measured = {}
    for strat in ("standard", "nap2", "nap3"):
        plan = build_matrix_halo_plan(g, strat)
        res = matrix_halo_exchange(plan, get_row)
        for q in range(topo.n_procs):
            assert set(res.halo[q]) == set(map(int, g.need[q]))
            for i, (cols, vals) in res.halo[q].items():
                sl = slice(int(P.indptr[i]), int(P.indptr[i + 1]))
                np.testing.assert_array_equal(cols, P.indices[sl])
                np.testing.assert_array_equal(vals, P.data[sl])
        measured[strat] = res
    for strat in ("nap2", "nap3"):
        assert measured[strat].inter_bytes <= measured["standard"].inter_bytes
        assert measured[strat].inter_msgs <= measured["standard"].inter_msgs
    assert measured["standard"].seconds >= 0


@pytest.mark.parametrize("strategy", ["standard", "nap2", "nap3"])
def test_matrix_halo_exchange_matches_reference(strategy):
    """The same halo rows (bit-equal payloads) and the same measured
    counters as the reference's exchange on the same graph."""
    from repro.amg import dist as ref_dist
    from repro.amg import hierarchy as ref_hierarchy
    from repro_torch.amg import dist, problems

    _, _, g, get_row = _exchange_inputs(setup, problems, dist, Topology,
                                        split_rows)
    _, _, rg, ref_get_row = _exchange_inputs(
        ref_hierarchy.setup, ref_problems, ref_dist, RefTopology,
        ref_ds.split_rows)
    got = matrix_halo_exchange(build_matrix_halo_plan(g, strategy), get_row)
    want = ref_matrix_halo_exchange(ref_build_matrix_halo_plan(rg, strategy),
                                    ref_get_row)
    assert [sorted(h) for h in got.halo] == [sorted(h) for h in want.halo]
    for hg, hw in zip(got.halo, want.halo):
        for i, (cols, vals) in hg.items():
            assert np.array_equal(cols, hw[i][0])
            assert np.array_equal(vals, hw[i][1])
    for f in ("inter_msgs", "inter_bytes", "intra_msgs", "intra_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.inter_msgs + got.intra_msgs > 0


# --------------------------------------------------------------------------
# Partitioned setup loop: exact parity with hierarchy.setup and the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,npods,lanes,aggressive", SETUP_CASES)
def test_dist_setup_partitioned_matches_host(n, npods, lanes, aggressive):
    A = laplace_3d(n)
    h = setup(A, solver="rs", aggressive=aggressive)
    plv, recs = dist_setup_partitioned(A, npods, lanes, params=BLUE_WATERS,
                                       aggressive=aggressive)
    assert len(plv) == h.n_levels
    for l, (lv, pl) in enumerate(zip(h.levels, plv)):
        for name in ("A", "P", "R", "AP"):
            ref, got = getattr(lv, name), getattr(pl, name)
            assert (ref is None) == (got is None), (l, name)
            if ref is None:
                continue
            # each rank's block holds only its own rows — never the level
            assert all(b.nnz < ref.nnz for b in got.blocks)
            asm = _assemble(got)
            assert asm.shape == ref.shape
            np.testing.assert_array_equal(asm.indptr, ref.indptr)
            np.testing.assert_array_equal(asm.indices, ref.indices)
            np.testing.assert_allclose(asm.data, ref.data, atol=1e-12)
    ops = {(r.level, r.op) for r in recs}
    for l in range(len(plv) - 1):
        assert (l, "spgemm_AP") in ops and (l, "spgemm_PtAP") in ops
    for r in recs:
        assert r.strategy in ("standard", "nap2", "nap3")
        assert r.modeled[r.strategy] == min(r.modeled.values())


@pytest.mark.parametrize("case", SETUP_CASES, ids=_case_id)
def test_dist_setup_partitioned_is_bit_identical(case):
    """The same numpy operations in the same order: every block bit-equal
    to the reference's, every record equal but its wall-clock seconds, the
    same schedules cached for replay."""
    (plv, recs), (rplv, rrecs) = _setups(*case)
    _same_levels(plv, rplv)
    assert [_record(r) for r in recs] == [_record(r) for r in rrecs]
    if case[3]:
        assert any(r.op == "spgemm_S2" for r in recs)
    for lp, lr in zip(plv, rplv):
        assert sorted(lp.plans) == sorted(lr.plans)
        for op, (strat, plan) in lp.plans.items():
            rstrat, rplan = lr.plans[op]
            assert strat == rstrat == plan.strategy
            assert [[(m.src, m.dst, list(m.indices)) for m in ph.messages]
                    for ph in plan.schedule.phases] == \
                [[(m.src, m.dst, list(m.indices)) for m in ph.messages]
                 for ph in rplan.schedule.phases], op


@pytest.mark.parametrize("case", SETUP_CASES, ids=_case_id)
def test_refresh_partitioned_values_is_bit_identical(case):
    """A drift refresh through the cached schedules: bit-equal blocks and
    equal replay records on both sides; only values change."""
    from repro.amg.csr import CSR as RCSR

    (plv, _), (rplv, _) = _setups(*case)
    A = laplace_3d(case[0])
    rng = np.random.default_rng(1)
    data = A.data * (1.0 + 0.03 * rng.random(A.nnz))
    At = CSR(A.shape, A.indptr.copy(), A.indices.copy(), data).T
    new = 0.5 * (data + At.data)
    before = [b.indices.copy() for lv in plv for b in lv.A.blocks]
    recs, rrecs = [], []
    refresh_partitioned_values(
        plv, CSR(A.shape, A.indptr.copy(), A.indices.copy(), new),
        records=recs)
    refresh_partitioned_values(
        rplv, RCSR(A.shape, A.indptr.copy(), A.indices.copy(), new.copy()),
        records=rrecs)
    _same_levels(plv, rplv)
    assert [_record(r) for r in recs] == [_record(r) for r in rrecs]
    assert all(r.modeled == {} for r in recs)           # replayed, not chosen
    assert all(np.array_equal(a, b.indices) for a, b in
               zip(before, (b for lv in plv for b in lv.A.blocks)))


def test_transpose_blocks_matches_host_transpose():
    A = laplace_3d(6)
    h = setup(A, solver="rs", max_coarse=30)
    P = h.levels[0].P
    topo = Topology(n_nodes=2, ppn=2)
    fpart = Partition.balanced(P.nrows, topo)
    cpart = Partition.balanced(P.ncols, topo)
    Rb = transpose_blocks(split_rows(P, fpart), cpart)
    R = P.T
    asm = _assemble(Rb)
    np.testing.assert_array_equal(asm.indptr, R.indptr)
    np.testing.assert_array_equal(asm.indices, R.indices)
    np.testing.assert_allclose(asm.data, R.data, atol=1e-15)


def test_dist_setup_rejects_sa():
    with pytest.raises(ValueError, match="solver='rs'"):
        dist_setup_partitioned(laplace_3d(4), 2, 2, solver="sa")


# --------------------------------------------------------------------------
# The born-partitioned lowering
# --------------------------------------------------------------------------


def _same_array(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("case", SETUP_CASES, ids=_case_id)
def test_from_partitioned_lowering_matches_reference(case):
    """The reference's partitioned levels, carried across as arrays, lower
    in the port (``DistHierarchy.from_partitioned`` on the CPU) to arrays
    bit-equal to the reference's lowering of its own levels; the setup
    records merge into the selection table as the reference's do."""
    _, (rplv, rrecs) = _setups(*case)
    d = partitioned_to_arrays(rplv)
    plv = partitioned_from_arrays(d)
    for lp, lr in zip(plv, _ref_levels(d)):          # the inverse is exact
        for op in ("A", "P", "R", "AP"):
            if getattr(lr, op) is not None:
                for bp, br in zip(getattr(lp, op).blocks,
                                  getattr(lr, op).blocks):
                    _same_csr(bp, br, op)
    _, npods, lanes, _ = case
    dh = DistHierarchy.from_partitioned(
        plv, npods, lanes, setup_records=rrecs, params=BLUE_WATERS,
        dtype=torch.float64, device="cpu")
    assert dh.h is None and dh.setup_records == rrecs
    ref_levels = RefDistHierarchy._lower_levels(
        rplv, npods, lanes, params=REF_BLUE_WATERS, strategy="auto",
        strategies=("standard", "nap2", "nap3"), dtype=np.float64)
    for rec in rrecs:                      # the reference's from_partitioned
        ref_levels[rec.level].strategies[rec.op] = rec.strategy
        ref_levels[rec.level].modeled[rec.op] = dict(rec.modeled)
    assert len(dh.levels) == len(ref_levels)
    for l, (lp, lr) in enumerate(zip(dh.levels, ref_levels)):
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
            assert (orf is None) == (opt is None)
            if orf is None:
                continue
            for f in OP_ARRAYS:
                _same_array(getattr(orf, f), getattr(opt, f), f"L{l}.{op}.{f}")
    # the lowered tensors are the lowering's arrays, on the CPU
    assert dh._arrs[0]["A"]["on_cols"].device.type == "cpu"


@pytest.mark.parametrize("case", SETUP_CASES, ids=_case_id)
def test_from_partitioned_matches_host_setup_lowering(case):
    """The port's own born-partitioned lowering against its host-setup
    lowering of the same matrix: the same ELL column maps, strategies and
    kernel table, values / ``dinv`` / ``coarse_inv`` within 1e-12."""
    n, npods, lanes, aggressive = case
    A = laplace_3d(n)
    plv, recs = dist_setup_partitioned(A, npods, lanes, params=BLUE_WATERS,
                                       aggressive=aggressive)
    dh = DistHierarchy.from_partitioned(plv, npods, lanes, setup_records=recs,
                                        params=BLUE_WATERS,
                                        dtype=torch.float64, device="cpu")
    h = setup(A, solver="rs", aggressive=aggressive)
    dh_host = DistHierarchy.build(h, npods, lanes, params=BLUE_WATERS,
                                  dtype=torch.float64, device="cpu")
    assert len(dh.levels) == len(dh_host.levels)
    assert dh.kernel_table() == dh_host.kernel_table()
    for l, (a, c) in enumerate(zip(dh.levels, dh_host.levels)):
        pairs = [(a.A, c.A)] + ([(a.P, c.P), (a.R, c.R)]
                                if a.P is not None else [])
        for x, y in pairs:
            assert x.strategy == y.strategy, l
            assert np.array_equal(x.ell_cols, y.ell_cols), l
            assert np.abs(x.ell_vals - y.ell_vals).max() <= 1e-12, l
        assert np.abs(a.dinv - c.dinv).max() <= 1e-12, l
        if a.coarse_inv is not None:
            assert np.abs(a.coarse_inv - c.coarse_inv).max() <= 1e-12, l
        for op in ("spmv_A", "interp", "restrict"):
            assert a.strategies.get(op) == c.strategies.get(op), (l, op)
    # every coarsening level recorded both Galerkin SpGEMM selections
    sel = {(r["level"], r["op"]): r for r in dh.selection_table()}
    for l in range(len(dh.levels) - 1):
        for op in ("spgemm_AP", "spgemm_PtAP"):
            row = sel[(l, op)]
            assert row["modeled"][row["strategy"]] == \
                min(row["modeled"].values())


def test_dist_setup_entry_point_lowers_on_the_cpu():
    """``dist_setup`` runs the partitioned setup and lowers it: no host
    hierarchy, the records kept, a PCG that converges."""
    from repro_torch.amg.dist_setup import dist_setup
    from repro_torch.amg.dist_solve import dist_pcg

    A = laplace_3d(8)
    dh = dist_setup(A, 2, 4, dtype=torch.float64, device="cpu")
    assert dh.h is None and dh.setup_records and dh.dtype == torch.float64
    res = dist_pcg(dh, A.matvec(np.ones(A.nrows)), tol=1e-10, maxiter=40)
    assert res.converged


# --------------------------------------------------------------------------
# Setup audit
# --------------------------------------------------------------------------


def test_setup_audit_clean_and_tampered():
    plv, recs = dist_setup_partitioned(laplace_3d(6), 2, 2)
    rows, vio = audit_setup(plv, recs)
    assert rows and not vio, [str(v) for v in vio]
    for r in rows:
        assert r["static_inter_msgs"] == r["runtime_inter_msgs"]
        assert r["static_intra_msgs"] == r["runtime_intra_msgs"]
    # the same rows as the reference's audit of its own setup
    rplv, rrecs = ref_ds.dist_setup_partitioned(ref_problems.laplace_3d(6),
                                                2, 2)
    assert rows == ref_audit_setup(rplv, rrecs)[0]
    # a measured counter drifting off the selected schedule must be caught
    bad = [dataclasses.replace(recs[0], inter_msgs=recs[0].inter_msgs + 1)]
    _, vio2 = audit_setup(plv, bad + recs[1:])
    assert any(v.kind == "setup-count-mismatch" for v in vio2)
    # ... as must an exchange that ran a different strategy than cached
    other = "nap3" if recs[0].strategy != "nap3" else "nap2"
    bad2 = [dataclasses.replace(recs[0], strategy=other)]
    _, vio3 = audit_setup(plv, bad2 + recs[1:])
    assert any(v.kind == "strategy-mismatch" for v in vio3)
    # ... and measured inter bytes off the schedule's
    bad3 = [dataclasses.replace(recs[0],
                                inter_bytes=recs[0].inter_bytes + 8.0)]
    _, vio4 = audit_setup(plv, bad3 + recs[1:])
    assert [v.kind for v in vio4] == ["setup-bytes-mismatch"]


# --------------------------------------------------------------------------
# Config knob
# --------------------------------------------------------------------------


def test_setup_backend_config_validation_and_roundtrip():
    cfg = AMGConfig(setup_backend="dist", backend="torch", n_pods=2, lanes=4,
                    device="cpu")
    d = cfg.to_dict()
    assert d["setup_backend"] == "dist"
    assert AMGConfig.from_dict(d) == cfg
    assert AMGConfig.from_wire(cfg.to_wire()) == cfg
    assert cfg.setup_kwargs()["solver"] == "rs"
    assert cfg.dist_build_kwargs()["n_pods"] == 2
    with pytest.raises(ValueError, match="backend"):
        AMGConfig(setup_backend="dist")            # host solve backend
    with pytest.raises(ValueError, match="setup_backend"):
        AMGConfig(setup_backend="bogus")
    with pytest.raises(ValueError, match="solver='rs'"):
        AMGConfig(setup_backend="dist", backend="torch", solver="sa",
                  device="cpu")
    # the function entry point lives on the submodule (NOT re-exported from
    # repro_torch.amg — it would collide with the submodule name there)
    import repro_torch.amg
    import repro_torch.amg.dist_setup
    assert callable(repro_torch.amg.dist_setup.dist_setup)
    with pytest.raises(AttributeError):
        repro_torch.amg.no_such_symbol
