"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's ``repro/launch/roofline.py``.

* Collective totals and the pod-crossing classification from logged rank
  lists agree with the reference's ``_parse_groups`` /
  ``parse_collectives`` on ``tests/test_roofline.py``'s HLO snippets: each
  snippet's groups become the port's logged ranks (a traced rank logs its
  own group; by symmetry every group of a collective spans the same
  axes), its result shapes the logged shapes.
* ``roofline_terms``' arithmetic on the H100 constants.
* ``CollectiveLog`` records what a fake group's collectives carry.
* The ERT micro-kernels: their CPU path is the plain version (on the card
  each is held to its plain version in ``tests/test_torch_cuda_kernels.py``,
  a file that does not import JAX).
"""
import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.roofline import (CollectiveLog,  # noqa: E402
                                         LoggedCollective, collective_totals,
                                         crosses_pod, parse_log,
                                         roofline_terms)

HLO = """
HloModule test
%all-reduce.1 = f32[16,4096]{1,0} all-reduce(%x), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
%all-gather.2 = (bf16[8,128]{1,0}, bf16[8,128]{1,0}) all-gather(%a, %b), replica_groups=[4,2]<=[8], dimensions={0}
%all-to-all.3 = f32[2,64]{1,0} all-to-all(%c), replica_groups={{0,4},{1,5},{2,6},{3,7}}
%all-gather-start.4 = f32[100]{0} all-gather-start(%d), replica_groups={{0,1}}
%all-gather-done.5 = f32[100]{0} all-gather-done(%all-gather-start.4)
%reduce-scatter.6 = f32[10]{0} reduce-scatter(%e), replica_groups={}
%get-tuple-element.9 = f32[2,64]{1,0} get-tuple-element(%all-to-all.3), index=0
%all-gather.9 = f32[4]{0} all-gather(%x), replica_groups=[2,4]<=[4,2]T(1,0), dimensions={0}
"""
_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _as_log(hlo: str) -> tuple[list, list]:
    """(the reference's infos, the port's log entries) of each collective
    line: the entry's ranks are the line's first group, its shapes the
    line's result shapes."""
    ref, log = [], []
    for line in hlo.splitlines():
        m = jroof._COLL_RE.search(line)
        if not m or m.group("suffix") == "-done":
            continue
        info = jroof.parse_collectives(line, pod_size=4, n_devices=8)[0]
        groups = jroof._parse_groups(line)
        shapes = [(dt, tuple(int(d) for d in dims.split(",") if d))
                  for dt, dims in jroof._SHAPE_RE.findall(m.group("shapes"))]
        log.append(LoggedCollective(
            info.op, info.op, tuple(groups[0]) if groups else (),
            tuple(s for _, s in shapes), tuple(_DT[d] for d, _ in shapes)))
        ref.append((info, groups))
    return ref, log


def test_totals_and_classification_match_reference():
    ref, log = _as_log(HLO)
    infos = parse_log(log, pod_size=4, n_devices=8)
    for (r, groups), got, e in zip(ref, infos, log):
        assert got.op == r.op and got.bytes == r.bytes
        assert got.group_size == r.group_size
        # one logged group classifies as all of the line's groups do
        assert got.crosses_pod == r.crosses_pod
        if groups:
            assert crosses_pod(groups, 4) == r.crosses_pod
            assert all(crosses_pod([g], 4) == r.crosses_pod for g in groups)
    want = jroof.collective_bytes_from_text(HLO, pod_size=4, n_devices=8)
    got = collective_totals(log, pod_size=4, n_devices=8)
    assert got == {**want, "by_op": dict(sorted(want["by_op"].items()))}
    assert 0 < got["cross_slow_bytes"] < got["total_bytes"]


@pytest.mark.parametrize("line", [l for l in HLO.splitlines()
                                  if jroof._COLL_RE.search(l)
                                  and "-done" not in l])
def test_each_snippet_line_matches_reference(line):
    ref, log = _as_log(line)
    assert collective_totals(log, 4, 8) == {
        **jroof.collective_bytes_from_text(line, 4, 8)}
    assert [i.crosses_pod for i in parse_log(log, 4, 8)] == \
        [r.crosses_pod for r, _ in ref]


def test_roofline_terms_arithmetic_on_h100_constants():
    coll = {"total_bytes": roofline.NVLINK_BW,
            "cross_slow_bytes": roofline.INTER_NODE_BW / 2}
    t = roofline_terms(roofline.PEAK_FLOPS_BF16, roofline.HBM_BW * 2, coll,
                       n_chips=256, model_flops=roofline.PEAK_FLOPS_BF16 * 256)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(2.0)
    assert t.collective_s == pytest.approx(1.0)
    assert t.cross_pod_s == pytest.approx(0.5)
    assert t.dominant == "memory" and t.bound_s == pytest.approx(2.0)
    assert t.useful_flops_fraction == pytest.approx(1.0)
    assert t.roofline_fraction == pytest.approx(0.5)
    # measured ceilings replace the documented ones where given
    m = roofline_terms(1e12, 1e12, coll, 8, 8e12,
                       ceilings={"hbm_bw": 2e12, "flops": 5e11})
    assert m.memory_s == pytest.approx(0.5) and m.compute_s == 2.0
    assert m.roofline_fraction == pytest.approx(1.0)
    # the constants are an H100 SXM5's, not the reference's TPU v5e ones
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW) == (989e12, 3.35e12)
    assert roofline.PEAK_FLOPS_BF16 != jroof.PEAK_FLOPS_BF16


def test_collective_log_records_groups_shapes_and_types():
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 4), ("pod", "data"), device_type="cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.zeros(8, 6), mesh, [Shard(0), Shard(0)])
        log = CollectiveLog()
        with log:
            x.redistribute(mesh, [Shard(0), Replicate()])   # over "data"
            funcol.all_reduce(torch.zeros(3, dtype=torch.float64), "sum",
                              dist.group.WORLD)
    (ag, ar) = log.entries
    assert ag.op == "all-gather" and ag.ranks == (0, 1, 2, 3)
    assert ag.shapes == ((4, 6),) and ag.dtypes == (torch.float32,)
    assert ar.op == "all-reduce" and ar.ranks == tuple(range(8))
    assert ar.bytes == 24.0
    infos = parse_log(log.entries, pod_size=4)
    assert [i.crosses_pod for i in infos] == [False, True]
    dist.destroy_process_group()


def test_ert_wrappers_take_the_plain_version_on_the_cpu():
    from repro_torch.kernels.ert.ert import ert_gather, ert_stream
    from repro_torch.kernels.ert.ref import ert_gather_ref, ert_stream_ref

    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    idx = torch.randint(0, 1000, (500,), dtype=torch.int32)
    before = (ert_stream.launches, ert_gather.launches)
    y = ert_stream(x, 3, 1.5, 0.25)
    # addcmul may fuse each step into one rounding, as the kernel's FMA
    torch.testing.assert_close(y, ((x * 1.5 + 0.25) * 1.5 + 0.25) * 1.5
                               + 0.25, rtol=1e-6, atol=1e-6)
    assert torch.equal(ert_stream_ref(x, 3, 1.5, 0.25), y)
    assert torch.equal(ert_gather(x, idx), x[idx.long()])
    assert torch.equal(ert_gather_ref(x, idx), x[idx.long()])
    assert (ert_stream.launches, ert_gather.launches) == before
    with pytest.raises(TypeError, match="int32"):
        ert_gather(x, idx.long())
    with pytest.raises(ValueError, match="t = 0"):
        ert_stream(x, 0)
    sw = roofline.ert_sweep(device="cpu", smoke=True, reps=1)
    assert sw["device"] == "cpu" and sw["stream_bw"] > 0 and sw["flops"] > 0
    assert {p["kernel"] for p in sw["points"]} == {"stream", "gather"}
    assert "past_l2_stream_bw" not in sw          # smoke: the reference's sets
