"""The port's rank-faithful schedule executor (``repro_torch.core.simulator``)
against the reference's: the ``verify`` cases of
``tests/test_core_schedules.py`` (exactly-once delivery under every
strategy, byte accounting of a weighted matrix graph) on the port's
modules, with each run's deliveries and message/byte counters equal to the
reference's on the same graph and values."""
import dataclasses

import numpy as np
import pytest

from repro.core import CommGraph as RefCommGraph
from repro.core import Partition as RefPartition
from repro.core import Topology as RefTopology
from repro.core import build as ref_build
from repro.core.simulator import execute as ref_execute
from repro_torch.core import CommGraph, Partition, Topology, build
from repro_torch.core.schedules import STRATEGIES, ScheduleStats
from repro_torch.core.simulator import execute, verify

# (n_nodes, ppn, n, max_need, seed): the shapes the reference's hypothesis
# strategy draws from (2-6 nodes, 1-6 processes a node, n up to 300)
GRAPHS = [(2, 1, 2, 0, 0), (2, 4, 64, 12, 1), (3, 3, 150, 40, 2),
          (4, 2, 300, 25, 3), (6, 6, 300, 40, 4), (5, 1, 77, 40, 5)]


def _graphs(n_nodes, ppn, n, max_need, seed, weights=None):
    """The same random graph (the reference suite's ``random_graph``) built
    on both packages."""
    rng = np.random.default_rng(seed)
    topo = Topology(n_nodes=n_nodes, ppn=ppn)
    part = Partition.balanced(n, topo)
    need = []
    for q in range(topo.n_procs):
        lo, hi = part.local_range(q)
        cand = np.setdiff1d(np.arange(n), np.arange(lo, hi))
        k = int(rng.integers(0, min(max_need, cand.size) + 1))
        need.append(rng.choice(cand, size=k, replace=False))
    rtopo = RefTopology(n_nodes=n_nodes, ppn=ppn)
    rpart = RefPartition.balanced(n, rtopo)
    return (CommGraph.from_offproc_columns(part, need, weights=weights),
            RefCommGraph.from_offproc_columns(rpart, need, weights=weights),
            rng)


def _same_result(got, want):
    assert got.received == want.received
    assert got.delivery_count == want.delivery_count
    for f in ("inter_msgs", "inter_bytes", "intra_msgs", "intra_bytes"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("params", GRAPHS, ids=lambda p: "-".join(map(str, p)))
def test_exactly_once_delivery(params, strategy):
    """Every strategy delivers every needed value exactly once, correctly,
    and the port's run equals the reference's."""
    g, rg, rng = _graphs(*params)
    x = rng.standard_normal(params[2])
    res = verify(build(strategy, g), x)          # raises on any violation
    _same_result(res, ref_execute(ref_build(strategy, rg), x))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_weighted_graph_matrix_comm(strategy):
    """Matrix rows weigh by nnz; byte accounting follows weights."""
    rng = np.random.default_rng(3)
    weights = rng.integers(1, 50, size=400).astype(np.float64) * 12.0 + 16.0
    g, rg, rng = _graphs(4, 4, 400, 25, 3, weights=weights)
    x = rng.standard_normal(400)
    res = verify(build(strategy, g), x)
    assert res.inter_bytes == pytest.approx(
        ScheduleStats.of(build(strategy, g)).inter_bytes_total)
    _same_result(res, ref_execute(ref_build(strategy, rg), x))


@pytest.mark.parametrize("strategy", ["nap2", "nap3"])
def test_verify_catches_a_lost_message(strategy):
    """A schedule with one message dropped fails ``verify`` (never
    delivered), and one with a message sent twice fails it too."""
    g, _, rng = _graphs(3, 3, 150, 40, 2)
    x = rng.standard_normal(150)
    sched = build(strategy, g)
    final = max((i for i, p in enumerate(sched.phases)
                 if p.kind != "gather" and p.messages), key=lambda i: i)
    phase = sched.phases[final]
    dropped = dataclasses.replace(phase, messages=phase.messages[1:])
    doubled = dataclasses.replace(phase, messages=phase.messages
                                  + phase.messages[:1])
    for bad in (dropped, doubled):
        phases = list(sched.phases)
        phases[final] = bad
        with pytest.raises(AssertionError, match="delivered"):
            verify(dataclasses.replace(sched, phases=phases), x)
    assert execute(sched, x).inter_msgs == \
        ScheduleStats.of(sched).inter_msg_count
