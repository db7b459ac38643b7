# Verbatim copy of repro/core/selector.py (numpy only); only the imports may differ.
"""Strategy selection (paper §4, first paragraph).

"Optimal strategies for vector and matrix communication are determined
during the formation of each matrix in the AMG hierarchy.  After a matrix is
created, the performance models in Equations 4, 5, and 6 are calculated and
the strategy with minimum modeled cost is chosen."
"""
from __future__ import annotations

import dataclasses

from .comm_graph import CommGraph
from .perf_model import MachineParams, model_time, overlap_time
from .schedules import STRATEGIES, Schedule, ScheduleStats, build


@dataclasses.dataclass
class Selection:
    strategy: str
    schedule: Schedule
    stats: dict[str, ScheduleStats]     # per strategy
    times: dict[str, float]            # modeled phase seconds per strategy
    # raw communication seconds (the pre-overlap model_time); equal to
    # ``times`` when no compute split was supplied
    comm_times: dict[str, float] = dataclasses.field(default_factory=dict)
    compute: tuple[float, float] = (0.0, 0.0)    # (t_on, t_off) seconds

    @property
    def modeled_time(self) -> float:
        return self.times[self.strategy]


def select(graph: CommGraph, params: MachineParams,
           strategies: tuple[str, ...] = STRATEGIES,
           compute: tuple[float, float] = (0.0, 0.0)) -> Selection:
    """Pick the minimum-cost strategy for ``graph`` on ``params``.

    ``compute=(t_on, t_off)`` is the operator's split local-product cost:
    the phase cost becomes ``max(T_comm, T_on) + T_off`` — what the
    overlapped apply actually pays — so a slower-but-hideable exchange can
    beat a nominally cheaper one.  The default (0, 0) reduces exactly to
    the serial comm-only ranking.
    """
    schedules = {s: build(s, graph) for s in strategies}
    comm_times = {s: model_time(sch, params) for s, sch in schedules.items()}
    t_on, t_off = compute
    times = {s: overlap_time(t, t_on, t_off) for s, t in comm_times.items()}
    stats = {s: ScheduleStats.of(sch) for s, sch in schedules.items()}
    best = min(times, key=times.get)
    return Selection(strategy=best, schedule=schedules[best], stats=stats,
                     times=times, comm_times=comm_times, compute=compute)
