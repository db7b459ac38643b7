"""Core of the paper's contribution: multi-step node-aware communication
(PyTorch port of :mod:`repro.core`).

- :mod:`repro_torch.core.topology`        — SMP-node / pod hierarchical topology
- :mod:`repro_torch.core.comm_graph`      — who needs which values from whom
- :mod:`repro_torch.core.schedules`       — standard / NAP-2 / NAP-3 schedules (§3)
- :mod:`repro_torch.core.perf_model`      — max-rate models, Eqs. (1)–(6) (§3.3)
- :mod:`repro_torch.core.selector`        — per-operation strategy selection (§4)
- :mod:`repro_torch.core.simulator`       — rank-faithful host execution (tests)
- :mod:`repro_torch.core.nap_collectives` — halo exchange / NAP reductions on
  rank-stacked tensors; the setup phase's host matrix-row exchange
"""
from .comm_graph import CommGraph, VECTOR_BYTES
from .perf_model import BLUE_WATERS, MACHINES, QUARTZ, TPU_V5E, MachineParams
from .schedules import STRATEGIES, Schedule, ScheduleStats, build
from .selector import Selection, select
from .topology import Partition, Topology

__all__ = [
    "CommGraph", "VECTOR_BYTES", "BLUE_WATERS", "QUARTZ", "TPU_V5E", "MACHINES",
    "MachineParams", "STRATEGIES", "Schedule", "ScheduleStats", "build",
    "Selection", "select", "Partition", "Topology",
]
