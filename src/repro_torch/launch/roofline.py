"""Roofline terms of a dry-run cell (port of ``repro/launch/roofline.py``).

Four terms a step, in seconds, on one device's timeline:

    compute    = FLOPs a device            / PEAK_FLOPS_BF16
    memory     = bytes a device            / HBM_BW
    collective = collective bytes a device / NVLINK_BW
    cross_pod  = pod-crossing bytes        / INTER_NODE_BW

The reference reads its collectives from compiled HLO text.  The port
records them while the trace runs: :class:`CollectiveLog` is a
``TorchDispatchMode`` that logs every c10d collective (DTensor's functional
collectives and the plain ``torch.distributed`` calls of
:class:`~repro_torch.core.nap_collectives.RankGroups`) with its group's
global ranks, its result's shape and type.  :func:`parse_log` turns the log
into :class:`CollectiveInfo` rows, classified as pod-crossing when the
group's ranks fall in more than one pod of ``pod_size`` consecutive ranks
(the reference's rule on its replica groups).

The constants are an NVIDIA H100 SXM5's documented peaks;
:func:`ert_sweep` measures the card's own stream and gather bandwidth (and
the FLOP rate of one dependent FMA chain a thread on the CUDA cores, not a
tensor-core ceiling) with the hand-written micro-kernels of
:mod:`repro_torch.kernels.ert`.  ``PERF.md`` keeps both side by side.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.nap_collectives import group_ranks

# ----------------------------- NVIDIA H100 SXM5 (80 GB HBM3), documented
PEAK_FLOPS_BF16 = 989e12   # dense bf16 tensor-core FLOP/s (H100 data sheet)
PEAK_FLOPS_F32 = 67e12     # float32 outside the tensor cores (data sheet)
PEAK_FLOPS_F64 = 34e12     # float64 outside the tensor cores (data sheet)
HBM_BW = 3.35e12           # HBM3 bytes/s (data sheet)
NVLINK_BW = 450e9          # NVLink 4: 900 GB/s a GPU, 450 GB/s each way
INTER_NODE_BW = 50e9       # one 400 Gb/s NDR InfiniBand port a GPU (DGX H100)

_KIND = {  # c10d op name (without namespace / overload) → the HLO kind
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_":
    "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_":
    "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_":
    "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


@dataclasses.dataclass
class LoggedCollective:
    """One collective as the trace issued it (a coalesced one with several
    results is one collective, as a tuple-shaped HLO op is)."""
    op: str                   # the HLO kind ("all-gather", ...)
    name: str                 # the c10d op
    ranks: tuple[int, ...]    # its group's global ranks
    shapes: tuple[tuple[int, ...], ...]   # its results' shapes (this rank's)
    dtypes: tuple[torch.dtype, ...]

    @property
    def bytes(self) -> float:
        return float(sum(math.prod(s) * d.itemsize
                         for s, d in zip(self.shapes, self.dtypes)))

    def key(self) -> tuple:
        """What two logs of one step must agree on."""
        return (self.op, self.shapes, tuple(str(d) for d in self.dtypes),
                self.ranks)


def _result(ns: str, args, out):
    """The result tensor(s) of a collective: the returned tensor of a
    functional one, the output argument of an in-place c10d one."""
    return args[0] if ns == "c10d" else out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


class CollectiveLog(TorchDispatchMode):
    """Records every c10d collective dispatched while it is active into
    ``entries`` (:class:`LoggedCollective`), those DTensor issues inside
    its ops included; the waits are not collectives and are not logged."""

    def __init__(self):
        super().__init__()
        self.entries: list[LoggedCollective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # handed back to DTensor, whose own redistributions (the
            # collectives GSPMD would insert) then come through here
            return NotImplemented
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._opname
        if ns in _NAMESPACES and name in _KIND:
            ranks = None
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, (str, torch.ScriptObject)) or \
                        type(a).__name__ == "ProcessGroup":
                    ranks = group_ranks(a)
                    if ranks is not None:
                        break
            res = _tensors(_result(ns, args, out))
            self.entries.append(LoggedCollective(
                _KIND[name], name, ranks or (),
                tuple(tuple(t.shape) for t in res),
                tuple(t.dtype for t in res)))
        return out


@dataclasses.dataclass
class CollectiveInfo:
    op: str
    bytes: float            # result-shape bytes (per participating device)
    crosses_pod: bool
    group_size: int


def crosses_pod(groups, pod_size: int | None) -> bool:
    """The reference's rule: a collective crosses pods when one of its
    groups holds ranks of two pods (``pod_size`` consecutive ranks a pod);
    without a pod size, any group of more than one rank."""
    for g in groups:
        if pod_size:
            if len({d // pod_size for d in g}) > 1:
                return True
        elif len(g) > 1:
            return True
    return False


def parse_log(entries, pod_size: int | None = None,
              n_devices: int | None = None) -> list[CollectiveInfo]:
    """:class:`CollectiveInfo` rows of a recorded log; an entry without a
    group (all devices) crosses when ``n_devices > pod_size``, as the
    reference treats empty replica groups."""
    out = []
    for e in entries:
        if e.ranks:
            cross = crosses_pod([e.ranks], pod_size)
            size = len(e.ranks)
        else:
            size = n_devices or 0
            cross = bool(pod_size and n_devices and n_devices > pod_size)
        out.append(CollectiveInfo(e.op, e.bytes, cross, size))
    return out


def collective_totals(entries, pod_size: int | None = None,
                      n_devices: int | None = None) -> dict:
    """The reference's ``collective_bytes_from_text`` totals, from a log."""
    infos = parse_log(entries, pod_size, n_devices)
    return {
        "total_bytes": sum(i.bytes for i in infos),
        "cross_slow_bytes": sum(i.bytes for i in infos if i.crosses_pod),
        "n_collectives": len(infos),
        "n_cross": sum(1 for i in infos if i.crosses_pod),
        "by_op": {op: sum(i.bytes for i in infos if i.op == op)
                  for op in sorted({i.op for i in infos})},
    }


@dataclasses.dataclass
class RooflineTerms:
    """All terms in seconds (a step, a device's timeline)."""
    compute_s: float
    memory_s: float
    collective_s: float
    cross_pod_s: float
    hlo_flops: float          # a device
    hlo_bytes: float          # a device
    coll_bytes: float         # a device
    cross_pod_bytes: float
    model_flops: float        # 6·N·D (or 6·N_active·D): global useful FLOPs
    n_chips: int
    peak_flops: float = PEAK_FLOPS_BF16

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": max(self.collective_s, self.cross_pod_s)}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s,
                   self.cross_pod_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (FLOPs a device × devices): remat and redundancy."""
        tot = self.hlo_flops * self.n_chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The model's useful compute time at peak over the step's bound."""
        ideal = self.model_flops / (self.n_chips * self.peak_flops)
        return ideal / self.bound_s if self.bound_s else 0.0


def roofline_terms(flops: float, hbm_bytes: float, coll: dict, n_chips: int,
                   model_flops: float, ceilings: dict | None = None
                   ) -> RooflineTerms:
    """Terms from a device's FLOPs and bytes and :func:`collective_totals`.
    ``ceilings``: rates that replace the documented ones (``flops``,
    ``hbm_bw``, ``nvlink_bw``, ``inter_node_bw``), e.g. the measured HBM
    rate ``{"hbm_bw": ert_sweep()["past_l2_stream_bw"]}``.  (``ert_sweep``'s
    ``flops`` is a CUDA-core rate in f32 or f64, not the bf16 tensor-core
    peak that ``compute_s`` divides by: it replaces nothing here.)"""
    c = {"flops": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
         "inter_node_bw": INTER_NODE_BW, **(ceilings or {})}
    return RooflineTerms(
        compute_s=flops / c["flops"],
        memory_s=hbm_bytes / c["hbm_bw"],
        collective_s=coll["total_bytes"] / c["nvlink_bw"],
        cross_pod_s=coll["cross_slow_bytes"] / c["inter_node_bw"],
        hlo_flops=flops, hlo_bytes=hbm_bytes,
        coll_bytes=coll["total_bytes"],
        cross_pod_bytes=coll["cross_slow_bytes"],
        model_flops=model_flops, n_chips=n_chips, peak_flops=c["flops"])


# --------------------------------------------------------------------------
# ERT-style measured ceilings.  The reference's working sets (2^16 to 2^23
# elements) are kept, so its sweep stays comparable; they give no L2
# ceiling on the H100 (the small sets time the launch, and at 2^23 a stream
# reads 32 MiB and writes 32 more in f32, past the 50 MB L2).  Two sets past
# the L2 (2^26, 2^28) are added and reported apart: device memory's rate.
# --------------------------------------------------------------------------

ERT_WORKING_SETS = (1 << 16, 1 << 20, 1 << 23)       # elements
ERT_PAST_L2_WORKING_SETS = (1 << 26, 1 << 28)
ERT_SMOKE_WORKING_SETS = (1 << 13, 1 << 15)
ERT_FLOP_INTENSITIES = (1, 4, 16, 64, 256)           # t: 2t FLOPs an element
ERT_SMOKE_FLOP_INTENSITIES = (1, 8)


def _time_best(fn, reps: int, device) -> float:
    """Best of ``reps`` seconds of ``fn()`` on the card (CUDA events, one
    warm-up call), or on the host clock for the CPU."""
    import time
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def ert_sweep(working_sets: tuple[int, ...] | None = None,
              intensities: tuple[int, ...] | None = None, reps: int = 5,
              dtype=torch.float32, smoke: bool = False,
              device="cuda") -> dict:
    """Measure the device's achievable peaks, ERT style, with
    :func:`~repro_torch.kernels.ert.ert.ert_stream` (t FMAs an element) and
    :func:`~repro_torch.kernels.ert.ert.ert_gather` (a random gather).

    Returns ``{"stream_bw", "gather_bw", "flops", "points", ...}`` over the
    reference's working sets, and the same keys with ``past_l2_`` before
    them over :data:`ERT_PAST_L2_WORKING_SETS` (unless ``smoke``): bytes/s,
    and FLOP/s of one dependent FMA chain a thread on the CUDA cores in
    ``dtype`` (a latency-bound rate: not the tensor-core peak).  ``points`` holds one dict per (kernel, working set,
    intensity).  On the CPU (``device="cpu"``) the plain versions run: a
    rehearsal, whose numbers are no device's."""
    from ..device import resolve_device
    from ..kernels.ert.ert import ert_gather, ert_stream
    dev = resolve_device(device)
    if working_sets is None:
        working_sets = ERT_SMOKE_WORKING_SETS if smoke else ERT_WORKING_SETS
    if intensities is None:
        intensities = (ERT_SMOKE_FLOP_INTENSITIES if smoke
                       else ERT_FLOP_INTENSITIES)
    dsize = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device=dev).manual_seed(0)
    t_min = min(intensities)
    points: list[dict] = []

    def sweep(sets, tag):
        peaks = {"stream_bw": 0.0, "gather_bw": 0.0, "flops": 0.0}
        for w in sets:
            x = torch.randn(w, generator=gen, dtype=dtype, device=dev)
            for t in intensities:
                s = _time_best(lambda: ert_stream(x, t), reps, dev)
                byts, fl = 2.0 * w * dsize, 2.0 * t * w
                points.append({"kernel": "stream", "set": tag,
                               "working_set": int(w), "flops_per_elem": 2 * t,
                               "seconds": s, "bytes": byts, "flops": fl,
                               "bw": byts / s, "flop_rate": fl / s})
                if t == t_min:
                    peaks["stream_bw"] = max(peaks["stream_bw"], byts / s)
                peaks["flops"] = max(peaks["flops"], fl / s)
            idx = torch.randint(0, w, (w,), generator=gen, device=dev,
                                dtype=torch.int64).to(torch.int32)
            s = _time_best(lambda: ert_gather(x, idx), reps, dev)
            byts = w * (2.0 * dsize + 4.0)   # random read + write + idx read
            points.append({"kernel": "gather", "set": tag,
                           "working_set": int(w), "flops_per_elem": 0,
                           "seconds": s, "bytes": byts, "flops": 0.0,
                           "bw": byts / s, "flop_rate": 0.0})
            peaks["gather_bw"] = max(peaks["gather_bw"], byts / s)
            del x, idx
        return peaks

    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "dtype": str(dtype).replace("torch.", ""), "smoke": bool(smoke),
           **sweep(working_sets, "reference")}
    if not smoke:
        out.update({f"past_l2_{k}": v for k, v in
                    sweep(ERT_PAST_L2_WORKING_SETS, "past_l2").items()})
    out.update(points=points, documented_hbm_bw=HBM_BW,
               documented_flops=(PEAK_FLOPS_F64 if dtype == torch.float64
                                 else PEAK_FLOPS_F32))
    return out
