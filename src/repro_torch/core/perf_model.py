# Verbatim copy of repro/core/perf_model.py (numpy only); only the imports may differ.
"""Max-rate performance models (paper §3.3, Eqs. 1–6).

The paper measures latency/bandwidth separately for the short, eager and
rendezvous MPI protocols and models

  inter-node (Eq. 2):  T = α·n + max(s_node / R_N, s_proc / R_b)
  intra-node (Eq. 3):  T = α_ℓ·n + s / R_bℓ

and per-strategy totals (Eqs. 4–6).  Two evaluation modes are provided:

* :func:`model_time` — message-list evaluation: every message is bucketed
  into its protocol (paper: "latency and bandwidth terms are measured and
  applied separately to short, eager, and rendezvous protocols").  This is
  what the selector uses.
* :func:`model_time_closed` — the literal closed forms (4)–(6), used by the
  model-validation benchmark.

Parameter sets: ``BLUE_WATERS`` (Cray XE6, 16 ppn — values consistent with
the Nodecomm/max-rate measurements in [Gropp, Olson, Samfass 2016] and
[Bienz, Gropp, Olson 2018]) and ``TPU_V5E`` (this framework's target: "node"
= ICI pod, "network" = inter-pod DCI; constants are modeled, documented in
DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .schedules import Schedule, ScheduleStats


@dataclasses.dataclass(frozen=True)
class ProtocolParams:
    alpha: float  # seconds per message
    Rb: float     # bytes / second sustained by one process


@dataclasses.dataclass(frozen=True)
class MachineParams:
    name: str
    ppn: int
    # protocol cutoffs (bytes)
    short_cutoff: float
    eager_cutoff: float
    # per-protocol (short, eager, rend) parameters
    inter: tuple[ProtocolParams, ProtocolParams, ProtocolParams]
    intra: tuple[ProtocolParams, ProtocolParams, ProtocolParams]
    intra_socket: tuple[ProtocolParams, ProtocolParams, ProtocolParams]
    RN: float     # bytes / second a NID injects into the network
    # sustained local SpMV flop rate per process (flop/s).  0 means "not
    # measured": overlap-aware phase costs degrade to the pure comm time, so
    # every documented machine above stays selection-compatible with the
    # pre-overlap models.
    Rf: float = 0.0

    def proto(self, nbytes: float) -> int:
        if nbytes < self.short_cutoff:
            return 0
        if nbytes < self.eager_cutoff:
            return 1
        return 2

    def p_inter(self, nbytes: float) -> ProtocolParams:
        return self.inter[self.proto(nbytes)]

    def p_intra(self, nbytes: float) -> ProtocolParams:
        return self.intra[self.proto(nbytes)]

    @classmethod
    def from_measurements(cls, name: str, ppn: int, *,
                          inter: list[tuple[float, float]],
                          intra: list[tuple[float, float]],
                          intra_socket: list[tuple[float, float]] | None = None,
                          Rf: float = 0.0, RN: float | None = None,
                          short_cutoff: float = 4096,
                          eager_cutoff: float = 131072) -> "MachineParams":
        """Calibrate a parameter set from measured ``(bytes, seconds)``
        ping-pong samples (ROADMAP "measured machine models", first slice).

        Each tier's samples are fit to the postal model t = α + n/R_b by
        linear least squares; one fitted :class:`ProtocolParams` fills all
        three protocol slots (XLA collectives have no MPI-style protocol
        switch — the cutoffs are kept only so :meth:`proto` stays total).
        ``RN`` defaults to the whole node injecting at once (ppn × the
        fitted inter R_b); ``Rf`` is the measured local SpMV flop rate.
        """
        def fit(samples) -> ProtocolParams:
            s = np.asarray(samples, dtype=np.float64)
            if s.ndim != 2 or s.shape[0] < 2:
                raise ValueError(
                    f"need >=2 (bytes, seconds) samples per tier, got {s!r}")
            A = np.stack([np.ones(s.shape[0]), s[:, 0]], axis=1)
            alpha, inv_rb = np.linalg.lstsq(A, s[:, 1], rcond=None)[0]
            # floors keep a noisy fit physical: latency never negative,
            # bandwidth finite and positive
            return ProtocolParams(alpha=float(max(alpha, 1e-9)),
                                  Rb=float(1.0 / max(inv_rb, 1e-15)))

        p_inter = fit(inter)
        p_intra = fit(intra)
        p_sock = fit(intra_socket) if intra_socket is not None else p_intra
        return cls(name=name, ppn=ppn, short_cutoff=short_cutoff,
                   eager_cutoff=eager_cutoff,
                   inter=(p_inter,) * 3, intra=(p_intra,) * 3,
                   intra_socket=(p_sock,) * 3,
                   RN=float(RN) if RN is not None else ppn * p_inter.Rb,
                   Rf=float(Rf))


# --- Blue Waters (Cray XE6, Gemini).  Measured-order-of-magnitude constants:
#     inter-node short latency ~2 µs, rendezvous ~4 µs, per-process stream
#     ~1 GB/s, NID injection ~4.7 GB/s; on-node copies ~0.6–0.9 µs latency at
#     ~3–5 GB/s.  (Consistent with Fig. 8/9 of the paper.)
BLUE_WATERS = MachineParams(
    name="blue_waters",
    ppn=16,
    short_cutoff=512,
    eager_cutoff=8192,
    inter=(
        ProtocolParams(alpha=2.0e-6, Rb=5.0e8),
        ProtocolParams(alpha=3.0e-6, Rb=8.0e8),
        ProtocolParams(alpha=4.5e-6, Rb=1.0e9),
    ),
    intra=(
        ProtocolParams(alpha=9.0e-7, Rb=1.5e9),
        ProtocolParams(alpha=1.0e-6, Rb=2.5e9),
        ProtocolParams(alpha=1.4e-6, Rb=3.5e9),
    ),
    intra_socket=(
        ProtocolParams(alpha=4.0e-7, Rb=2.5e9),
        ProtocolParams(alpha=5.0e-7, Rb=4.0e9),
        ProtocolParams(alpha=7.0e-7, Rb=5.5e9),
    ),
    RN=4.7e9,
)

# --- Quartz (Intel Xeon E5, Omni-Path, 32 ppn) — for the Fig. 19 benchmark.
QUARTZ = MachineParams(
    name="quartz",
    ppn=32,
    short_cutoff=512,
    eager_cutoff=16384,
    inter=(
        ProtocolParams(alpha=1.1e-6, Rb=1.5e9),
        ProtocolParams(alpha=1.8e-6, Rb=2.5e9),
        ProtocolParams(alpha=3.0e-6, Rb=3.0e9),
    ),
    intra=(
        ProtocolParams(alpha=5.0e-7, Rb=4.0e9),
        ProtocolParams(alpha=6.0e-7, Rb=6.0e9),
        ProtocolParams(alpha=9.0e-7, Rb=8.0e9),
    ),
    intra_socket=(
        ProtocolParams(alpha=2.5e-7, Rb=6.0e9),
        ProtocolParams(alpha=3.5e-7, Rb=9.0e9),
        ProtocolParams(alpha=5.0e-7, Rb=1.2e10),
    ),
    RN=1.2e10,
)

# --- TPU v5e mapping: "process"=chip, "node"=256-chip ICI pod, network=DCI.
#     intra  = ICI collectives inside the pod (per-chip aggregate ~1.8e11 B/s,
#              ~1 µs per hop); inter = pod-crossing transfers (per-chip share
#              ~6.4e9 B/s, pod egress aggregate ~8.2e11 B/s, ~5 µs launch).
TPU_V5E = MachineParams(
    name="tpu_v5e",
    ppn=256,
    short_cutoff=4096,
    eager_cutoff=131072,
    inter=(
        ProtocolParams(alpha=5.0e-6, Rb=6.4e9),
        ProtocolParams(alpha=5.0e-6, Rb=6.4e9),
        ProtocolParams(alpha=5.0e-6, Rb=6.4e9),
    ),
    intra=(
        ProtocolParams(alpha=1.0e-6, Rb=1.8e11),
        ProtocolParams(alpha=1.0e-6, Rb=1.8e11),
        ProtocolParams(alpha=1.0e-6, Rb=1.8e11),
    ),
    intra_socket=(
        ProtocolParams(alpha=1.0e-6, Rb=1.8e11),
        ProtocolParams(alpha=1.0e-6, Rb=1.8e11),
        ProtocolParams(alpha=1.0e-6, Rb=1.8e11),
    ),
    RN=8.2e11,
)

MACHINES = {m.name: m for m in (BLUE_WATERS, QUARTZ, TPU_V5E)}


def register_machine(params: MachineParams) -> MachineParams:
    """Make a (typically measured) parameter set addressable by name — e.g.
    ``AMGConfig(machine=...)`` resolves through :data:`MACHINES`."""
    MACHINES[params.name] = params
    return params


# ------------------------------------------------------------- overlap costs
def spmv_compute_times(params: MachineParams, on_nnz: int,
                       off_nnz: int) -> tuple[float, float]:
    """(t_on, t_off) seconds for the split local products of one SpMV
    (2 flops per stored nonzero, worst device).  (0, 0) when the machine has
    no measured flop rate — overlap-unaware selection."""
    if params.Rf <= 0:
        return 0.0, 0.0
    return 2.0 * on_nnz / params.Rf, 2.0 * off_nnz / params.Rf


def overlap_time(t_comm: float, t_on: float, t_off: float) -> float:
    """Overlap-aware phase cost: the exchange hides behind the on-process
    product, the off-process product lands after — max(T_comm, T_on) + T_off
    instead of the serial sum of phases."""
    return max(t_comm, t_on) + t_off


def overlap_efficiency(t_comm: float, t_on: float, t_off: float) -> float:
    """Fraction of the serial phase cost the overlap hides (0 when the
    machine is overlap-unaware or the phase is free)."""
    serial = t_comm + t_on + t_off
    if serial <= 0.0:
        return 0.0
    return 1.0 - overlap_time(t_comm, t_on, t_off) / serial


# ------------------------------------------------------------------ Fig. 8/9 helpers
def single_message_time(params: MachineParams, nbytes: float, location: str) -> float:
    """Postal-model cost of one message (Fig. 8 curves)."""
    tiers = {
        "socket": params.intra_socket,
        "node": params.intra,
        "network": params.inter,
    }
    p = tiers[location][params.proto(nbytes)]
    return p.alpha + nbytes / p.Rb


def maxrate_internode_time(params: MachineParams, total_bytes: float, active: int) -> float:
    """Eq. (1) with ``active`` processes sharing one inter-node transfer
    (Fig. 9: cost falls as data is spread over more processes, floored by R_N)."""
    s_proc = total_bytes / max(active, 1)
    p = params.p_inter(s_proc)
    return p.alpha + max(total_bytes / params.RN, s_proc / p.Rb)


# ------------------------------------------------------------------ schedule models
def model_time(schedule: Schedule, params: MachineParams) -> float:
    """Protocol-bucketed max-rate evaluation of a concrete schedule."""
    g = schedule.graph
    topo = g.topo
    P, N = topo.n_procs, topo.n_nodes
    lat_p = np.zeros(P)        # Σ α over inter-node messages, per src process
    bw_p = np.zeros(P)         # Σ bytes/R_b over inter-node messages, per src
    inj_n = np.zeros(N)        # bytes injected per node
    lat_intra = np.zeros(P)
    bw_intra = np.zeros(P)
    for kind, msg in schedule.all_messages():
        b = g.bytes_of(msg.indices)
        sn, dn = topo.node_of(msg.src), topo.node_of(msg.dst)
        if sn != dn:
            pp = params.p_inter(b)
            lat_p[msg.src] += pp.alpha
            bw_p[msg.src] += b / pp.Rb
            inj_n[sn] += b
        elif kind in ("gather", "redist"):
            pp = params.p_intra(b)
            lat_intra[msg.src] += pp.alpha
            bw_intra[msg.src] += b / pp.Rb
    t_inter = lat_p.max(initial=0.0) + max(inj_n.max(initial=0.0) / params.RN,
                                           bw_p.max(initial=0.0))
    t_intra = lat_intra.max(initial=0.0) + bw_intra.max(initial=0.0)
    return float(t_inter + t_intra)


def model_time_closed(stats: ScheduleStats, params: MachineParams) -> float:
    """Literal Eqs. (4)–(6) from §3.3 (single-protocol, chosen by mean size)."""
    ppn = params.ppn
    mean = stats.inter_bytes_total / max(stats.inter_msg_count, 1)
    pi = params.p_inter(mean)
    pl = params.p_intra(mean)
    bw = max(stats.s_node / params.RN, stats.s_proc / pi.Rb)
    if stats.strategy == "standard":                                   # Eq. (4)
        return pi.alpha * stats.n_proc + bw
    if stats.strategy == "nap2":                                       # Eq. (5)
        return (pi.alpha * stats.n_proc2node + bw
                + pl.alpha * (ppn - 1) + stats.s_proc / pl.Rb)
    if stats.strategy == "nap3":                                       # Eq. (6)
        bw3 = max(stats.s_node / params.RN, stats.s_node2node / pi.Rb)
        return (pi.alpha * stats.n_node2node / ppn + bw3
                + 2.0 * (pl.alpha * (ppn - 1) + stats.s_node2node / pl.Rb))
    raise ValueError(stats.strategy)
