"""The solve programs as captured CUDA graphs: the port's counterpart of the
reference's compiled-program cache, ``DistHierarchy.programs``
(``repro/amg/dist_solve.py:644-796``).

The reference traces each of its ten fused programs (``resid_norm``,
``cycle``, ``vcycle``, ``pcg_init``, ``pcg_step`` and their ``*_m``
multi-RHS twins) into ONE jitted ``shard_map`` program per option set; per
PCG iteration the host dispatches one program and reads one scalar.  Here a
:class:`Program` is one of those programs under one :class:`ProgramKey`
(program, options, RHS width k, dtype and the hierarchy's apply knobs), run
over static buffers:

* the state buffers ``x``, ``b``, ``r``, ``p`` (``[D, local(, k)]``) and
  ``rz``, ``rnorm`` (``[D(, k)]``) are shared by every program of one width
  (:meth:`ProgramCache.state`);
* a program reads its inputs from them (:data:`SIGNATURES`) and writes its
  outputs back into them, and that write-back is part of the program, so a
  driver copies ``b`` and ``x0`` in once and then runs one program per
  iteration;
* on a CUDA device each program is one ``torch.cuda.CUDAGraph``, captured
  on first use and replayed afterwards; on the CPU its body runs directly
  over the same buffers.
* with one process per rank (``AMGConfig(ranks="process")``) the body also
  runs directly over its buffers on every call, on the card too: its
  collectives are ``torch.distributed`` calls, host code a CUDA graph cannot
  capture (a gloo group's are staged through host memory besides).
  Capturing the compute between them, or NCCL collectives inside a graph,
  is left for later (ROADMAP item 12).

Capture runs the body once on a side stream first (the warm-up loads each
kernel's library, outside the capture; its outputs are dropped, so it
changes no state), then captures body and write-back with
``capture_error_mode="thread_local"``, so that a worker thread can capture
while another thread synchronises.  Kernel launches and the collective log
are recorded at capture and added once per replay.  A capture that fails
raises: on the stacked ranks nothing falls back to eager execution on the
card.

A graph's static buffers make its program non-reentrant, which a jitted
program is not, so every driver holds the hierarchy's lock from the
copy-in to the last read.  Captures are serialised across the process
too: ``torch.cuda.graph`` synchronises the whole device before it starts,
which would break another thread's capture in progress.  All graphs of one
hierarchy share one memory pool: they run one after another on one stream,
and every tensor a graph allocates is a temporary that is dead when the
graph ends.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import NamedTuple

import torch

from ..kernels.launches import recording, replayed

# program → (state buffers it reads, state buffers it writes), in the order
# of the eager method's arguments and results (``pcg_init``'s z is the
# first search direction p)
SIGNATURES = {
    "resid_norm": (("x", "b"), ("rnorm",)),
    "cycle": (("x", "b"), ("x", "rnorm")),
    "vcycle": (("b",), ("x",)),
    "pcg_init": (("x", "b"), ("r", "p", "rz", "rnorm")),
    "pcg_step": (("x", "r", "p", "rz"), ("x", "r", "p", "rz", "rnorm")),
}
PROGRAMS = tuple(SIGNATURES) + tuple(f"{n}_m" for n in SIGNATURES)
VECTORS = ("x", "b", "r", "p")       # [D, local(, k)]; rz, rnorm: [D(, k)]
# one capture at a time in the process (a capture starts with a device-wide
# synchronise, illegal while another stream is being captured)
_CAPTURE_LOCK = threading.Lock()


class ProgramKey(NamedTuple):
    """What a captured program bakes in: the reference's options key
    (dist_solve.py:663-665) with its smoother-arrays key (the factors a
    block smoother reads, ``dist_solve.smoother_arrays_key``: block-Jacobi's
    ``block_size`` counts, the other smoothers ignore it), the RHS width
    (``None`` for the single-RHS programs), the dtype and the apply knobs
    the body reads."""

    name: str
    cycle: str
    smoother: str
    presweeps: int
    postsweeps: int
    omega: float
    cheby_degree: int
    smoother_arrays: tuple | None
    k: int | None
    dtype: torch.dtype
    overlap: bool
    use_kernel: bool
    reduce_strategy: str


class Program:
    """One program of one key over the hierarchy's state buffers."""

    def __init__(self, dh, key: ProgramKey, opts):
        self.dh, self.key, self.opts = dh, key, opts
        self.inputs, self.outputs = SIGNATURES[key.name.removesuffix("_m")]
        self.graph = None               # set by capture
        self.launches: Counter = Counter()   # per replay, recorded at capture
        self.comm: list[str] = []        # collectives per replay, likewise
        self.replays = 0

    def _body(self) -> tuple:
        st = self.dh.programs.state(self.key.k)
        out = getattr(self.dh, self.key.name)(
            *(st[n] for n in self.inputs), self.opts)
        return out if isinstance(out, tuple) else (out,)

    def _write_back(self, out: tuple) -> None:
        st = self.dh.programs.state(self.key.k)
        for name, t in zip(self.outputs, out):
            st[name].copy_(t)

    def run(self) -> None:
        """One call: replay the graph, or on the CPU run the body and its
        write-back."""
        if self.graph is None:
            self._write_back(self._body())
            return
        self.graph.replay()
        self.replays += 1
        replayed(self.launches)
        if self.dh.comm_log is not None:
            self.dh.comm_log.extend(self.comm)

    def capture(self, graph, capturing, warm_stream=None) -> None:
        """Warm up (on ``warm_stream`` when given), then run body and
        write-back inside ``capturing``, the context that captures into
        ``graph``.  Neither run counts launches or logs collectives; the
        capture's are recorded for :meth:`run`."""
        dh = self.dh
        log, dh.comm_log = dh.comm_log, None
        try:
            with recording():
                if warm_stream is None:
                    self._body()
                else:
                    main = torch.cuda.current_stream(dh.device)
                    warm_stream.wait_stream(main)
                    with torch.cuda.stream(warm_stream):
                        self._body()
                    main.wait_stream(warm_stream)
            comm: list[str] = []
            dh.comm_log = comm
            with recording() as tally, capturing:
                self._write_back(self._body())
        finally:
            dh.comm_log = log
        self.graph, self.launches, self.comm = graph, tally, comm


class ProgramCache:
    """A hierarchy's programs by key, its state buffers by RHS width, and
    its capture accounting."""

    def __init__(self, dh):
        self.dh = dh
        self._programs: dict[ProgramKey, Program] = {}
        self._state: dict[int | None, dict[str, torch.Tensor]] = {}
        self._pool = None
        self.captures: Counter = Counter()   # (name, k) → graphs captured

    def __len__(self) -> int:
        return len(self._programs)

    def keys(self) -> list[ProgramKey]:
        return list(self._programs)

    def values(self) -> list[Program]:
        return list(self._programs.values())

    def key(self, name: str, opts, k: int | None) -> ProgramKey:
        if name not in PROGRAMS:
            raise ValueError(f"unknown program {name!r}; known: {PROGRAMS}")
        if (k is None) != (not name.endswith("_m")):
            raise ValueError(f"{name}: the *_m programs take a width k, the "
                             f"single-RHS ones none, got k={k}")
        dh = self.dh
        return ProgramKey(name, opts.cycle, opts.smoother, opts.presweeps,
                          opts.postsweeps, opts.omega, opts.cheby_degree,
                          dh.smoother_arrays_key(opts), k, dh.dtype, dh.overlap,
                          dh.use_kernel, dh.reduce_strategy)

    def state(self, k: int | None) -> dict[str, torch.Tensor]:
        """The state buffers of width ``k`` (allocated on first use)."""
        st = self._state.get(k)
        if st is None:
            dh = self.dh
            D, n = dh.local_ranks, dh.levels[0].A.plan.local_n
            ext = () if k is None else (k,)
            st = {name: torch.zeros((D, n) + ext, dtype=dh.dtype,
                                    device=dh.device) for name in VECTORS}
            for name in ("rz", "rnorm"):
                st[name] = torch.zeros((D,) + ext, dtype=dh.dtype,
                                       device=dh.device)
            self._state[k] = st
        return st

    def get(self, name: str, opts, k: int | None = None) -> Program:
        """The program ``name`` for ``opts`` at width ``k``, captured on
        first use on a CUDA device (not one process per rank)."""
        key = self.key(name, opts, k)
        prog = self._programs.get(key)
        if prog is None:
            prog = Program(self.dh, key, opts)
            if self.dh.device.type == "cuda" and self.dh.ranks is None:
                self._capture(prog)
            self._programs[key] = prog
        return prog

    def run(self, name: str, opts, k: int | None = None) -> None:
        self.get(name, opts, k).run()

    def _capture(self, prog: Program) -> None:
        dev = self.dh.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        self.state(prog.key.k)          # allocated outside the graph's pool
        self.dh.run_arrays(prog.opts)   # a block smoother's factors, likewise
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            prog.capture(graph,
                         torch.cuda.graph(graph, pool=self._pool,
                                          capture_error_mode="thread_local"),
                         warm_stream=torch.cuda.Stream(dev))
        self.captures[(prog.key.name, prog.key.k)] += 1

    def drop(self, pred) -> int:
        """Forget every program whose key satisfies ``pred`` (they are
        captured again on next use); returns how many went."""
        gone = [k for k in self._programs if pred(k)]
        for k in gone:
            del self._programs[k]
        if all(p.graph is None for p in self._programs.values()):
            # the pool lives only as long as a graph that uses it: the next
            # capture needs a new one
            self._pool = None
        return len(gone)

    def state_bytes(self) -> int:
        """Bytes of the state buffers of every width allocated so far."""
        return sum(t.numel() * t.element_size()
                   for st in self._state.values() for t in st.values())

    def pool_bytes(self) -> int:
        """Device bytes reserved in the graphs' shared memory pool (0 before
        the first capture or off the card)."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))

