"""Start one process per rank of a (pods × lanes) grid and run a function in
each: the launcher of ``AMGConfig(ranks="process")``.

:func:`spawn` starts ``n_pods * lanes`` processes from
``torch.multiprocessing``'s spawn context.  Each initialises the default
process group through a rendezvous file in a fresh temporary directory
(``init_method="file://..."``: no port, so concurrent launches never
collide), builds its :class:`~repro_torch.core.nap_collectives.RankGroups`
and calls ``fn(ranks, *args)``.  The parent collects every rank's result
against one deadline.  On a rank's failure, or at the deadline, it kills
every rank and raises :class:`RankFailure` with that rank's traceback.

``fn`` and ``args`` are pickled to the children, so ``fn`` must be a
module-level function.  The same ranks can be started by torchrun instead:
each process calls :func:`~repro_torch.core.nap_collectives.init_ranks`
(``env://``) before it builds an ``AMGSolver``.
"""
from __future__ import annotations

import queue
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from ..core.nap_collectives import close_ranks, init_ranks

#: seconds a finished rank gets to exit before it is killed
EXIT_GRACE = 30.0


class RankFailure(RuntimeError):
    """A rank raised, died or outlived the deadline."""


def _child(fn, args, rank: int, n_pods: int, lanes: int, init_method: str,
           backend: str, out) -> None:
    try:
        # the ranks share the host's cores: one thread each
        torch.set_num_threads(1)
        ranks = init_ranks(n_pods, lanes, rank=rank,
                           world_size=n_pods * lanes, init_method=init_method,
                           backend=backend)
        result = fn(ranks, *args)
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1) from None      # the parent prints the traceback
    out.put((rank, True, result))
    close_ranks()


def spawn(fn, n_pods: int, lanes: int, args: tuple = (), *,
          deadline: float = 240.0, backend: str = "gloo") -> list:
    """Run ``fn(ranks, *args)`` in one process per rank (``backend``:
    ``"gloo"`` or ``"nccl"``); returns the results in rank order.
    ``deadline`` (seconds) bounds the whole run."""
    ctx = mp.get_context("spawn")
    size = n_pods * lanes
    out = ctx.Queue()
    results: dict[int, object] = {}
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(fn, args, r, n_pods, lanes, init, backend,
                                   out))
                 for r in range(size)]
        for p in procs:
            p.start()
        ok = False
        try:
            end = time.monotonic() + deadline
            while len(results) < size:
                left = end - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(size)) - set(results))
                    raise RankFailure(f"ranks {missing} did not finish "
                                      f"within {deadline:.0f} s")
                try:
                    rank, good, payload = out.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:
                        raise RankFailure(
                            f"rank {dead[0][0]} exited with code "
                            f"{dead[0][1]} without a result") from None
                    continue
                if not good:
                    raise RankFailure(f"rank {rank} failed:\n{payload}")
                results[rank] = payload
            ok = True
        finally:
            for p in procs:
                if ok:
                    p.join(EXIT_GRACE)
                if p.is_alive():
                    p.kill()
                    p.join()
            out.close()
            out.cancel_join_thread()
    return [results[r] for r in range(size)]
