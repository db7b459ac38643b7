# Port of repro/analysis/jaxpr_walk.py: a collective log and a poisoned-halo run in place of a jaxpr walk.
"""Collective logs and the overlap property.

The reference walks a traced jaxpr for its collective equations.  The port
has no trace: every collective step of :mod:`repro_torch.core.nap_collectives`
appends its canonical name to a log (``DistHierarchy.comm_log``, the
``log=`` of an apply), and under CUDA-graph capture a program's log is
recorded once and added on every replay.  :func:`collect_collectives` turns
such a log into typed records.

The overlap property — with ``overlap=True`` the ``A_on`` product does not
depend on the halo exchange — is a dataflow question the reference answers
with a taint sweep over the jaxpr.  Here it is answered by running the
apply twice, once with every halo the exchange returns poisoned (NaN), and
recording each local contraction's output: an overlappable apply has a
contraction the poison leaves bit-equal (``A_on · x``) and one it reaches
(``A_off · halo``); the serial form ``A · [x | halo]`` has none it leaves.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from ..amg import dist_spmv
from .records import CollectiveRecord

# the poisoned run swaps the exchange dist_spmv calls: one check at a time
_POISON_LOCK = threading.Lock()


def collect_collectives(log, *, level: int | None = None,
                        op: str | None = None) -> list[CollectiveRecord]:
    """Every collective step of ``log`` (a list of canonical names), in log
    order, attributed to ``level``/``op`` when the caller knows them."""
    return [CollectiveRecord(str(name), i, level, op)
            for i, name in enumerate(log)]


def collective_signature(log) -> tuple[str, ...]:
    """Ordered canonical collective names of ``log``."""
    return tuple(r.primitive for r in collect_collectives(log))


@dataclasses.dataclass(frozen=True)
class OverlapCheck:
    """One apply run clean and with its halo poisoned: per local
    contraction, in launch order, whether the poisoned run left its output
    bit-equal (``unchanged``) and whether the poison reached it
    (``poisoned``).  ``exchanged`` is False when the apply ran no exchange
    (an empty halo), and the check then holds vacuously."""

    exchanged: bool
    unchanged: tuple[bool, ...]
    poisoned: tuple[bool, ...]

    @property
    def ok(self) -> bool:
        return not self.exchanged or (any(self.unchanged)
                                      and any(self.poisoned))


def _record_contractions(dop, outputs: list):
    """Wrap ``dop``'s local products (instance attributes shadow the class's
    methods) so each appends a copy of its output to ``outputs``."""
    for name in ("_ell_product", "_bcsr_product"):
        inner = getattr(dop, name)

        def wrapped(*args, _inner=inner, **kwargs):
            out = _inner(*args, **kwargs)
            outputs.append(out.clone())
            return out

        setattr(dop, name, wrapped)


def check_overlap_independence(dop, arrs: dict, x: torch.Tensor, *,
                               apply=None, use_kernel: bool = True,
                               side=None, ranks=None) -> OverlapCheck:
    """Run one apply of ``dop`` on ``x`` twice, clean and with the halo
    poisoned, and compare its local contractions (see the module
    docstring).  ``apply`` (no arguments) runs the apply under test; the
    default is the split form ``dop.apply(arrs, x, overlap=True)`` (its
    exchange between processes when ``ranks`` is given)."""
    if apply is None:
        between = {} if ranks is None else {"ranks": ranks}

        def apply():
            return dop.apply(arrs, x, use_kernel=use_kernel, overlap=True,
                             side=side, **between)
    real = dist_spmv.halo_exchange
    exchanged = []

    def poisoned(*args, **kwargs):
        exchanged.append(True)
        return real(*args, **kwargs).fill_(float("nan"))

    clean: list[torch.Tensor] = []
    dirty: list[torch.Tensor] = []
    with _POISON_LOCK:
        try:
            _record_contractions(dop, clean)
            apply()
            del dop._ell_product, dop._bcsr_product
            _record_contractions(dop, dirty)
            dist_spmv.halo_exchange = poisoned
            apply()
        finally:
            dist_spmv.halo_exchange = real
            for name in ("_ell_product", "_bcsr_product"):
                dop.__dict__.pop(name, None)
    if len(clean) != len(dirty):
        raise RuntimeError(f"the clean and the poisoned apply ran "
                           f"{len(clean)} and {len(dirty)} contractions")
    return OverlapCheck(
        exchanged=bool(exchanged),
        unchanged=tuple(bool(torch.equal(c, d)) for c, d in zip(clean, dirty)),
        poisoned=tuple(bool(torch.isnan(d).any()) for d in dirty))
