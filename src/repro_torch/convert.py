"""Carry an AMG hierarchy across as plain numpy arrays.

:func:`hierarchy_to_arrays` flattens a hierarchy (any object with the
reference's ``solver``/``theta``/``levels`` shape, each level holding CSR
``A``/``P``/``R`` with ``shape``/``indptr``/``indices``/``data``) into a dict
of numpy arrays that ``np.savez`` can store; :func:`hierarchy_from_arrays`
rebuilds it as this package's :class:`~repro_torch.amg.hierarchy.Hierarchy`.
Two implementations fed the same arrays solve the identical system.
"""
from __future__ import annotations

import numpy as np

from .amg.csr import CSR
from .amg.hierarchy import Hierarchy, Level

OPS = ("A", "P", "R")
FIELDS = ("shape", "indptr", "indices", "data")


def hierarchy_to_arrays(h) -> dict[str, np.ndarray]:
    """``{"solver", "theta", "n_levels", "L<l>_<op>_<field>"...}`` — per level
    ``A``/``P``/``R`` (``P``/``R`` absent on the coarsest level) as
    ``(shape, indptr, indices, data)``."""
    out = {"solver": np.array(h.solver), "theta": np.array(float(h.theta)),
           "n_levels": np.array(len(h.levels))}
    for l, lv in enumerate(h.levels):
        for op in OPS:
            M = getattr(lv, op)
            if M is None:
                continue
            out[f"L{l}_{op}_shape"] = np.asarray(M.shape, dtype=np.int64)
            out[f"L{l}_{op}_indptr"] = np.asarray(M.indptr)
            out[f"L{l}_{op}_indices"] = np.asarray(M.indices)
            out[f"L{l}_{op}_data"] = np.asarray(M.data)
    return out


def hierarchy_from_arrays(d) -> Hierarchy:
    """Inverse of :func:`hierarchy_to_arrays` (``d`` may be an ``NpzFile``)."""
    levels = []
    for l in range(int(d["n_levels"])):
        ops = {}
        for op in OPS:
            if f"L{l}_{op}_shape" not in d:
                ops[op] = None
                continue
            shape = tuple(int(s) for s in d[f"L{l}_{op}_shape"])
            ops[op] = CSR(shape, *(np.array(d[f"L{l}_{op}_{f}"])
                                   for f in FIELDS[1:]))
        levels.append(Level(**ops))
    return Hierarchy(solver=str(d["solver"]), levels=levels,
                     theta=float(d["theta"]))
