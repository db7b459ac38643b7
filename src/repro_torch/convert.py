"""Carry an AMG hierarchy or LM parameters across as plain numpy arrays.

:func:`hierarchy_to_arrays` flattens a hierarchy (any object with the
reference's ``solver``/``theta``/``levels`` shape, each level holding CSR
``A``/``P``/``R`` with ``shape``/``indptr``/``indices``/``data``) into a dict
of numpy arrays that ``np.savez`` can store; :func:`hierarchy_from_arrays`
rebuilds it as this package's :class:`~repro_torch.amg.hierarchy.Hierarchy`.
Two implementations fed the same arrays solve the identical system.

:func:`lm_params_from_arrays` turns the reference's LM parameter pytree (as
nested dicts/tuples of numpy arrays, layer groups stacked on axis 0) into
the state dict of :class:`~repro_torch.models.model.LM`;
:func:`lm_params_to_arrays` is its inverse.
"""
from __future__ import annotations

import numpy as np
import torch

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


def _flatten(prefix: str, tree: dict, out: dict, index=None) -> None:
    for name, value in tree.items():
        key = f"{prefix}.{name}"
        if isinstance(value, dict):
            _flatten(key, value, out, index)
        else:
            a = np.asarray(value)
            out[key] = torch.tensor(a if index is None else a[index])


def lm_params_from_arrays(cfg, tree) -> dict[str, torch.Tensor]:
    """The reference's ``init_params`` tree → an ``LM`` state dict (CPU
    tensors).  ``groups`` (a tuple over ``cfg.pattern`` of stacked block
    trees) is unstacked on axis 0, one layer per (group, pattern position);
    ``extra`` blocks follow; ``embed``, ``final_norm`` and an untied
    ``lm_head`` keep their names."""
    L = len(cfg.pattern)
    groups = tree["groups"]
    n_groups = np.asarray(groups[0]["ln1"]["scale"]).shape[0]
    out: dict[str, torch.Tensor] = {}
    for g in range(n_groups):
        for j in range(L):
            _flatten(f"layers.{g * L + j}", groups[j], out, index=g)
    for e, block in enumerate(tree.get("extra", ())):
        _flatten(f"layers.{n_groups * L + e}", block, out)
    _flatten("final_norm", tree["final_norm"], out)
    for name in ("embed", "lm_head"):
        if name in tree:
            out[name] = torch.tensor(np.asarray(tree[name]))
    return out


def _unflatten(state: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, t in state.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


def _stack(trees: list[dict]) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else np.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def lm_params_to_arrays(cfg, state) -> dict:
    """Inverse of :func:`lm_params_from_arrays`: an ``LM`` state dict → the
    reference's tree of numpy arrays (``groups`` stacked, ``extra`` present
    only when ``n_layers % len(pattern)``)."""
    L = len(cfg.pattern)
    n_groups, n_extra = divmod(cfg.n_layers, L)
    blocks = [_unflatten(state, f"layers.{i}.") for i in range(cfg.n_layers)]
    tree = {"groups": tuple(_stack(blocks[j:n_groups * L:L]) for j in range(L)),
            "final_norm": _unflatten(state, "final_norm.")}
    if n_extra:
        tree["extra"] = tuple(blocks[n_groups * L:])
    for name in ("embed", "lm_head"):
        if name in state:
            tree[name] = state[name].detach().cpu().numpy()
    return tree
