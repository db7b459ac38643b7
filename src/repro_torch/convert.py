"""Carry an AMG hierarchy, born-partitioned levels or LM parameters across
as plain numpy arrays.

:func:`hierarchy_to_arrays` flattens a hierarchy (any object with the
reference's ``solver``/``theta``/``levels`` shape, each level holding CSR
``A``/``P``/``R`` with ``shape``/``indptr``/``indices``/``data``) into a dict
of numpy arrays that ``np.savez`` can store; :func:`hierarchy_from_arrays`
rebuilds it as this package's :class:`~repro_torch.amg.hierarchy.Hierarchy`.
Two implementations fed the same arrays solve the identical system.

:func:`partitioned_to_arrays` does the same for the levels of the
partitioned setup (any list of levels with the reference's
``PartitionedLevel`` shape: ``A``/``P``/``R``/``AP`` each a block matrix
with per-rank global-shape CSR ``blocks`` and a row ``part``):
each rank's block, each level's row partition and the level count.
:func:`partitioned_from_arrays` rebuilds them as this package's
:class:`~repro_torch.amg.dist_setup.PartitionedLevel` s, ready for
:meth:`~repro_torch.amg.dist_solve.DistHierarchy.from_partitioned`.  No
level is ever assembled into one global CSR on the way.

:func:`lm_params_from_arrays` turns the reference's LM parameter pytree (as
nested dicts/tuples of numpy arrays, layer groups stacked on axis 0) into
the state dict of :class:`~repro_torch.models.model.LM`;
:func:`lm_params_to_arrays` is its inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from .amg.csr import CSR
from .amg.dist_setup import BlockMatrix, PartitionedLevel
from .amg.hierarchy import Hierarchy, Level
from .core.topology import Partition, Topology

OPS = ("A", "P", "R")
FIELDS = ("shape", "indptr", "indices", "data")
# the operators of a partitioned level, each with the level whose row
# partition its rows follow (R's rows are the next level's)
PART_OPS = {"A": 0, "P": 0, "R": 1, "AP": 0}


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


def partitioned_to_arrays(plevels) -> dict[str, np.ndarray]:
    """``{"n_pods", "lanes", "n_levels", "L<l>_offsets",
    "L<l>_<op>_r<d>_<field>"...}``: the rank grid, each level's row
    partition offsets, and per level and rank the ``A``/``P``/``R``/``AP``
    blocks (absent on the coarsest level but for ``A``) as
    ``(shape, indptr, indices, data)``."""
    topo = plevels[0].A.part.topo
    out = {"n_pods": np.array(topo.n_nodes), "lanes": np.array(topo.ppn),
           "n_levels": np.array(len(plevels))}
    for l, lv in enumerate(plevels):
        out[f"L{l}_offsets"] = np.asarray(lv.A.part.offsets)
        for op in PART_OPS:
            M = getattr(lv, op)
            if M is None:
                continue
            for d, blk in enumerate(M.blocks):
                key = f"L{l}_{op}_r{d}_"
                out[key + "shape"] = np.asarray(blk.shape, dtype=np.int64)
                out[key + "indptr"] = np.asarray(blk.indptr)
                out[key + "indices"] = np.asarray(blk.indices)
                out[key + "data"] = np.asarray(blk.data)
    return out


def partitioned_from_arrays(d) -> list[PartitionedLevel]:
    """Inverse of :func:`partitioned_to_arrays` (``d`` may be an
    ``NpzFile``): this package's ``PartitionedLevel`` list, each operator a
    ``BlockMatrix`` on its level's partition.  The cached NAP schedules are
    not carried: a refresh of the result selects them anew."""
    topo = Topology(n_nodes=int(d["n_pods"]), ppn=int(d["lanes"]))
    n_levels = int(d["n_levels"])
    parts = []
    for l in range(n_levels):
        offsets = np.array(d[f"L{l}_offsets"], dtype=np.int64)
        parts.append(Partition(n=int(offsets[-1]), topo=topo, offsets=offsets))
    levels = []
    for l in range(n_levels):
        ops = {}
        for op, shift in PART_OPS.items():
            if f"L{l}_{op}_r0_shape" not in d:
                ops[op] = None
                continue
            blocks = []
            for r in range(topo.n_procs):
                key = f"L{l}_{op}_r{r}_"
                shape = tuple(int(s) for s in d[key + "shape"])
                blocks.append(CSR(shape, *(np.array(d[key + f])
                                           for f in FIELDS[1:])))
            ops[op] = BlockMatrix(blocks, parts[l + shift])
        levels.append(PartitionedLevel(**ops))
    return levels


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
    ``lm_head`` keep their names.  Every leaf goes across with its name and
    type, whatever the block kind: attention and FFN weights, and the
    recurrent blocks' (mLSTM ``wi``/``wf`` per head and ``f_bias``; sLSTM
    ``wx``/``rh``/``bias``/``out``; RG-LRU ``in_x``/``in_gate``/``conv``/
    ``wa``/``wi``/``out`` and ``lam``, float32 in both packages)."""
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
