"""Fault-tolerant checkpointing (port of ``repro/ckpt/checkpoint.py``), in
the reference's file format, so a checkpoint written by either package
restores in the other.

* **Format** — one ``step_<n:09d>.npz`` of path-flattened leaves (dict keys
  and sequence indices joined by ``/``, as the reference's pytree paths:
  ``params/groups/0/core/wq``) and a JSON sidecar ``step_<n>.npz.json``
  with the step, the number of arrays and the caller's metadata.
  bfloat16 leaves are stored as float32 (a lossless widening).
* **Atomicity** — written to ``step_<n>.tmp.<pid>`` and published by
  ``os.rename``; a crash mid-save never corrupts the latest checkpoint.
* **Async save** — :func:`save_async` copies the tree to host memory now
  and writes the file in a background thread; the next save waits for it.
* **Restore** — :func:`restore` rebuilds a template-shaped tree, each leaf
  in the template leaf's type, as a tensor on ``device`` where the template
  leaf is a tensor.
* An LM's train state goes to the reference's tree, layer groups stacked
  (:func:`train_state_to_tree`), and back into the model and optimizer
  state in place (:func:`restore_train_state`).
"""
from __future__ import annotations

import json
import os
import re
import threading

import numpy as np
import torch

from ..models.model import layer_slot

_STORED = (np.float64, np.float32, np.float16, np.int64, np.int32, np.int16,
           np.int8, np.uint8, np.bool_)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _items(tree):
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten_with_paths(tree, prefix: str = "", out=None) -> dict:
    out = {} if out is None else out
    items = _items(tree)
    if items is None:
        arr = _to_numpy(tree)
        if arr.dtype.type not in _STORED:
            arr = arr.astype(np.float32)   # bf16/f8 → f32 (lossless upcast)
        out[prefix] = arr
        return out
    for k, v in items:
        _flatten_with_paths(v, f"{prefix}/{k}" if prefix else k, out)
    return out


def _write(ckpt_dir: str, step: int, arrays: dict, metadata, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step:09d}.tmp.{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step:09d}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    meta = {"step": step, "n_arrays": len(arrays), **(metadata or {})}
    with open(tmp + ".json", "w") as f:
        json.dump(meta, f)
    os.rename(tmp + ".json", final + ".json")
    os.rename(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree, metadata: dict | None = None,
         keep: int = 3) -> str:
    return _write(ckpt_dir, step, _flatten_with_paths(tree), metadata, keep)


_pending: list[threading.Thread] = []


def save_async(ckpt_dir: str, step: int, tree, metadata: dict | None = None,
               keep: int = 3) -> threading.Thread:
    """Snapshot now (host copy), write in the background."""
    wait_pending()                             # ordering barrier
    snapshot = _flatten_with_paths(tree)       # device→host copy happens here
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, snapshot, metadata, keep),
                         daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending() -> None:
    """Join every background save."""
    for t in list(_pending):
        t.join()
        _pending.remove(t)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None


def _rebuild(template, data, prefix: str, device):
    items = _items(template)
    if items is None:
        arr = data[prefix]
        if isinstance(template, torch.Tensor):
            t = torch.from_numpy(np.array(arr)).to(template.dtype)
            return t.to(device if device is not None else template.device)
        if hasattr(template, "dtype"):
            arr = arr.astype(template.dtype, copy=False)
        return arr
    kids = {k: _rebuild(v, data, f"{prefix}/{k}" if prefix else k, device)
            for k, v in items}
    if isinstance(template, dict):
        return {k: kids[str(k)] for k in template}
    return type(template)(kids[str(i)] for i in range(len(template)))


def restore(ckpt_dir: str, step: int, template, device=None):
    """Rebuild a ``template``-structured tree from disk: a template leaf
    gives its type (and, as a tensor, its device unless ``device`` is
    given; a numpy or scalar leaf comes back as numpy)."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}.npz")
    with np.load(path) as data:
        return _rebuild(template, data, "", device)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted([int(m.group(1)) for f in os.listdir(ckpt_dir)
                    if (m := re.fullmatch(r"step_(\d+)\.npz", f))])
    for s in steps[:-keep] if keep else []:
        for suffix in (".npz", ".npz.json"):
            try:
                os.remove(os.path.join(ckpt_dir, f"step_{s:09d}{suffix}"))
            except OSError:
                pass


# ------------------------------------------------- an LM's train state
def _stacked(cfg, named: dict) -> dict:
    from ..convert import lm_params_to_arrays

    return lm_params_to_arrays(cfg, {n: t.detach().float() if t.dtype ==
                                     torch.bfloat16 else t.detach()
                                     for n, t in named.items()})


def train_state_to_tree(cfg, model, opt_state: dict) -> dict:
    """``{"params": ..., "opt": {"m", "v", "count"}}`` as the reference's
    loop checkpoints it: numpy trees in the reference's layout (layer groups
    stacked on axis 0), ``count`` an int32 scalar."""
    return {"params": _stacked(cfg, dict(model.named_parameters())),
            "opt": {"m": _stacked(cfg, opt_state["m"]),
                    "v": _stacked(cfg, opt_state["v"]),
                    "count": np.asarray(int(opt_state["count"]), np.int32)}}


def _reference_key(cfg, name: str) -> tuple[str, int | None]:
    """The reference's path of the LM parameter ``name`` and, for a layer
    inside a pattern group, its index on the stacked group axis."""
    parts = name.split(".")
    if parts[0] != "layers":
        return "/".join(parts), None
    g, j = layer_slot(cfg, int(parts[1]))
    rest = "/".join(parts[2:])
    if g is not None:
        return f"groups/{j}/{rest}", g
    return f"extra/{j}/{rest}", None


@torch.no_grad()
def restore_train_state(cfg, model, opt_state: dict, ckpt_dir: str,
                        step: int) -> dict:
    """Load step ``step``'s train state (the reference's layout, as
    :func:`train_state_to_tree` writes it, or the reference's loop) into
    ``model``'s parameters and ``opt_state``'s moments in place, in their
    types and on their devices; returns ``opt_state`` with its count.
    Each stacked array is read once and handed out a layer at a time."""
    params = dict(model.named_parameters())
    by_key: dict[str, list] = {}
    for name in params:
        key, g = _reference_key(cfg, name)
        by_key.setdefault(key, []).append((name, g))
    path = os.path.join(ckpt_dir, f"step_{step:09d}.npz")
    with np.load(path) as data:
        for prefix, dest in (("params", params), ("opt/m", opt_state["m"]),
                             ("opt/v", opt_state["v"])):
            for key, names in by_key.items():
                arr = data[f"{prefix}/{key}"]
                for name, g in names:
                    dest[name].copy_(torch.from_numpy(
                        np.ascontiguousarray(arr if g is None else arr[g])))
        opt_state["count"] = torch.tensor(int(data["opt/count"]),
                                          dtype=torch.int32)
    return opt_state
