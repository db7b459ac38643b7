"""The block smoothers' factors on the device and their dispatch.

A :class:`BlockFactor` (block-Jacobi) or :class:`TriFactor` (one hybrid
Gauss-Seidel half-sweep) holds one level's factor as rank-stacked tensors;
``apply(r, x, w, use_kernel)`` computes ``x + w·M⁻¹ r`` through the kernel
wrapper (``use_kernel=None``/``True``: the CUDA kernel for CUDA tensors,
the plain version for CPU ones) or, with ``use_kernel=False``, through the
plain version explicitly.  ``VALUES`` names the tensors a refresh copies
new values into, in place, so captured graphs read them on their next
replay; ``sync_values()`` then rewrites, in place too, what a factor
derives from them (a bfloat16 triangle's slab for the staged route, where
it holds one).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ref import (block_diag_apply_ref, dag_levels, level_schedule,
                  rank_level_order, rank_level_starts, tri_solve_ref)
from .smoother import TriSlab, block_diag_apply, tri_plan, tri_smem, tri_solve


@dataclasses.dataclass(eq=False)
class BlockFactor:
    """Block-Jacobi: ``binv`` ``[D, nb, bs, bs]``."""

    binv: torch.Tensor
    VALUES = ("binv",)

    @classmethod
    def place(cls, host: dict, device, dtype) -> "BlockFactor":
        return cls(torch.as_tensor(host["binv"]).to(device=device, dtype=dtype))

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.binv,)

    def sync_values(self) -> None:
        """Nothing derives from ``binv``."""

    def apply(self, r, x, w: float, use_kernel: bool = True):
        if use_kernel is False:
            return block_diag_apply_ref(self.binv, r, x, w)
        return block_diag_apply(self.binv, r, x, w)


@dataclasses.dataclass(eq=False)
class TriFactor:
    """One triangle: strict part ``cols``/``vals`` ``[D, m, K]`` (-1
    padding), ``diag`` ``[D, m]``, and the kernel's row order, built on the
    host once per pattern: ``order`` (int32 ``[D, m]``, each rank's rows
    sorted by their level set in the triangle's DAG,
    :func:`.ref.rank_level_order`) and ``starts`` (int32 ``[D, nlev + 1]``,
    where each rank's level sets begin in it, :func:`.ref.rank_level_starts`).
    ``host_cols`` and ``levels`` stay on the host (pattern only: a refresh
    keeps them) for the plain version's level sets, built on first use.
    A factor whose launches at k = 1 the rule sends to the staged route
    (bfloat16 on the card, :func:`.smoother.tri_plan`) also holds ``slab``,
    that route's operand for its own order (:class:`.smoother.TriSlab`),
    built when it is placed; other factors hold None."""

    cols: torch.Tensor
    vals: torch.Tensor
    diag: torch.Tensor
    order: torch.Tensor
    starts: torch.Tensor
    upper: bool
    host_cols: np.ndarray
    levels: np.ndarray
    _schedule: list | None = dataclasses.field(default=None, repr=False)
    slab: TriSlab | None = dataclasses.field(default=None, repr=False)
    VALUES = ("vals", "diag")

    @classmethod
    def place(cls, host: dict, device, dtype) -> "TriFactor":
        upper = bool(host["upper"])
        levels = dag_levels(host["cols"], upper)
        f = cls(torch.as_tensor(host["cols"]).to(device=device),
                torch.as_tensor(host["vals"]).to(device=device, dtype=dtype),
                torch.as_tensor(host["diag"]).to(device=device, dtype=dtype),
                torch.as_tensor(rank_level_order(levels)).to(device=device),
                torch.as_tensor(rank_level_starts(levels)).to(device=device),
                upper, host["cols"], levels)
        if _plans_staged(f.cols, f.starts, f.vals.dtype):
            f.slab = TriSlab(f.cols, f.vals, f.diag, f.order)
        return f

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return ((self.cols, self.vals, self.diag, self.order, self.starts)
                + (() if self.slab is None else (self.slab.data,)))

    def sync_values(self) -> None:
        """Rewrite the slab, where there is one, in place from ``vals`` and
        ``diag``."""
        if self.slab is not None:
            self.slab.fill()

    def schedule(self) -> list[torch.Tensor]:
        """The plain version's level sets (flat row indices on the factor's
        device)."""
        if self._schedule is None:
            self._schedule = level_schedule(self.host_cols, self.upper,
                                            self.cols.device, self.levels)
        return self._schedule

    def depth(self) -> int:
        """Level sets of each rank's triangle DAG, the deepest rank's."""
        return int(self.levels.max(initial=-1)) + 1

    def apply(self, r, x, w: float, use_kernel: bool = True):
        if use_kernel is False:
            return tri_solve_ref(self.cols, self.vals, self.diag, r, x, w,
                                 self.schedule())
        on_cpu = self.cols.device.type == "cpu"
        return tri_solve(self.cols, self.vals, self.diag, r, x, w,
                         upper=self.upper, order=(self.order, self.starts),
                         schedule=self.schedule() if on_cpu else None,
                         slab=self.slab)


def _plans_staged(cols: torch.Tensor, starts: torch.Tensor,
                  dtype: torch.dtype) -> bool:
    """Whether the rule sends this triangle's launches at k = 1 to the
    staged route: on the card only (the plain version reads no slab)."""
    if cols.device.type != "cuda" or dtype != torch.bfloat16:
        return False
    _, m, K = cols.shape
    return tri_plan(m, starts.shape[1] - 1, 1, dtype, tri_smem(cols.device),
                    K=K) == "staged"


def place_factor(host: dict, device, dtype):
    """The device factor of one host factor dict (its ``kind`` says which)."""
    return (BlockFactor if host["kind"] == "bj" else TriFactor).place(
        host, device, dtype)


__all__ = ["BlockFactor", "TriFactor", "place_factor"]
