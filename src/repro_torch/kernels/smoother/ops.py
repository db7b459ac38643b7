"""The block smoothers' factors on the device and their dispatch.

A :class:`BlockFactor` (block-Jacobi) or :class:`TriFactor` (one hybrid
Gauss-Seidel half-sweep) holds one level's factor as rank-stacked tensors;
``apply(r, x, w, use_kernel)`` computes ``x + w·M⁻¹ r`` through the kernel
wrapper (``use_kernel=None``/``True``: the CUDA kernel for CUDA tensors,
the plain version for CPU ones) or, with ``use_kernel=False``, through the
plain version explicitly.  ``VALUES`` names the tensors a refresh copies
new values into, in place, so captured graphs read them on their next
replay.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ref import (block_diag_apply_ref, dag_levels, level_schedule,
                  rank_level_order, rank_level_starts, tri_solve_ref)
from .smoother import block_diag_apply, tri_solve


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
    keeps them) for the plain version's level sets, built on first use."""

    cols: torch.Tensor
    vals: torch.Tensor
    diag: torch.Tensor
    order: torch.Tensor
    starts: torch.Tensor
    upper: bool
    host_cols: np.ndarray
    levels: np.ndarray
    _schedule: list | None = dataclasses.field(default=None, repr=False)
    VALUES = ("vals", "diag")

    @classmethod
    def place(cls, host: dict, device, dtype) -> "TriFactor":
        upper = bool(host["upper"])
        levels = dag_levels(host["cols"], upper)
        return cls(torch.as_tensor(host["cols"]).to(device=device),
                   torch.as_tensor(host["vals"]).to(device=device, dtype=dtype),
                   torch.as_tensor(host["diag"]).to(device=device, dtype=dtype),
                   torch.as_tensor(rank_level_order(levels)).to(device=device),
                   torch.as_tensor(rank_level_starts(levels)).to(device=device),
                   upper, host["cols"], levels)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.cols, self.vals, self.diag, self.order, self.starts)

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
                         schedule=self.schedule() if on_cpu else None)


def place_factor(host: dict, device, dtype):
    """The device factor of one host factor dict (its ``kind`` says which)."""
    return (BlockFactor if host["kind"] == "bj" else TriFactor).place(
        host, device, dtype)


__all__ = ["BlockFactor", "TriFactor", "place_factor"]
