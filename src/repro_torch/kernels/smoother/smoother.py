"""The block smoothers' local updates on rank-stacked operands: the wrappers
of the hand-written CUDA kernels ``csrc/block_diag_apply.cu`` and
``csrc/tri_solve.cu``.

They replace no Pallas kernel: the reference applies each block smoother as
a dense per-rank factor, ``x + w · (minv @ r)`` with ``minv`` ``[D, m, m]``
(``repro/amg/dist_solve.py``, ``DistHierarchy._relax``), which these
compute from sparse factors:

* :func:`block_diag_apply` — block-Jacobi, ``x + w · Binv r`` with
  ``Binv`` ``[D, nb, bs, bs]``;
* :func:`tri_solve` — hybrid Gauss-Seidel's half-sweeps, ``x + w · T⁻¹ r``
  with ``T`` the lower (forward) or upper (backward) triangle of each rank's
  local square block, its strict part in ELL (``cols``/``vals``
  ``[D, m, K]``) and its diagonal apart (``diag`` ``[D, m]``).

``r`` and ``x`` are ``[D, m]`` or ``[D, m, k]``.  A wrapper takes the plain
version (:mod:`.ref`) only for tensors that lie on the CPU; for CUDA tensors
it launches its kernel on the current stream or raises.
``<wrapper>.launches`` counts the launches the device ran, replays of a
captured CUDA graph included (:mod:`..launches`); each ``tri_solve`` launch
is a memset of its flags and one kernel.
"""
from __future__ import annotations

import torch

from ..build import kernel
from ..launches import note
from ..spmv.spmv import FLOAT_DTYPES, raise_on_error
from .ref import block_diag_apply_ref, level_schedule, tri_solve_ref


def _on_card(name: str, tensors: dict[str, torch.Tensor],
             r: torch.Tensor, x: torch.Tensor) -> bool:
    """Validate the operands shared by both kernels; True when they lie on
    a CUDA device (the kernel runs), False on the CPU (the plain version)."""
    dt = r.dtype
    if dt not in FLOAT_DTYPES:
        raise TypeError(f"{name}: float32 or float64 operands, got {dt}")
    for what, t in tensors.items():
        if t.dtype != (torch.int32 if what == "cols" else dt):
            raise TypeError(f"{name}: {what} is {t.dtype}, the source {dt}")
    if x.dtype != dt or x.shape != r.shape or r.ndim not in (2, 3):
        raise ValueError(f"{name}: r {r.dtype}{tuple(r.shape)} and x "
                         f"{x.dtype}{tuple(x.shape)} must be one [D, m(, k)]")
    dev = r.device
    if any(t.device != dev for t in (x, *tensors.values())):
        raise ValueError(f"{name}: operands lie on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in (r, x, *tensors.values())):
        raise ValueError(f"{name}: CUDA operands must be contiguous")
    return True


def block_diag_apply(binv: torch.Tensor, r: torch.Tensor, x: torch.Tensor,
                     w: float = 1.0) -> torch.Tensor:
    """``x + w · Binv r``: ``Binv`` ``[D, nb, bs, bs]``, ``nb =
    ceil(m / bs)``, the block grid restarting at each rank's first row."""
    on_card = _on_card("block_diag_apply", {"binv": binv}, r, x)
    D, m = r.shape[:2]
    if binv.ndim != 4 or binv.shape[0] != D or binv.shape[2] != binv.shape[3]:
        raise ValueError(f"block_diag_apply: Binv {tuple(binv.shape)} is no "
                         f"[D={D}, nb, bs, bs]")
    nb, bs = binv.shape[1], binv.shape[2]
    if bs == 0 or nb != -(-m // bs):
        raise ValueError(f"block_diag_apply: {nb} blocks of {bs} for {m} rows")
    if not on_card:
        return block_diag_apply_ref(binv, r, x, w)
    k = r.shape[2] if r.ndim == 3 else 1
    y = torch.empty_like(x)
    if D * m * k == 0:
        return y
    rc = kernel("block_diag_apply")(
        binv.data_ptr(), r.data_ptr(), x.data_ptr(), y.data_ptr(), D, m, nb,
        bs, k, float(w), int(r.dtype == torch.float64),
        torch.cuda.current_stream(r.device).cuda_stream)
    raise_on_error("block_diag_apply", rc)
    note(block_diag_apply)
    return y


def tri_solve(cols: torch.Tensor, vals: torch.Tensor, diag: torch.Tensor,
              r: torch.Tensor, x: torch.Tensor, w: float = 1.0, *,
              upper: bool, order: torch.Tensor | None = None,
              schedule: list[torch.Tensor] | None = None) -> torch.Tensor:
    """``x + w · T⁻¹ r`` with ``T`` the strict triangle ``cols``/``vals``
    ``[D, m, K]`` (-1 padding; columns below the row for the lower
    triangle, above it for ``upper``) plus ``diag`` ``[D, m]``.

    The kernel hands rows out in ``order`` (int32 ``[D·m]``, required on
    the card: :func:`.ref.level_order` of the triangle's level sets); the
    plain version solves ``schedule`` (:func:`.ref.level_schedule`,
    computed from ``cols`` where it is not given)."""
    on_card = _on_card("tri_solve", {"cols": cols, "vals": vals, "diag": diag},
                       r, x)
    D, m = r.shape[:2]
    if (cols.ndim != 3 or tuple(cols.shape[:2]) != (D, m)
            or vals.shape != cols.shape or tuple(diag.shape) != (D, m)):
        raise ValueError(f"tri_solve: cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, diag {tuple(diag.shape)} "
                         f"against r {tuple(r.shape)}")
    if not on_card:
        if schedule is None:
            schedule = level_schedule(cols.numpy(), upper)
        return tri_solve_ref(cols, vals, diag, r, x, w, schedule)
    K = cols.shape[2]
    k = r.shape[2] if r.ndim == 3 else 1
    y = torch.empty_like(x)
    if D * m * k == 0:
        return y
    if D * m >= 2 ** 31:
        raise ValueError(f"tri_solve: {D * m} rows, the kernel takes < 2^31")
    if (order is None or order.dtype != torch.int32
            or tuple(order.shape) != (D * m,) or order.device != r.device):
        raise ValueError(f"tri_solve: the row order must be int32 [{D * m}] "
                         f"on {r.device}")
    z = torch.empty_like(r)
    # the ticket (8 bytes) and one ready flag a row, cleared by the launch
    scratch = torch.empty(2 + D * m, dtype=torch.int32, device=r.device)
    rc = kernel("tri_solve")(
        cols.data_ptr(), vals.data_ptr(), diag.data_ptr(), r.data_ptr(),
        x.data_ptr(), order.data_ptr(), z.data_ptr(), y.data_ptr(),
        scratch.data_ptr(), D, m, K, k, float(w),
        int(r.dtype == torch.float64),
        torch.cuda.current_stream(r.device).cuda_stream)
    raise_on_error("tri_solve", rc)
    note(tri_solve)
    return y


block_diag_apply.launches = 0
tri_solve.launches = 0
