"""The order of float32 sums of the bfloat16 ELL kernels' bulk design
(``csrc/ell_bf16.cuh``, which the bfloat16 launches of ``ell_spmv`` and
``ell_spmm`` take for the shapes :func:`bulk` names), emulated in plain
PyTorch.

The kernel gives each row G lanes over its slots: slot s goes to lane
s % G, and each lane adds its products in increasing s into a float32 sum
(a fused multiply-add of two bfloat16 values, whose product float32 holds
exactly).  A row longer than a stage is streamed in chunks; a lane's sum
carries from chunk to chunk, so the chunks and the units of rows that
blocks take do not enter the order.  The G sums then meet in a shuffle
tree (xor G/2, ..., 1) and the result is rounded to bfloat16 once.  G
follows :func:`plan`, the launch's rule, from the row count, K, k and the
columns a lane takes (W, from k and the alignment of X and Y:
:func:`lane_width`).

:func:`emulate` computes the kernel's result bit for bit (the card tests
hold the kernel to it); the plain versions in :mod:`.ref` sum in another
order and agree within one rounding.
"""
from __future__ import annotations

import torch

from .ref import _gather_rows

# the kernel's constants (csrc/ell_bf16.cuh; a CPU test reads them there)
CONSUMERS = 128        # threads that sum rows, a block
STAGE_SLOTS = 3456     # slots a shared-memory stage holds
MAX_LANES = 16         # lanes a row at most
TARGET_UNITS = 512     # units of more lanes a row, at most (one wave)


# the shape rule of each kernel's bfloat16 launch: which operands take the
# bulk design (csrc/ell_spmv.cu:BULK_SLOTS, csrc/ell_spmm.cu:FLAT_K and
# FLAT_SLOTS; the rest take the kernel's own float32 / float64 design)
SPMV_BULK_SLOTS = 1 << 22
SPMM_FLAT_K, SPMM_FLAT_SLOTS = 16, 1 << 20


def bulk(kernel: str, rows: int, K: int) -> bool:
    """Whether ``kernel`` ("ell_spmv" or "ell_spmm") runs ``rows`` rows of K
    slots in bfloat16 on the bulk design (whose order :func:`emulate`
    computes)."""
    if kernel == "ell_spmv":
        return rows * K >= SPMV_BULK_SLOTS
    return not (K < SPMM_FLAT_K and rows * K >= SPMM_FLAT_SLOTS)


def lane_width(k: int, x_ptr: int = 0, y_ptr: int = 0) -> int:
    """W, the columns one lane takes: the widest of 8, 4, 2 that divides
    ``k`` and keeps X's and Y's pieces aligned (their addresses), else 1."""
    at = x_ptr | y_ptr
    for w in (8, 4, 2):
        if k % w == 0 and at % (2 * w) == 0:
            return w
    return 1


def plan(rows: int, K: int, k: int, W: int) -> dict[str, int]:
    """The launch's lanes and rows for ``rows`` (D·n) rows of K slots: V
    lanes of W columns a row, G lanes a row over its slots (1, doubled
    while a unit of R rows would not fit a stage, then while 2G <= K and
    the operand cut for 2G lanes still has at most TARGET_UNITS units; at
    most MAX_LANES / V, 1 where V is no power of two), R rows a unit, KT
    columns a tile."""
    V = min(-(-k // W), MAX_LANES)
    gmax = MAX_LANES // V if V & (V - 1) == 0 else 1
    G = 1

    def rows_of(g):
        return CONSUMERS // (V * g) // 8 * 8

    def units(g):
        return -(-rows // rows_of(g))

    while G < gmax and rows_of(G) * K > STAGE_SLOTS:
        G *= 2
    while G < gmax and 2 * G <= K and units(2 * G) <= TARGET_UNITS:
        G *= 2
    return {"V": V, "G": G, "R": rows_of(G), "KT": V * W}


def emulate(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
            W: int | None = None) -> torch.Tensor:
    """The bfloat16 kernel's result for ``cols``/``vals`` ``[D, n, K]`` and
    ``x`` ``[D, m]`` (``ell_spmv``) or ``[D, m, k]`` (``ell_spmm``), with W
    columns a lane (default: :func:`lane_width` of aligned operands)."""
    spmv = x.ndim == 2
    X = x[..., None] if spmv else x
    D, n, K = cols.shape
    k = X.shape[2]
    G = plan(D * n, K, k, W or lane_width(k))["G"]
    keep = (cols >= 0)[..., None]
    # float32 products of bfloat16 operands are exact: fma(v, x, acc) is
    # acc + v * x rounded once
    prod = vals.float()[..., None] * _gather_rows(X, cols).float()
    acc = torch.zeros((G, D, n, k), dtype=torch.float32, device=x.device)
    for s in range(K):
        g = s % G
        acc[g] = torch.where(keep[:, :, s], acc[g] + prod[:, :, s], acc[g])
    h = G // 2
    while h >= 1:
        acc[:h] = acc[:h] + acc[h:2 * h]
        h //= 2
    y = acc[0].to(torch.bfloat16)
    return y[..., 0] if spmv else y
