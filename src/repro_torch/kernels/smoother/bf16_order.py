"""The orders of float32 arithmetic of the block smoothers' bfloat16
instances (``csrc/tri_solve.cu``, ``csrc/block_diag_apply.cu``), emulated
on the host, bit for bit.

Each kernel rounds every fused multiply-add once (``fmaf``).  A product of
a bfloat16 (or float32) value and a float32 one holds at most 48
significant bits, so float64 holds it exactly; the sum with the float32
addend is then rounded to float64 with round-to-odd (the round-to-nearest
sum, moved one ulp toward the exact sum where it is inexact and its last
bit is even, the error known exactly from a TwoSum), and that to float32
with round-to-nearest.  Round-to-odd at 53 bits followed by rounding to 24
is the one correct rounding of the exact sum (53 >= 24 + 2), so no double
rounding enters: :func:`fma32` is ``fmaf``.

* ``tri_solve`` at k = 1: the L2 and block routes give a row G = 32 lanes;
  lane g adds the products of slots g, g + 32, ... in turn (the first onto
  0), then the lanes meet in a butterfly (xor 16, 8, 4, 2, 1) whose lane 0
  divides: :func:`butterfly_sums`.  The staged route gives a row one lane,
  which adds slot e into leaf e mod 32 and meets the leaves as the
  butterfly's lane 0 does, its padding slots adding 0 · 0 and the
  butterfly's steps past its leaves (which add zeros) skipped:
  :func:`staged_sums`, the same sums (a zero's sign aside).  :func:`tri_solve_emulate`
  is the whole bfloat16 solve on either order: z float32, z_i = (r_i − sum)
  / d_i, y = fma(w, z, x) rounded to bfloat16.
* ``block_diag_apply``: each output adds Binv[i, c] · r[c] for c = 0 ..
  bs − 1 in turn (products of two bfloat16 values, exact in float32) and
  stores fma(w, sum, x) rounded to bfloat16: :func:`block_diag_apply_emulate`.

The plain versions (:mod:`.ref`) sum in another order and agree within
one rounding.
"""
from __future__ import annotations

import numpy as np
import torch

LANES = 32            # the L2 and block routes' lanes a row at k = 1 (tri_solve.cu: LANES)


def fma32(a, b, c) -> np.ndarray:
    """``fmaf(a, b, c)``: a·b + c over float32 arrays, rounded once to
    float32 (round-to-odd in float64, then to nearest; see the module)."""
    a, b, c = (np.asarray(t, dtype=np.float32).astype(np.float64) for t in (a, b, c))
    p = a * b                                   # exact: <= 48 bits
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)             # TwoSum: p + c = s + err exactly
    even = (s.view(np.int64) & 1) == 0
    odd = np.where((err != 0) & even & np.isfinite(s),
                   np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return odd.astype(np.float32)


def _products(vals, zg):
    """Widened float32 numpy copies of ``vals`` and ``zg`` (``[n, K]``)."""
    return (np.asarray(torch.as_tensor(vals).float()),
            np.asarray(torch.as_tensor(zg).float()))


def butterfly_sums(vals, zg, keep) -> np.ndarray:
    """The L2 and block routes' sums of ``vals · zg`` over each row's slots
    (``[n, K]``; slots where ``keep`` is False are padding): lane g of 32
    adds slots g, g + 32, ... by ``fmaf``, the lanes meet by ``acc +=
    shfl_xor(acc, o)`` for o = 16, ..., 1, lane 0's sum is returned
    (float32 ``[n]``)."""
    v, z = _products(vals, zg)
    keep = np.asarray(keep)
    n, K = v.shape
    acc = np.zeros((n, LANES), dtype=np.float32)
    for e in range(K):
        g = e % LANES
        acc[:, g] = np.where(keep[:, e], fma32(v[:, e], z[:, e], acc[:, g]), acc[:, g])
    lanes = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ o]
    return acc[:, 0]


def staged_sums(vals, zg, keep) -> np.ndarray:
    """The staged route's sums (one lane a row, :func:`butterfly_sums`'s
    arguments): the row's KP = ``smoother.staged_slots(K)`` slots, slot e
    into leaf e mod NL by ``fmaf`` in increasing e (padding slots and those
    past K add 0 · 0), NL the least power of two holding KP slots (32 past
    32), then leaf[i] += leaf[i + o] for o = NL / 2, ..., 1."""
    from .smoother import staged_slots

    v, z = _products(vals, zg)
    keep = np.asarray(keep)
    n, K = v.shape
    kp = staged_slots(K)
    nl = 1
    while nl < min(kp, LANES):
        nl *= 2
    nl = LANES if K > LANES or kp == 0 else nl
    leaf = np.zeros((n, nl), dtype=np.float32)
    for e in range(kp):
        j = e % nl
        ve = np.where(keep[:, e], v[:, e], 0) if e < K else np.zeros(n)
        ze = np.where(keep[:, e], z[:, e], 0) if e < K else np.zeros(n)
        leaf[:, j] = fma32(ve, ze, leaf[:, j])
    o = nl // 2
    while o:
        leaf[:, :o] = leaf[:, :o] + leaf[:, o:2 * o]
        o //= 2
    return leaf[:, 0]


def tri_solve_emulate(cols, vals, diag, r, x, w: float, schedule,
                      order: str = "staged") -> torch.Tensor:
    """The bfloat16 ``tri_solve`` at k = 1 (``r``, ``x`` ``[D, m]``) with
    each row's sum in ``order`` ("staged" or "butterfly"), level set by
    level set (``schedule``: :func:`.ref.level_schedule`); returns y in
    bfloat16 on ``r``'s device."""
    D, m, K = cols.shape
    sums = staged_sums if order == "staged" else butterfly_sums
    c = np.asarray(cols.cpu()).reshape(D * m, K).astype(np.int64)
    keep = c >= 0
    fc = np.where(keep, c + (np.arange(D * m) // m * m)[:, None], 0)
    v = np.asarray(vals.cpu().float()).reshape(D * m, K)
    dg = np.asarray(diag.cpu().float()).reshape(D * m)
    z = np.asarray(r.cpu().float()).reshape(D * m).copy()
    for rows in schedule:
        rows = np.asarray(rows.cpu())
        s = sums(v[rows], z[fc[rows]], keep[rows])
        z[rows] = (z[rows] - s) / dg[rows]
    y = fma32(np.float32(w), z, np.asarray(x.cpu().float()).reshape(D * m))
    return torch.as_tensor(y).reshape(D, m).to(torch.bfloat16).to(r.device)


def block_diag_apply_emulate(binv, r, x, w: float) -> torch.Tensor:
    """The bfloat16 ``block_diag_apply``'s result (``Binv`` ``[D, nb, bs,
    bs]``, ``r``, ``x`` ``[D, m]`` or ``[D, m, k]``) in its order: each
    output's sum over c = 0 .. bs − 1 in turn, then fma(w, sum, x),
    rounded to bfloat16; on ``r``'s device."""
    D, nb, bs, _ = binv.shape
    m = r.shape[1]
    B = np.asarray(binv.cpu().float())
    R = np.asarray(r.cpu().float()).reshape(D, m, -1)
    X = np.asarray(x.cpu().float()).reshape(D, m, -1)
    Rp = np.zeros((D, nb * bs, R.shape[2]), dtype=np.float32)
    Rp[:, :m] = R
    Rb = Rp.reshape(D, nb, bs, -1)                       # [D, nb, c, k]
    acc = np.zeros((D, nb, bs, R.shape[2]), dtype=np.float32)
    rows = np.arange(nb)[:, None] * bs + np.arange(bs)     # [nb, c]
    for c in range(bs):
        # a product of two bfloat16 values is exact in float32; a last
        # block's columns past m are not read
        add = acc + B[:, :, :, c, None] * Rb[:, :, None, c, :]
        acc = np.where((rows[:, c] < m)[None, :, None, None], add, acc)
    acc = acc.reshape(D, nb * bs, -1)[:, :m]
    y = fma32(np.float32(w), acc, X)
    return torch.as_tensor(y).reshape(r.shape).to(torch.bfloat16).to(r.device)
