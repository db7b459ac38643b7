"""The float32 arithmetic of the Hopper flash design (``csrc/
flash_attention_tf32.cu``: 3xTF32 on ``wgmma``), emulated in plain PyTorch.

Every operand element x is split into hi = rna(x) and lo = rna(x - hi),
both TF32 values (10 mantissa bits; rna: to nearest, ties away from zero),
so the tensor cores read them whole whatever they do with a float32 word's
13 low bits.  A product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi.

The tensor cores' float32 sums are modelled as in ``flash_attention.cu``:
each ``wgmma`` k-step adds its eight exact products to the accumulator and
rounds the sum toward zero.  A chain of k-steps therefore loses up to an
ulp of its running magnitude a step, always toward zero, so the design
keeps chains short and puts the small products first:

- S = Q K^T: the two consumer warpgroups split the head dim, each summing
  its half in ``chains`` chains from zero (every Q_lo K_hi k-step, then
  every Q_hi K_lo, then every Q_hi K_hi), the chains added by Fast2Sum with
  the error kept aside; the two halves meet in one float32 add (rounded to
  nearest; a + b = b + a, so both consumers hold the same scores);
- the online softmax as in the other kernels (max on the raw scores, the
  scale into log2 units in the exp's fused multiply-add, a masked score -inf
  against a running max that starts at -1e30);
- each key tile's P V from zero in its own chain (P_lo V_hi, P_hi V_lo,
  P_hi V_hi over the tile's k-steps), folded in by o = o * alpha + (P V)
  in one rounding, so the output never rides a chain longer than a tile;
- o / l at the end (l == 0 -> 1).

:func:`emulate` is held against the reference's Pallas kernel and against a
float64 truth by the CPU tests; the card tests hold the kernel to the plain
version and to the truth at the same bars.
"""
from __future__ import annotations

import numpy as np
import torch

LOG2E = np.float32(1.4426950408889634)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32: 10 mantissa bits, to nearest with
    ties away from zero (half a TF32 ulp added to the magnitude bits, the 13
    low bits cleared); inf and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, bits, (bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo to 2^-22 of |x|, both TF32 values (x - hi is exact)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def chain(terms) -> torch.Tensor:
    """A wgmma chain from zero: ``terms`` yields (a, b) pairs of float64
    TF32 values, each one k-step (the contraction over their last / first
    dims, eight long) added to the float32 accumulator in one rounding
    toward zero."""
    acc = None
    for a, b in terms:
        step = a @ b
        acc = round_toward_zero(step if acc is None else acc.double() + step)
    return acc


def _products(a_hi, a_lo, b_hi, b_lo, steps, passes=3):
    """The 3xTF32 k-steps of a chain, small products first: every a_lo b_hi,
    then every a_hi b_lo, then every a_hi b_hi (k-step kk: columns 8 kk ..
    8 kk + 7 of a, rows of b); ``passes=1``: a_hi b_hi alone (plain TF32)."""
    pairs = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
    for a, b in pairs[3 - passes:]:
        for kk in range(steps):
            yield a[..., 8 * kk:8 * kk + 8], b[..., 8 * kk:8 * kk + 8, :]


def emulate(q, k, v, causal: bool = True, window: int | None = None, *,
            bk: int, chains: int = 1, passes: int = 3) -> torch.Tensor:
    """The kernel's result on float32 [B, H, S, D] operands (numpy arrays
    or CPU tensors): key tiles of ``bk`` keys; each consumer's half of the
    head dim summed in ``chains`` chains from zero, added by Fast2Sum with
    the error kept aside, the halves then added once.  Queries right-aligned
    at Skv; ``window``: keys with 0 <= q_pos - k_pos < window; ``passes=1``:
    one TF32 product (hi x hi) in place of three."""
    q, k, v = (torch.as_tensor(a, dtype=torch.float32) for a in (q, k, v))
    B, H, Sq, D = q.shape
    Skv, group = k.shape[2], H // k.shape[1]
    dh = D // 2
    cd = dh // chains
    assert D % 2 == 0 and dh % chains == 0 and cd % 8 == 0 and bk % 8 == 0
    n_kt = -(-Skv // bk)
    pad = n_kt * bk - Skv
    k, v = (torch.nn.functional.pad(a.repeat_interleave(group, 1), (0, 0, 0, pad))
            for a in (k, v))
    scale_log2 = torch.tensor(np.float32(np.float32(1.0 / np.sqrt(D)) * LOG2E))
    q_hi, q_lo = (x.double() for x in split(q))
    qpos = torch.arange(Sq)[:, None] + (Skv - Sq)
    m = torch.full((B, H, Sq), -1e30, dtype=torch.float32)
    l = torch.zeros((B, H, Sq), dtype=torch.float32)
    o = torch.zeros((B, H, Sq, D), dtype=torch.float32)
    # the chains of both consumers side by side: chain c of consumer w is
    # index w * chains + c of a leading axis, its dims c * cd .. of w's half
    n_ch = 2 * chains

    def by_chain(x):                            # [..., D] -> [n_ch, ..., cd]
        return x.unflatten(-1, (n_ch, cd)).movedim(-2, 0)

    q_hi, q_lo = by_chain(q_hi), by_chain(q_lo)
    for kt in range(n_kt):
        ks, vs = k[:, :, kt * bk:(kt + 1) * bk], v[:, :, kt * bk:(kt + 1) * bk]
        k_hi, k_lo = (by_chain(x.double()).transpose(-1, -2) for x in split(ks))
        parts = chain(_products(q_hi, q_lo, k_hi, k_lo, cd // 8, passes))
        halves = []
        for w in range(2):                      # the consumers
            hs, he = parts[w * chains], torch.zeros_like(parts[0])
            for c in range(1, chains):          # Fast2Sum
                t = hs + parts[w * chains + c]
                he = he + (parts[w * chains + c] - (t - hs))
                hs = t
            halves.append(hs + he)
        s = halves[0] + halves[1]
        kpos = kt * bk + torch.arange(bk)[None, :]
        ok = kpos < Skv
        if causal:
            ok = ok & (qpos >= kpos)
        if window is not None:
            ok = ok & (qpos - kpos < window)
        x = torch.where(ok, s, -torch.inf)
        m_new = torch.maximum(m, x.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(_fma(x, scale_log2, -m_new[..., None]))
        l = _fma(l, alpha, p.sum(-1))
        m = m_new
        p_hi, p_lo = (t.double() for t in split(p))
        v_hi, v_lo = (t.double() for t in split(vs))
        part = chain(_products(p_hi, p_lo, v_hi, v_lo, bk // 8, passes))
        o = _fma(o, alpha[..., None], part)
    return o * (1.0 / torch.where(l == 0, 1.0, l))[..., None]


def _fma(a, b, c):
    """a * b + c in one rounding to float32."""
    return (a.double() * b.double() + c.double()).float()
