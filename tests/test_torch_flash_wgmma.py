"""The bfloat16 flash kernel for Hopper (``csrc/flash_attention_wgmma.cu``:
``wgmma`` fed by TMA, warp-specialised) on the CPU, where it cannot run:
the register layouts its products rest on (the m64nNk16 accumulator of
S = Q K^T taken as the k16 A operand of O += P V, register by register, as
the source packs it), its shared-memory and TMA plan read from the source,
the route table that sends each (dtype, head dim) to one kernel, the
wrapper's counts per kernel, and the kernel's arithmetic (key tiles of the
source's width, P rounded to bfloat16 once before P V, the output once)
emulated in torch and held against the reference's Pallas kernel in
interpret mode."""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jflash  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

SRC = (Path(fa.__file__).parent / "csrc" / "flash_attention_wgmma.cu").read_text()
WGMMA = "flash_attention_wgmma"
SMEM_PER_BLOCK = 232_448        # an H100's opt-in shared memory a block
REGS_PER_SM = 65_536


def _cfg(head_dim: int) -> dict:
    """The source's tile shape at ``head_dim`` (its ``Cfg<D>`` or the
    specialisation ``Cfg<head_dim>``)."""
    m = re.search(rf"struct Cfg<{head_dim}> \{{(.*?)\}};", SRC, re.S) or \
        re.search(r"template <int D>\nstruct Cfg \{(.*?)\};", SRC, re.S)
    body = m.group(1)
    return {"BK": int(re.search(r"BK = (\d+)", body).group(1)),
            "STAGES": int(re.search(r"STAGES = (\d+)", body).group(1))}


def _const(name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", SRC).group(1))


# ---------------------------------------------------------------------------
# wgmma's m64nNk16 register layouts (PTX ISA: .bf16 inputs, .f32 accumulator)
# for thread `lane` of warp w (0..3) of the warpgroup; g = lane / 4, t = lane % 4
# ---------------------------------------------------------------------------


def acc_pos(w: int, lane: int, i: int) -> tuple[int, int]:
    """Accumulator register i: (row, column) of the 64 x N result."""
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * ((i % 4) // 2), 8 * (i // 4) + 2 * t + i % 2


def a_pos(w: int, lane: int, r: int, h: int) -> tuple[int, int]:
    """Register r (0..3) of the A operand from registers, its half h (0: the
    low 16 bits): (row, column) of the 64 x 16 A tile."""
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * (r % 2), 2 * t + h + 8 * (r // 2)


THREADS = [(w, lane) for w in range(4) for lane in range(32)]


def packing() -> list[tuple[int, int]]:
    """``pack_p`` as the source writes it: for A register r of k-step kk,
    the two score registers s[8 kk + lo], s[8 kk + hi] it packs (lo into the
    low half)."""
    body = re.search(r"void pack_p\(.*?\n\}", SRC, re.S).group(0)
    regs = re.findall(r"pa\[kk\]\[(\d)\] = pack_bf16\(s\[8 \* kk \+ (\d)\], "
                      r"s\[8 \* kk \+ (\d)\]\);", body)
    assert [int(r) for r, _, _ in regs] == [0, 1, 2, 3]
    return [(int(lo), int(hi)) for _, lo, hi in regs]


def _pv_from_registers(P: np.ndarray, V: np.ndarray, order) -> np.ndarray:
    """O = P V done as the kernel does it: P (64 x BK) laid out as S's
    accumulator registers, each k-step's A registers packed from them by
    ``order`` (``packing()``'s form) and read by the instruction in its A
    layout, times V's 16 rows of that k-step."""
    bk = P.shape[1]
    regs = {}
    for w, lane in THREADS:
        for i in range(bk // 2):
            regs[w, lane, i] = P[acc_pos(w, lane, i)]
    out = np.zeros((64, V.shape[1]))
    for kk in range(bk // 16):
        A = np.full((64, 16), np.nan)
        for w, lane in THREADS:
            for r, pair in enumerate(order):
                for h in range(2):
                    A[a_pos(w, lane, r, h)] = regs[w, lane, 8 * kk + pair[h]]
        assert not np.isnan(A).any()
        out += A @ V[16 * kk:16 * kk + 16]
    return out


def test_accumulator_layout_covers_the_tile_once():
    """Each (row, column) of a 64 x N accumulator (N = each head dim's key
    tile and each head dim) and each of a 64 x 16 A tile is held by one
    register of one thread."""
    for n in sorted({_cfg(d)["BK"] for d in fa.HEAD_DIMS} | set(fa.HEAD_DIMS)):
        seen = sorted(acc_pos(w, lane, i) for w, lane in THREADS for i in range(n // 2))
        assert seen == [(r, c) for r in range(64) for c in range(n)]
    seen = sorted(a_pos(w, lane, r, h) for w, lane in THREADS
                  for r in range(4) for h in range(2))
    assert seen == [(r, c) for r in range(64) for c in range(16)]


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_p_from_accumulator_registers_multiplies_like_p_v(d):
    """The ``wgmma`` twin of ``test_torch_flash_attention.py::
    test_a_fragment_from_score_registers_multiplies_like_p_v``: P taken from
    the score accumulator registers as ``pack_p`` packs them, read as the k16
    A operand, times V gives P V exactly; the register order of the 3xTF32
    instance (c0, c2, c1, c3 on 8-key steps, here the two middle registers
    swapped) and a packing with the halves swapped do not; at each head
    dim's key tile (the source's BK) and output width."""
    bk = _cfg(d)["BK"]
    rng = np.random.default_rng(7)
    P = rng.integers(-8, 9, (64, bk)).astype(np.float64)
    V = rng.integers(-8, 9, (bk, d)).astype(np.float64)
    order = packing()
    np.testing.assert_array_equal(_pv_from_registers(P, V, order), P @ V)
    for wrong in ([order[0], order[2], order[1], order[3]],
                  [(hi, lo) for lo, hi in order]):
        assert not np.array_equal(_pv_from_registers(P, V, wrong), P @ V)


def test_softmax_rows_and_store_follow_the_accumulator_layout():
    """The row statistics and the store read the layout as ``acc_pos`` does:
    registers 4 j + e hold row g + 8 (e >> 1) (alpha[e >> 1] rescales them,
    a row's max and sum are taken over the four lanes of a quad: lanes that
    differ in bits 0 and 1, the shuffles xor 1 and 2), and the store writes
    registers 4 j + 2 i and 4 j + 2 i + 1 to row g + 8 i, columns 8 j + 2 t
    and + 1."""
    for w, lane in THREADS:
        g, t = lane // 4, lane % 4
        for j in range(16):
            for e in range(4):
                row, col = acc_pos(w, lane, 4 * j + e)
                assert row == 16 * w + g + 8 * (e >> 1)
                assert col - 8 * j in (2 * t, 2 * t + 1)
            for i in range(2):
                assert acc_pos(w, lane, 4 * j + 2 * i) == (16 * w + g + 8 * i, 8 * j + 2 * t)
                assert acc_pos(w, lane, 4 * j + 2 * i + 1) == (16 * w + g + 8 * i,
                                                                8 * j + 2 * t + 1)
        quad = {acc_pos(w, lane ^ x, 0)[0] for x in (0, 1, 2, 3)}
        assert quad == {acc_pos(w, lane, 0)[0]}
    body = re.search(r"void rescale\(.*?\n\}", SRC, re.S).group(0)
    assert re.findall(r"o\[4 \* j \+ (\d)\] \*= alpha\[(\d)\]", body) == [
        ("0", "0"), ("1", "0"), ("2", "1"), ("3", "1")]
    assert "pack_bf16(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv)" in SRC
    assert "orow + 8 * j + 2 * t" in SRC
    for x in (1, 2):
        assert f"__shfl_xor_sync(0xffffffffu, mx[i], {x})" in SRC
        assert f"__shfl_xor_sync(0xffffffffu, l, {x})" in SRC


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
def test_tma_and_shared_memory_plan(head_dim):
    """The source's plan at each head dim: a row is loaded as 64-dim boxes
    of 128 bytes (the 128-byte swizzle's span), ceil(D / 64) of them, so at D
    96 the second box is half zeros (TMA's fill) and S = Q K^T walks D / 16 =
    6 k-steps; a key tile of BK rows (a multiple of 16: whole k16 steps of P
    V and whole 8-row swizzle atoms; at most 256, TMA's box limit and
    wgmma's widest N); Q, the K and V stages and the mbarriers fit a block's
    shared memory (1024 bytes of alignment slack, 8 a barrier); the
    accumulators (O: D / 2, S: BK / 2 float32 a thread)
    and P (BK / 4 registers) fit a consumer's registers after setmaxnreg,
    and producer and consumers fit the SM's."""
    cfg = _cfg(head_dim)
    bk, stages = cfg["BK"], cfg["STAGES"]
    nch = math.ceil(head_dim / 64)
    assert "boxes of 64 dims" in SRC and "CU_TENSOR_MAP_SWIZZLE_128B" in SRC
    assert "const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};" in SRC
    assert 64 * 2 == 128 and nch * 64 >= head_dim and head_dim % 16 == 0
    assert bk % 16 == 0 and bk <= 256 and stages >= 2
    bq = _const("BQ")
    smem = 1024 + nch * bq * 128 + 2 * stages * nch * bk * 128 + 8 * (2 + 4 * stages)
    assert smem <= SMEM_PER_BLOCK, smem
    producer, consumer = _const("PRODUCER_REGS"), _const("CONSUMER_REGS")
    assert producer % 8 == 0 and consumer % 8 == 0 and 24 <= producer < consumer <= 256
    assert 128 * producer + 2 * 128 * consumer <= REGS_PER_SM
    assert head_dim // 2 + bk // 2 + bk // 4 < consumer
    assert f"if (D == {head_dim}) return launch<{head_dim}>(a);" in SRC


def test_route_sends_each_call_to_one_kernel():
    """Every (dtype, head dim) the wrapper takes maps to exactly one kernel
    of ``build.KERNELS``; float32 goes to the mma.sync source at head dims
    64 and 128 and to the float32 Hopper design (``flash_attention_tf32``)
    at 96 and 256, bfloat16 to the bfloat16 Hopper one at every head dim;
    each source refuses the other type and has an instance at every head dim
    the table sends it; the wrapper counts launches of every kernel the
    table names."""
    assert set(fa.ROUTE) == {(dt, d) for dt in fa.DTYPES for d in fa.HEAD_DIMS}
    for (dt, d), name in fa.ROUTE.items():
        assert name in build.KERNELS and fa.route(dt, d) == name
        assert build.KERNELS[name][1] == "flash_attention_launch"
        if dt == torch.float32:
            assert name == ("flash_attention_tf32" if d in fa.TF32_HEAD_DIMS
                            else "flash_attention")
    assert "if (!is_bf16 ||" in SRC
    csrc = Path(fa.__file__).parent / "csrc"
    mma_sync = (csrc / "flash_attention.cu").read_text()
    tf32 = (csrc / "flash_attention_tf32.cu").read_text()
    assert "if (is_bf16 ||" in mma_sync and "if (is_bf16 ||" in tf32
    for d in fa.HEAD_DIMS:
        assert fa.ROUTE[torch.bfloat16, d] == WGMMA
        f32_src = tf32 if d in fa.TF32_HEAD_DIMS else mma_sync
        assert re.search(rf"if \(D == {d}\) return launch<(float, )?{d}>\(a\);", f32_src)
    assert set(fa.flash_attention.by_kernel) == set(fa.ROUTE.values())
    assert build.KERNELS[WGMMA][2] == build.KERNELS["flash_attention"][2]


@pytest.mark.parametrize("dtype", fa.DTYPES)
@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
def test_cpu_tensors_take_the_plain_version(head_dim, dtype):
    """CPU operands at every head dim and type: the plain version's answer,
    no launch counted, on the wrapper or on any kernel."""
    rng = np.random.default_rng(head_dim)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
               for s in ((1, 4, 33, head_dim), (1, 2, 40, head_dim), (1, 2, 40, head_dim)))
    counts = {n: c.launches for n, c in fa.flash_attention.by_kernel.items()}
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True, window=9)
    assert fa.flash_attention.launches == before
    assert {n: c.launches for n, c in fa.flash_attention.by_kernel.items()} == counts
    assert torch.equal(out, ref.attention_ref(q, k, v, causal=True, window=9))


def test_cuda_operands_launch_the_routed_kernel(monkeypatch):
    """With the device answering "CUDA" (``check_operands`` faked as in
    ``test_torch_flash_attention.py``), each call launches the kernel the
    table names and counts one launch on the wrapper and one on that
    kernel; a failed launch counts none."""
    real = fa.check_operands

    class FakeDevice:
        type = "cuda"

    class View:
        def __init__(self, t):
            self.t = t

        def __getattr__(self, name):
            return getattr(self.t, name)

        @property
        def device(self):
            return FakeDevice

    monkeypatch.setattr(fa, "check_operands",
                        lambda q, k, v, w: real(View(q), View(k), View(v), w))
    monkeypatch.setattr(fa, "attention_ref", lambda *a, **k: pytest.fail("plain"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    launched = []
    monkeypatch.setattr(fa, "kernel", lambda name: lambda *a: launched.append(name) or 0)
    counts = {n: c.launches for n, c in fa.flash_attention.by_kernel.items()}
    before = fa.flash_attention.launches
    try:
        for dt in fa.DTYPES:
            for d in fa.HEAD_DIMS:
                q = torch.zeros((1, 2, 8, d), dtype=dt)
                fa.flash_attention(q, q, q)
        assert launched == [fa.ROUTE[dt, d] for dt in fa.DTYPES for d in fa.HEAD_DIMS]
        assert fa.flash_attention.launches == before + len(launched)
        for name, c in fa.flash_attention.by_kernel.items():
            assert c.launches == counts[name] + launched.count(name)
        monkeypatch.setattr(fa, "kernel", lambda name: lambda *a: 1)
        with pytest.raises(RuntimeError, match=f"{WGMMA} launch failed with CUDA error 1"):
            q = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16)
            fa.flash_attention(q, q, q)
        assert fa.flash_attention.by_kernel[WGMMA].launches == counts[WGMMA] + \
            launched.count(WGMMA)
    finally:
        fa.flash_attention.launches = before
        for name, c in fa.flash_attention.by_kernel.items():
            c.launches = counts[name]


# ---------------------------------------------------------------------------
# The kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

LOG2E = np.float32(1.4426950408889634)


def emulate_bf16(q, k, v, causal, window, bk):
    """The Hopper kernel's arithmetic on bfloat16 [B, H, S, D] tensors: key
    tiles of ``bk``; S = Q K^T in float32 (bfloat16 products are exact in
    float32, the tensor cores sum them); the running max in log2 units from
    -1e30, masked scores -inf; P = exp2(s log2(e) / sqrt(D) - m) summed in
    float32 and rounded to bfloat16 once for P V; O rescaled by each tile's
    alpha; the output O / l rounded to bfloat16 once.  Only the tiles of
    some row's visible run matter: a tile a row cannot see leaves its m, l
    and O as they were (alpha 1, P 0)."""
    B, Hq, Sq, D = q.shape
    Skv, group = k.shape[2], q.shape[1] // k.shape[1]
    kx, vx = (t.repeat_interleave(group, dim=1).float() for t in (k, v))
    qf = q.float()
    scale_log2 = np.float32(np.float32(1.0) / np.sqrt(np.float32(D))) * LOG2E
    qpos = torch.arange(Sq)[:, None] + (Skv - Sq)
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    o = torch.zeros((B, Hq, Sq, D))
    for k0 in range(0, Skv, bk):
        kpos = torch.arange(k0, min(k0 + bk, Skv))[None, :]
        ok = torch.ones((Sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= qpos >= kpos
        if window is not None:
            ok &= (qpos - kpos) < window
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kx[:, :, k0:k0 + bk])
        s = torch.where(ok, s, -torch.inf)
        mx = torch.maximum(m, s.amax(dim=-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s * scale_log2 - mx)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                                     vx[:, :, k0:k0 + bk])
        m = mx
    return (o / torch.where(l == 0, 1.0, l)).bfloat16()


# (B, Hq, Hkv, Sq, Skv, D, window): GQA, MQA at head dim 256, a window
# narrower than a tile, decode alignment, head dim 96 over two key tiles
EMU_CASES = [
    (1, 4, 2, 150, 150, 64, None),
    (1, 2, 1, 77, 77, 256, 17),
    (1, 4, 2, 13, 301, 128, None),
    (1, 2, 2, 200, 200, 96, 140),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_emulation_matches_pallas(case, causal):
    """The emulated kernel (the source's key tile at that head dim) against
    the reference's Pallas kernel in interpret mode on the same bfloat16
    operands, and against the plain version: each output row within 1e-2
    of its max (the card's bar for bfloat16)."""
    B, Hq, Hkv, Sq, Skv, D, window = case
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = emulate_bf16(tq, tk, tv, causal, window, _cfg(D)["BK"])
    want = jflash(*(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (tq, tk, tv)),
                  causal=causal, window=window, block_q=32, block_k=32, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.shape == want.shape
    assert ref.rel_err_rows(got, want) <= 1e-2
    assert ref.rel_err_rows(got, ref.attention_ref(tq, tk, tv, causal, window)) <= 1e-2


def _tile_order(n_qt: int, n_bh: int, sec_heads: int) -> list[tuple[int, int]]:
    """The persistent grid's tile numbering, as ``tile_at`` in the source
    computes it: (query tile, head) of tile 0, 1, ..."""
    out = []
    for tile in range(n_qt * n_bh):
        sec = tile // (sec_heads * n_qt)
        i = tile - sec * sec_heads * n_qt
        hs = min(sec_heads, n_bh - sec * sec_heads)
        out.append((n_qt - 1 - i // hs, sec * sec_heads + i % hs))
    return out


@pytest.mark.parametrize("n_qt,n_bh,sec_heads", [(15, 128, 23), (15, 64, 64), (1, 64, 7),
                                                 (3, 5, 2), (15, 256, 35), (2, 9, 4)])
def test_tile_sections_number_every_tile_once(n_qt, n_bh, sec_heads):
    """The persistent grid's numbering (read from the source, mirrored in
    ``_tile_order``) names every (query tile, head) once, keeps each section
    to ``sec_heads`` heads, and runs each section's tiles longest first (the
    query tiles nearest the end of a causal prefill see the most keys)."""
    assert "const int sec = tile / (sec_heads * n_qt), i = tile - sec * sec_heads * n_qt;" in SRC
    assert "const int qt = n_qt - 1 - i / hs, bh = sec * sec_heads + i % hs;" in SRC
    order = _tile_order(n_qt, n_bh, sec_heads)
    assert sorted(order) == [(q, b) for q in range(n_qt) for b in range(n_bh)]
    for start in range(0, len(order), sec_heads * n_qt):
        section = order[start:start + sec_heads * n_qt]
        assert len({b for _, b in section}) <= sec_heads
        qts = [q for q, _ in section]
        assert qts == sorted(qts, reverse=True)


@pytest.mark.parametrize("n_tiles,grid", [(960, 132), (64, 64), (1920, 132), (7, 3), (131, 132)])
def test_rounds_deal_every_tile_once(n_tiles, grid):
    """The persistent grid's rounds (``tile_of`` in the source): block x
    takes tile x of a round, or with ``snake`` tile grid - 1 - x of an odd
    one, until a round has no tile for it; either way every tile goes to one
    block once, and a block's last tile is the one after which ``tile_of``
    has none (its ping-pong hand-over is the one left out)."""
    assert ("const int x = snake && (r & 1) ? static_cast<int>(gridDim.x - 1 - blockIdx.x)"
            in SRC)
    assert "return base + x < n_tiles ? base + x : -1;" in SRC
    assert "const bool last_tile = tile_of(r + 1) < 0;" in SRC

    for snake in (False, True):
        def tile_of(b, r):
            x = grid - 1 - b if snake and r & 1 else b
            return r * grid + x if r * grid + x < n_tiles else -1

        dealt = []
        for b in range(grid):
            r = 0
            while tile_of(b, r) >= 0:
                dealt.append(tile_of(b, r))
                r += 1
            assert all(tile_of(b, r + k) < 0 for k in range(3))
        assert sorted(dealt) == list(range(n_tiles))
