"""The float32 flash kernel for Hopper (``csrc/flash_attention_tf32.cu``:
3xTF32 on ``wgmma`` fed by TMA, at head dims 96 and 256) on the CPU, where
it cannot run: the m64nNk8 TF32 register layouts its products rest on (the
score accumulator taken as the A operand of O += P V with the keys of each
8-key step relabelled, and V^T stored in the matching key order), the V^T
tile's core-matrix layout and its bank-free stores and loads, the shared
memory, TMA and register plan read from the source, the route table, and
the kernel's arithmetic (``kernels/flash_attention/tf32_order.py``: its
split, chains and sum order) held against the reference's Pallas kernel in
interpret mode and against a float64 truth."""
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
from repro_torch.kernels.flash_attention import ref, tf32_order  # noqa: E402

SRC = (Path(fa.__file__).parent / "csrc" / "flash_attention_tf32.cu").read_text()
TF32 = "flash_attention_tf32"
TOL = 2e-5
SMEM_PER_BLOCK = 232_448        # an H100's opt-in shared memory a block
REGS_PER_SM = 65_536
BANKS = 32


def _cfg(head_dim: int) -> dict:
    """The source's ``Cfg<head_dim>``: its constants by name."""
    body = re.search(rf"struct Cfg<{head_dim}> \{{(.*?)\}};", SRC, re.S).group(1)
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


def _const(name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", SRC).group(1))


BQ = _const("BQ")

# ---------------------------------------------------------------------------
# wgmma's m64nNk8 register layouts (PTX ISA: .tf32 inputs, .f32 accumulator)
# for thread `lane` of warp w (0..3) of the warpgroup; g = lane / 4, t = lane % 4
# ---------------------------------------------------------------------------

THREADS = [(w, lane) for w in range(4) for lane in range(32)]
P_FROM_C = (0, 2, 1, 3)          # the A register r of P from score register e


def acc_pos(w: int, lane: int, i: int) -> tuple[int, int]:
    """Accumulator register i: (row, column) of the 64 x N result."""
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * ((i % 4) // 2), 8 * (i // 4) + 2 * t + i % 2


def a_pos(w: int, lane: int, r: int) -> tuple[int, int]:
    """Register r (0..3) of the k8 A operand from registers: (row, column)
    of the 64 x 8 A tile: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * (r & 1), t + 4 * (r >> 1)


def key_of_position(p: int) -> int:
    """The key V^T holds at position p of its 8-key group: 0, 2, 4, 6, 1, 3,
    5, 7 (A column t is key 2t, column t + 4 key 2t + 1)."""
    return 2 * (p % 4) + p // 4


def position_of_key(key: int) -> int:
    """The kernel's split: key 8 kb + 2 pq + kp at position 8 kb + 4 kp + pq."""
    kb, rest = divmod(key, 8)
    return 8 * kb + 4 * (rest % 2) + rest // 2


def test_score_registers_are_the_a_fragment_of_relabelled_keys():
    """Register by register: each thread's A register r of k-step kk (score
    n-tile kk) is its score register P_FROM_C[r], and its (row, column) is
    the score's (row, position of the key); over the warpgroup every (row,
    column) of the 64 x 8 A tile is held once."""
    seen = set()
    for w, lane in THREADS:
        for r in range(4):
            row, col = a_pos(w, lane, r)
            srow, skey = acc_pos(w, lane, P_FROM_C[r])
            assert row == srow and col == position_of_key(skey) % 8
            seen.add((row, col))
    assert seen == {(r, c) for r in range(64) for c in range(8)}


@pytest.mark.parametrize("n", [48, 64])
def test_p_from_score_registers_times_permuted_vt_is_p_v(n):
    """One 16-key tile of O += P V done register by register as the kernel
    does it: P (64 x 16) laid out as the accumulator, turned into A by {c0,
    c2, c1, c3}, B = V^T read at the permuted key positions, k-step by
    k-step: the product is P @ V; the unpermuted registers with V^T in key
    order are not."""
    rng = np.random.default_rng(3)
    P = rng.standard_normal((64, 16))
    V = rng.standard_normal((16, n))
    vt = np.zeros((n, 16))                  # V^T as the split stores it
    for key in range(16):
        vt[:, position_of_key(key)] = V[key]

    def product(order, vt):
        out = np.zeros((64, n))
        for kk in range(2):
            A = np.zeros((64, 8))
            for w, lane in THREADS:
                for r in range(4):
                    row, col = a_pos(w, lane, r)
                    srow, skey = acc_pos(w, lane, order[r])
                    A[row, col] = P[srow, 8 * kk + skey]
            out += A @ vt[:, 8 * kk:8 * kk + 8].T
        return out

    np.testing.assert_allclose(product(P_FROM_C, vt), P @ V, rtol=1e-13, atol=1e-13)
    assert not np.allclose(product((0, 1, 2, 3), V.T.copy()), P @ V)


@pytest.mark.parametrize("head_dim", [96, 256])
def test_vt_tile_covers_each_key_once_in_core_matrices(head_dim):
    """V^T's plane at each head dim: the split's positions cover each key of
    a tile once (0, 2, 4, 6, 1, 3, 5, 7 in every 8-key group); every (dim,
    key) has its own address inside the plane; and the address the split
    writes is the one wgmma's K-major descriptor without swizzle reads for
    that (dim, k) of k-step kk (start 256 kk bytes on, LBO 128, SBO BK * 32)."""
    bk = _cfg(head_dim)["BK"]
    kp_bytes = head_dim * bk * 4
    assert sorted(position_of_key(k) for k in range(bk)) == list(range(bk))
    assert all(key_of_position(position_of_key(k) % 8) == k % 8 for k in range(bk))
    assert "(n >> 3) * (BK * 32) + (p >> 2) * 128 + (n & 7) * 16 + (p & 3) * 4" in SRC
    assert "smem_desc(v_hi + off + kk * 256, 128, BK * 32, 0)" in SRC

    def vt_addr(n, p):
        return (n >> 3) * (bk * 32) + (p >> 2) * 128 + (n & 7) * 16 + (p & 3) * 4

    addrs = {vt_addr(n, position_of_key(k)) for n in range(head_dim) for k in range(bk)}
    assert len(addrs) == head_dim * bk and max(addrs) < kp_bytes
    for kk in range(bk // 8):
        for n in range(head_dim):
            for k in range(8):
                desc = 256 * kk + (n // 8) * (bk * 32) + (k // 4) * 128 + (n % 8) * 16 + (k % 4) * 4
                assert desc == vt_addr(n, 8 * kk + k)


def _swz(rows: int, r: int, d: int) -> int:
    """The source's swz(): (row, dim) of a TMA-landed tile with the 128-byte
    swizzle, in bytes from its start."""
    return (d >> 5) * rows * 128 + r * 128 + ((((d & 31) >> 2) ^ (r & 7)) << 4) + (d & 3) * 4


@pytest.mark.parametrize("head_dim", [96, 256])
def test_split_v_warp_steps_hit_every_bank_once(head_dim):
    """Each warp step of the V split (one dim group, one key pair of every
    8-key group): its 32 loads from the swizzled landing and its 32 stores
    into V^T each fall in 32 distinct banks; over a consumer's four warps
    the steps cover its dims x the tile's keys once."""
    bk = _cfg(head_dim)["BK"]
    dh = head_dim // 2
    assert ("const int n = 8 * nb + nq, key = 8 * kb + 2 * pq + kp, "
            "p = 8 * kb + 4 * kp + pq;") in SRC
    steps = (dh // 8) * (bk // 8) * 2 // 4
    for cw in range(2):
        covered = set()
        for warp in range(4):
            for i in range(steps):
                gi = warp + 4 * i
                nb = cw * (dh // 8) + gi // (bk // 4)
                kb, kp = (gi % (bk // 4)) >> 1, gi & 1
                loads, stores = set(), set()
                for lane in range(32):
                    nq, pq = lane >> 2, lane & 3
                    n, key = 8 * nb + nq, 8 * kb + 2 * pq + kp
                    p = 8 * kb + 4 * kp + pq
                    assert p == position_of_key(key)
                    loads.add(_swz(bk, key, n) // 4 % BANKS)
                    stores.add(((n >> 3) * (bk * 32) + (p >> 2) * 128 + (n & 7) * 16
                                + (p & 3) * 4) // 4 % BANKS)
                    covered.add((n, key))
                assert len(loads) == BANKS and len(stores) == BANKS
        assert covered == {(n, k) for n in range(cw * dh, (cw + 1) * dh) for k in range(bk)}


@pytest.mark.parametrize("head_dim", [96, 256])
def test_tma_shared_memory_and_register_plan(head_dim):
    """The source's plan at each head dim: rows land as 32-dim boxes of 128
    bytes (the 128-byte swizzle's span), D / 32 of them; a key tile of BK
    rows (whole k8 steps, whole 8-row atoms); each consumer's half of the
    head dim in CHAINS chains of whole k-steps and PV_PARTS output parts of
    a wgmma width; Q, the K stages (hi and lo planes), the V landings, the
    V^T stage, the score exchange and the mbarriers fit a block's shared
    memory (1,024 bytes of alignment slack); a consumer's registers (Q_hi,
    O, one P V part, the score chains, P's hi and lo fragments) fit what
    setmaxnreg gives it, and producer and consumers fit the SM's."""
    c = _cfg(head_dim)
    bk, chains, parts = c["BK"], c["CHAINS"], c["PV_PARTS"]
    ks, vls = c["K_STAGES"], c["VL_STAGES"]
    assert "const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};" in SRC
    assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in SRC and "CU_TENSOR_MAP_SWIZZLE_128B" in SRC
    assert head_dim % 32 == 0 and bk % 8 == 0 and bk <= 256 and BQ == 64
    dh = head_dim // 2
    assert dh % chains == 0 and (dh // chains) % 8 == 0
    np_ = dh // parts
    assert np_ % 8 == 0 and np_ <= 256 and bk in (16, 32)       # the SS / RS widths written
    kp = head_dim * bk * 4
    smem = (1024 + head_dim * BQ * 4 + 2 * ks * kp + vls * kp + 2 * kp
            + 2 * 2 * BQ * bk * 4 + 8 * (2 + 2 * ks + 2 * vls))
    assert "VLS * KP +\n                              2 * KP + XB + 8 * NBARS" in SRC
    assert "NBARS = 2 + 2 * KS + 2 * VLS" in SRC
    assert smem <= SMEM_PER_BLOCK, smem
    producer, consumer = _const("PRODUCER_REGS"), _const("CONSUMER_REGS")
    assert producer % 8 == 0 and consumer % 8 == 0 and 24 <= producer < consumer <= 256
    assert 128 * producer + 2 * 128 * consumer <= REGS_PER_SM
    regs = dh // 2 + dh // 2 + np_ // 2 + chains * bk // 2 + 2 * bk // 2
    assert regs < consumer, regs
    assert f"if (D == {head_dim}) return launch<{head_dim}>(a);" in SRC


def test_route_sends_float32_96_and_256_to_the_hopper_design():
    """float32 at head dims 96 and 256 goes to ``flash_attention_tf32``, at
    64 and 128 to the mma.sync source, bfloat16 everywhere to the bfloat16
    Hopper design; the new source is in ``build.KERNELS`` with the shared C
    signature, refuses bfloat16 and every other head dim, and the wrapper
    counts its launches."""
    for d in fa.HEAD_DIMS:
        want = TF32 if d in (96, 256) else "flash_attention"
        assert fa.route(torch.float32, d) == want
        assert fa.route(torch.bfloat16, d) == "flash_attention_wgmma"
    assert fa.TF32_HEAD_DIMS == (96, 256)
    assert build.KERNELS[TF32][1] == "flash_attention_launch"
    assert build.KERNELS[TF32][2] == build.KERNELS["flash_attention"][2]
    assert "if (is_bf16 ||" in SRC
    assert re.findall(r"if \(D == (\d+)\) return launch<\d+>\(a\);", SRC) == ["96", "256"]
    assert TF32 in fa.flash_attention.by_kernel


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Skv, D, window): MHA, GQA, MQA, ragged S, windows, Sq < Skv
CASES = [
    (1, 2, 2, 77, 77, 96, None),
    (1, 4, 2, 40, 130, 96, 33),
    (1, 4, 1, 64, 64, 256, None),
    (1, 2, 1, 33, 100, 256, 17),
]


def _inputs(case, seed):
    B, Hq, Hkv, Sq, Skv, D, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]


def _emulate(q, k, v, causal, window, **kw):
    c = _cfg(q.shape[-1])
    return tf32_order.emulate(q, k, v, causal, window, bk=c["BK"], chains=c["CHAINS"], **kw)


def _ids(case):
    B, Hq, Hkv, Sq, Skv, D, w = case
    return f"B{B}-H{Hq}/{Hkv}-S{Sq}/{Skv}-D{D}-w{w}"


def test_rna_split_and_round_toward_zero():
    """The emulation's pieces: hi and lo are TF32 values (13 low bits zero)
    that rebuild x to 2^-22 of |x|; a float64 sum rounded toward zero lands
    on the float32 at or below it in magnitude, one ulp from the nearest at
    most."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(50_000)
                          * 10.0 ** rng.uniform(-20, 20, 50_000)).astype(np.float32))
    hi, lo = tf32_order.split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()
    y = torch.from_numpy(rng.standard_normal(50_000)) * 1e3
    z = tf32_order.round_toward_zero(y)
    assert (z.double().abs() <= y.abs()).all()
    assert ((y - z.double()).abs() <= (y.float().double() - y).abs()
            + torch.finfo(torch.float32).eps * y.abs()).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tf32_wgmma_emulation_matches_pallas(case, causal):
    """The Hopper design's arithmetic (its key tiles and chains as the
    source sets them) against the reference's Pallas kernel in interpret
    mode (32-row blocks), each row within 2e-5 of its max."""
    window = case[-1]
    q, k, v = _inputs(case, 7)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  window=window, block_q=32, block_k=32, interpret=True)
    got = _emulate(q, k, v, causal, window)
    err = ref.rel_err_rows(got, torch.from_numpy(np.array(want)))
    assert err <= TOL, err


@pytest.mark.parametrize("case", CASES[::2], ids=_ids)
def test_one_tf32_pass_fails_the_bar(case):
    """The same emulation with one TF32 product (hi x hi) is further than
    2e-5 from the plain version: the bar tells 3xTF32 from plain TF32."""
    q, k, v = _inputs(case, 7)
    want = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    assert ref.rel_err_rows(_emulate(q, k, v, True, None, passes=1), want) > TOL
    assert ref.rel_err_rows(_emulate(q, k, v, True, None), want) <= TOL


@pytest.mark.parametrize("D,heads", [(96, (4, 4)), (256, (4, 1))])
@pytest.mark.parametrize("kind", ["peaked", "offset"])
def test_tf32_wgmma_emulation_holds_large_scores(kind, D, heads):
    """With q x 8 (one key dominates a row) or k + 50 (scores in the
    hundreds): the design's arithmetic, with the tensor cores' sums rounded
    toward zero, is within 2e-5 of the float64 truth on every row and no
    further from it than the float32 plain version (itself further than
    2e-5 in the offset case)."""
    q, k, v = _inputs((1, *heads, 160, 160, D, None), 8)
    if kind == "peaked":
        q = q * np.float32(8)
    else:
        k = k + np.float32(50)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    truth = ref.attention_f64(tq, tk, tv)
    plain = ref.rel_err_rows(ref.attention_ref(tq, tk, tv), truth)
    got = ref.rel_err_rows(_emulate(q, k, v, True, None), truth)
    assert got <= TOL and got <= plain, (got, plain)
    if kind == "offset":
        assert plain > TOL
