"""The CUDA kernels on the card (marker ``cuda``; skipped where there is no
card): each kernel against its plain version over ragged shapes — the ELL
SpMV and SpMM at every row length and fill the AMG path has (the SpMM at
1-33 right-hand sides), padding packed at the row's end and scattered, row
counts that fill no whole block, ranks shorter than a block, operands that
are not 16-byte aligned, rows of up to 20,001 slots and of 2^24 + 1; BCSR
sources that are not a multiple of the block size and results cut to the
true rows, one launch per BCSR apply (counted from a captured graph's
nodes); the three sparse kernels' bfloat16 instances at the same edges
(K = 1, all-padding rows, m not a multiple of bs, k = 1-33, unaligned
operands, rows over several rounds) and at a bfloat16 lowering's own
operands, each entry within 2^-7 |plain| + 2^-16 Σ|a·x| of the plain
version; the bf16 ELL kernels' bulk design (``csrc/ell_bf16.cuh``) bit for
bit against the emulation of its order of sums (``bf16_order.emulate``) at
its edges (units crossing ranks, unaligned operands, ragged slot counts,
rows longer than a stage, more units than resident blocks), repeatable,
and first launched under CUDA-graph capture in a fresh process; the block
smoothers' block-diagonal apply (block sizes 1-8, rows
that fill no whole block, 1-33 right-hand sides) and sync-free triangular
solve on each route (block, L2: both triangles, rows longer than a warp,
a chain as deep as the rows, bit-equal run to run, in another valid order
and across routes, a forced block refused past its shared memory; a
level-0-sized rank; the route rule's edges; a 20,000-row chain; a NaN in r;
no row order refused; one kernel node in a graph on the block route, a
memset node and a kernel node on the L2 route, each replaying correctly
with new values); both smoothers' bfloat16 instances at the same edges
(each route, bit-equal across routes and orders, a level-0-sized rank;
the bfloat16 bar above with Σ|a·x| the magnitudes an entry adds up) and the
block-smoother PCG on the card against the CPU; degenerate shapes; flash attention
(each output row's error over its own max) over ragged lengths, windows,
decode alignment, head dims 64, 96 (phi-3-vision-4.2b's 32:32), 128 and
256 (recurrentgemma-9b's 16:1 MQA), float32 and bfloat16, the served prefill shapes, strided time-major views, bfloat16 strides the kernel cannot copy
and a failed launch, each through the kernel the route table names
(bfloat16: the Hopper design, counted per kernel); bfloat16 edges on the
Hopper kernel's key tiles and ring stages, its time-major views at head
dims 96 and 256, and its build (no spills; HGMMA and UTMALDG in its SASS);
float32 with large scores (q x 8, k + 50) against a
float64 truth, and no register spills in the float32 instances — a small
distributed PCG on the
card against the same solve on the CPU, and small LMs on the card against
the CPU (qwen3; recurrentgemma and xlstm, their recurrent states carried on
the card; two train steps of qwen3 and phi-3-vision with remat through
``chunked_attention``); the ERT micro-kernels (``ert_stream`` over
ragged lengths and 1-64 FMAs an element, ``ert_gather``) against their
plain versions in float32 and float64, and a smoke ``ert_sweep``.

Run on a machine with an NVIDIA card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_f64, attention_ref, rel_err_rows)
from repro_torch.kernels.smoother import bf16_order as sorder  # noqa: E402
from repro_torch.kernels.smoother import ref as sref  # noqa: E402
from repro_torch.kernels.smoother import smoother as sm  # noqa: E402
from repro_torch.kernels.spmv import bcsr, ref, spmv  # noqa: E402

pytestmark = pytest.mark.cuda
D = 3
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.device == want.device
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= RTOL[want.dtype] * scale


def _ell(rng, n, m, K, dtype, dev):
    cols = rng.integers(0, m, size=(D, n, K)).astype(np.int32)
    cols[rng.random((D, n, K)) < 0.3] = -1
    vals = rng.standard_normal((D, n, K))
    return (torch.as_tensor(cols, device=dev),
            torch.as_tensor(vals, dtype=dtype, device=dev))


def _ell_path(rng, n, m, K, fill, packed, dtype, dev):
    """ELL operands at a given fill; ``packed`` puts the padding at each
    row's end as the lowering does, else it is scattered.  Padded slots
    hold NaN values: a kernel that counted one would show it."""
    cols = rng.integers(0, m, size=(D, n, K)).astype(np.int32)
    keep = rng.random((D, n, K)) < fill
    if packed:
        keep = np.sort(keep, axis=2)[..., ::-1]
    cols[~keep] = -1
    vals = rng.standard_normal((D, n, K))
    vals[~keep] = np.nan
    return (torch.as_tensor(cols, device=dev),
            torch.as_tensor(vals, dtype=dtype, device=dev))


# the row lengths of the AMG path's ELL operands (laplace_3d(64) on 2x4
# ranks: level 0 A_on 27, A_off 9, P_on 8, P_off 4, R_on 27, R_off 18;
# levels 1-2 up to 36 and 33; the small levels up to 66)
PATH_K = [1, 2, 4, 8, 9, 18, 27, 33, 36, 46, 66]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fill", [0.04, 0.25, 0.9, 0.97])
@pytest.mark.parametrize("K", PATH_K)
def test_ell_spmv_path_widths_and_fills(dev, K, fill, packed, dtype):
    """Every row length and fill the path has; ranks of 37 rows (shorter
    than a block's run of rows, so blocks span ranks) and of 1000 + K rows
    (no whole number of blocks)."""
    rng = np.random.default_rng(K)
    m = 777
    for n in (37, 1000 + K):
        cols, vals = _ell_path(rng, n, m, K, fill, packed, dtype, dev)
        x = torch.as_tensor(rng.standard_normal((D, m)), dtype=dtype, device=dev)
        before = spmv.ell_spmv.launches
        got = spmv.ell_spmv(cols, vals, x)
        assert spmv.ell_spmv.launches == before + 1
        _close(got, ref.ell_spmv_ref(cols, vals, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_spmv_unaligned_operands(dev, dtype):
    """Contiguous operands that start one element into their storage (not
    16-byte aligned) take the kernel's scalar loads, also where rows run
    over several of a block's rounds of slots (K = 3000)."""
    rng = np.random.default_rng(5)
    for n, K in ((1001, 27), (9, 3000)):
        cols0, vals0 = _ell_path(rng, n, 50, K, 0.9, True, dtype, dev)
        cbuf = torch.empty(cols0.numel() + 1, dtype=cols0.dtype, device=dev)
        vbuf = torch.empty(vals0.numel() + 1, dtype=vals0.dtype, device=dev)
        cbuf[1:] = cols0.reshape(-1)
        vbuf[1:] = vals0.reshape(-1)
        cols, vals = cbuf[1:].view(D, n, K), vbuf[1:].view(D, n, K)
        assert cols.is_contiguous() and cols.data_ptr() % 16 != 0
        x = torch.as_tensor(rng.standard_normal((D, 50)), dtype=dtype, device=dev)
        _close(spmv.ell_spmv(cols, vals, x), ref.ell_spmv_ref(cols0, vals0, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [129, 513, 2049, 20000, 20001])
def test_ell_spmv_long_rows(dev, K, dtype):
    """Rows longer than a quarter of the kernel's round of slots (K > 128 in
    float64, 512 in float32) take several rounds, a row's partial sum
    carried from one to the next; K = 20,000 is past what shared memory
    could hold of whole rows.  Ranks of 9 rows: blocks span ranks."""
    rng = np.random.default_rng(K)
    m = 5000
    for fill, packed in ((0.9, True), (0.04, False)):
        cols, vals = _ell_path(rng, 9, m, K, fill, packed, dtype, dev)
        x = torch.as_tensor(rng.standard_normal((D, m)), dtype=dtype, device=dev)
        before = spmv.ell_spmv.launches
        got = spmv.ell_spmv(cols, vals, x)
        assert spmv.ell_spmv.launches == before + 1
        _close(got, ref.ell_spmv_ref(cols, vals, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,k", [(1, 1), (7, 3), (27, 8), (40, 16)])
def test_ell_spmm(dev, K, k, dtype):
    rng = np.random.default_rng(K * k)
    n, m = 513, 300
    cols, vals = _ell(rng, n, m, K, dtype, dev)
    X = torch.as_tensor(rng.standard_normal((D, m, k)), dtype=dtype, device=dev)
    _close(spmv.ell_spmm(cols, vals, X), ref.ell_spmm_ref(cols, vals, X))


# RHS counts: 1 and odd ones take scalar X rows, 2 and 5 are not a multiple
# of float32's 4-wide vectors, 33 spans two of the kernel's 32-column tiles
SPMM_K = [1, 2, 3, 5, 8, 16, 33]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", SPMM_K)
@pytest.mark.parametrize("fill", [0.04, 0.25, 0.9, 0.97])
@pytest.mark.parametrize("K", PATH_K)
def test_ell_spmm_path_widths_and_fills(dev, K, fill, k, dtype):
    """Every row length and fill the path has, at RHS counts 1-33, padding
    packed at the row's end and scattered (padded slots hold NaN); ranks of
    37 rows (blocks span ranks) and of 1000 + K rows."""
    rng = np.random.default_rng(K * 100 + k)
    m = 777
    for n, packed in ((37, True), (1000 + K, False)):
        cols, vals = _ell_path(rng, n, m, K, fill, packed, dtype, dev)
        X = torch.as_tensor(rng.standard_normal((D, m, k)), dtype=dtype, device=dev)
        before = spmv.ell_spmm.launches
        got = spmv.ell_spmm(cols, vals, X)
        assert spmv.ell_spmm.launches == before + 1
        _close(got, ref.ell_spmm_ref(cols, vals, X))


def _offset(t):
    """A contiguous copy of ``t`` that starts one element into its storage
    (not 16-byte aligned)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    out = buf[1:].view(t.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["A", "X", "both"])
def test_ell_spmm_unaligned_operands(dev, which, dtype):
    """Column ids and values, or X (and so Y's vector width), or all of them
    not 16-byte aligned: the kernel's scalar loads, also where rows run over
    several of a block's rounds (K = 3000)."""
    rng = np.random.default_rng(6)
    for n, K, k in ((1001, 27, 8), (9, 3000, 4)):
        cols0, vals0 = _ell_path(rng, n, 50, K, 0.9, True, dtype, dev)
        X0 = torch.as_tensor(rng.standard_normal((D, 50, k)), dtype=dtype, device=dev)
        cols, vals = (_offset(cols0), _offset(vals0)) if which != "X" else (cols0, vals0)
        X = _offset(X0) if which != "A" else X0
        _close(spmv.ell_spmm(cols, vals, X), ref.ell_spmm_ref(cols0, vals0, X0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("K", [129, 513, 2049, 20000, 20001])
def test_ell_spmm_long_rows(dev, K, k, dtype):
    """Rows longer than a block's round of slots take several rounds, a
    row's partial sums carried from one to the next; ranks of 9 rows."""
    rng = np.random.default_rng(K + k)
    m = 5000
    for fill, packed in ((0.9, True), (0.04, False)):
        cols, vals = _ell_path(rng, 9, m, K, fill, packed, dtype, dev)
        X = torch.as_tensor(rng.standard_normal((D, m, k)), dtype=dtype, device=dev)
        before = spmv.ell_spmm.launches
        got = spmv.ell_spmm(cols, vals, X)
        assert spmv.ell_spmm.launches == before + 1
        _close(got, ref.ell_spmm_ref(cols, vals, X))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n", [1, 2])
def test_ell_spmm_rows_past_2_31_block_slots(dev, n, k, dtype):
    """K = 2^24 + 1: a block's rows (40 at k = 3, 128 at k = 1) hold more
    than 2^31 slots, so its slot counts need 64 bits; one rank of 1 or 2
    rows, padding at the rows' ends.  Values and X are small integers, so
    every partial sum is exact in float32 as well and any error is the
    kernel's indexing, not its summation order over 2^24 slots."""
    rng = np.random.default_rng(n * 10 + k)
    K, m = 2**24 + 1, 5000
    cols = torch.as_tensor(rng.integers(0, m, size=(1, n, K), dtype=np.int32), device=dev)
    cols[:, :, K - 1000:] = -1
    vals = torch.as_tensor(rng.integers(-2, 3, size=(1, n, K)), dtype=dtype, device=dev)
    X = torch.as_tensor(rng.integers(-2, 3, size=(1, m, k)), dtype=dtype, device=dev)
    before = spmv.ell_spmm.launches
    got = spmv.ell_spmm(cols, vals, X)
    assert spmv.ell_spmm.launches == before + 1
    _close(got, ref.ell_spmm_ref(cols, vals, X))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", bcsr.BLOCK_SIZES)
@pytest.mark.parametrize("k", [None, 1, 5, 8, 40])
@pytest.mark.parametrize("shape", ["wide", "level3", "level4"])
@pytest.mark.parametrize("cut", [None, 7])
def test_bcsr(dev, bs, k, shape, cut, dtype):
    """Sources that are not a multiple of bs (read unpadded), results cut
    to ``rows`` = mb·bs − 7 or whole; the AMG path's level-3 and level-4
    shapes (57 and 13 rows a rank) and a wide one (Kb 40 over 37 block
    rows); k = 40 spans several column tiles."""
    rng = np.random.default_rng(bs + (k or 0))
    mb, Kb, m = {"wide": (37, 40, 29 * bs - 5), "level3": (-(-57 // bs), 8, 57),
                 "level4": (-(-13 // bs), 2, 13)}[shape]
    rows = None if cut is None else max(mb * bs - cut, m)
    nb = -(-m // bs)
    bcols = rng.integers(0, nb, size=(D, mb, Kb)).astype(np.int32)
    bcols[rng.random((D, mb, Kb)) < 0.25] = -1
    bcols = torch.as_tensor(bcols, device=dev)
    bvals = torch.as_tensor(rng.standard_normal((D, mb, Kb, bs, bs)),
                            dtype=dtype, device=dev)
    x = torch.as_tensor(rng.standard_normal((D, m) + (() if k is None else (k,))),
                        dtype=dtype, device=dev)
    fn = bcsr.bcsr_spmv if k is None else bcsr.bcsr_spmm
    before = bcsr.bcsr_spmm.launches
    got = fn(bcols, bvals, x, rows=rows)
    assert bcsr.bcsr_spmm.launches == before + 1
    want = ref.bcsr_apply_ref(bcols, bvals, x, rows)
    assert want.shape[1] == (mb * bs if rows is None else rows)
    _close(got, want)


# bfloat16: the kernels and their plain versions both widen to float32,
# sum in float32 and round once, in another order, so a row may differ by
# one bfloat16 ulp where the float32 sums fall on either side of a tie:
# |kernel - plain| <= 2^-7 |plain| + 2^-16 sum_k |a_ik x_k| a row.
BF16 = torch.bfloat16


def _close_bf16(got, want, absum):
    """The bfloat16 bar above; ``absum`` is Σ|a·x| of each output entry
    (float64, from the plain version on |A| and |x|)."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    assert got.device == want.device
    err = (got.double() - want.double()).abs()
    bar = 2.0**-7 * want.double().abs() + 2.0**-16 * absum
    assert bool(torch.isfinite(got).all())
    assert bool((err <= bar).all()), float((err - bar).max())


def _absum(fn, idx, vals, x, *args):
    """Σ|a·x| of each entry of ``fn``'s result, in float64."""
    return fn(idx, vals.double().abs().nan_to_num(), x.double().abs(), *args)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fill", [0.04, 0.25, 0.9, 1.0])
@pytest.mark.parametrize("K", PATH_K)
def test_ell_spmv_bf16(dev, K, fill, packed):
    """bfloat16 at every row length the path has (K = 1 among them), fills
    up to whole rows, padding packed and scattered (its values NaN), ranks
    of 37 rows (blocks span ranks) and of 1000 + K, and a rank whose rows
    are all padding."""
    rng = np.random.default_rng(K + 7)
    m = 777
    for n in (37, 1000 + K):
        cols, vals = _ell_path(rng, n, m, K, fill, packed, BF16, dev)
        cols[1, : n // 2] = -1                   # rows of padding only
        x = torch.as_tensor(rng.standard_normal((D, m)), dtype=BF16, device=dev)
        before = spmv.ell_spmv.launches
        got = spmv.ell_spmv(cols, vals, x)
        assert spmv.ell_spmv.launches == before + 1
        assert not got[1, : n // 2].any()
        _close_bf16(got, ref.ell_spmv_ref(cols, vals, x),
                    _absum(ref.ell_spmv_ref, cols, vals, x))


def test_ell_spmv_bf16_unaligned_and_long_rows(dev):
    """bfloat16 operands that start one element into their storage (the
    kernel's scalar loads), and rows that run over several rounds."""
    rng = np.random.default_rng(8)
    for n, K, m in ((1001, 27, 50), (9, 3000, 50), (9, 20001, 5000)):
        cols0, vals0 = _ell_path(rng, n, m, K, 0.9, True, BF16, dev)
        x = torch.as_tensor(rng.standard_normal((D, m)), dtype=BF16, device=dev)
        want = ref.ell_spmv_ref(cols0, vals0, x)
        absum = _absum(ref.ell_spmv_ref, cols0, vals0, x)
        _close_bf16(spmv.ell_spmv(_offset(cols0), _offset(vals0), x), want, absum)
        _close_bf16(spmv.ell_spmv(cols0, vals0, x), want, absum)


@pytest.mark.parametrize("k", SPMM_K)
@pytest.mark.parametrize("fill", [0.04, 0.9, 1.0])
@pytest.mark.parametrize("K", [1, 8, 27, 66])
def test_ell_spmm_bf16(dev, K, fill, k):
    """bfloat16 SpMM at 1-33 right-hand sides (8 and 16 take 16-byte X
    rows, the rest scalar ones), the path's A_on / P_on / coarse row
    lengths, ranks of 37 and 1000 + K rows, all-padding rows."""
    rng = np.random.default_rng(K * 100 + k + 1)
    m = 777
    for n, packed in ((37, True), (1000 + K, False)):
        cols, vals = _ell_path(rng, n, m, K, fill, packed, BF16, dev)
        cols[2, : n // 3] = -1
        X = torch.as_tensor(rng.standard_normal((D, m, k)), dtype=BF16, device=dev)
        before = spmv.ell_spmm.launches
        got = spmv.ell_spmm(cols, vals, X)
        assert spmv.ell_spmm.launches == before + 1
        _close_bf16(got, ref.ell_spmm_ref(cols, vals, X),
                    _absum(ref.ell_spmm_ref, cols, vals, X))


@pytest.mark.parametrize("which", ["A", "X"])
def test_ell_spmm_bf16_unaligned_and_long_rows(dev, which):
    rng = np.random.default_rng(9)
    for n, K, k in ((1001, 27, 8), (9, 3000, 8), (9, 2049, 3)):
        cols0, vals0 = _ell_path(rng, n, 50, K, 0.9, True, BF16, dev)
        X0 = torch.as_tensor(rng.standard_normal((D, 50, k)), dtype=BF16, device=dev)
        cols, vals = (_offset(cols0), _offset(vals0)) if which == "A" else (cols0, vals0)
        X = _offset(X0) if which == "X" else X0
        _close_bf16(spmv.ell_spmm(cols, vals, X), ref.ell_spmm_ref(cols0, vals0, X0),
                    _absum(ref.ell_spmm_ref, cols0, vals0, X0))


# the bfloat16 ELL kernels' bulk design (csrc/ell_bf16.cuh: persistent
# blocks walking units of rows, A by bulk copies into shared memory, a row's
# lanes summing in registers), on the shapes each launch's rule gives it
# (kernels/spmv/bf16_order.py:bulk): each case bit for bit against the
# emulation of its order of sums and within the bar of the plain version;
# a case the rule keeps on the kernel's other design within the bar.
# (D, n, K, k, fill, A offset, X offset); ell_spmv takes the bulk design
# from 2^22 slots, so its cases are large: more units than resident blocks
# (3,072 and 2,048 units of 128 rows: at least 3 a block), units crossing
# ranks (37 rows a rank), A offset by 1-7 elements (the bulk copies' 16-byte
# split: the kernel loads A itself), a slot count that is no multiple of 8,
# K = 1, rows longer than a stage (3000, 20001), D = 1, fill 0.04; then
# ell_spmm (k = 1 runs ell_spmv's kernel instance) at the same edges, X
# offset (narrower lanes), k = 3 / 5 / 16 / 33, operands of few units
# (several lanes a row), and shapes it keeps on its other design.
BF16_DESIGN_CASES = (
    [(8, 49152, 27, None, 0.9, 0, 0), (3, 51782, 27, None, 0.9, 0, 0),
     (4300, 37, 27, None, 0.9, 0, 0), (1, 155346, 27, None, 0.04, 0, 0),
     (1, 4194304, 1, None, 1.0, 0, 0), (1, 1400, 3000, None, 0.9, 0, 0),
     (1, 210, 20001, None, 0.9, 0, 0), (3, 37, 27, None, 0.9, 0, 0)]
    + [(8, 32768, 27, None, 0.9, off, 0) for off in (1, 3, 4, 7)]
    + [(8, 32768, 27, 8, 0.9, 0, 0), (8, 4096, 8, 8, 0.9, 0, 0),
       (8, 4096, 8, 1, 0.9, 0, 0), (3, 37, 27, 8, 0.9, 0, 0),
       (3, 37, 27, 1, 0.9, 0, 0), (1, 5000, 27, 8, 0.9, 0, 0),
       (3, 37, 1, 1, 1.0, 0, 0), (3, 1001, 1, 8, 0.9, 0, 0),
       (3, 9, 3000, 8, 0.9, 0, 0), (3, 9, 3000, 1, 0.9, 0, 0),
       (1, 5, 20001, 3, 0.04, 0, 0), (3, 37, 18, 8, 0.9, 0, 0),
       (3, 37, 36, 1, 0.25, 0, 0), (3, 37, 66, 16, 0.9, 0, 0),
       (3, 1001, 9, 5, 0.9, 0, 0), (3, 37, 27, 33, 0.9, 0, 0),
       (3, 1001, 27, 8, 0.9, 0, 4), (3, 1001, 27, 8, 0.9, 0, 1),
       (8, 2689, 27, 8, 0.9, 0, 0), (8, 375, 33, 8, 0.6, 0, 0),
       (8, 32768, 9, 8, 0.2, 0, 0), (8, 32768, 4, 1, 0.04, 0, 0)]
    + [(3, 1001, 27, k, 0.9, off, 0) for off in range(1, 8) for k in (1, 8)])


def _offset_by(t, off):
    """A contiguous copy of ``t`` that starts ``off`` elements into its
    storage."""
    if off == 0:
        return t
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    buf[off:] = t.reshape(-1)
    return buf[off:].view(t.shape)


@pytest.mark.parametrize("case", BF16_DESIGN_CASES, ids=str)
def test_ell_bf16_design_matches_its_order(dev, case):
    """Each case: on the bulk design the kernel bit for bit equal to the
    emulation of its order of sums; within the bar of the plain version,
    NaN in padded values never multiplied, and a second launch bit-equal to
    the first."""
    from repro_torch.kernels.spmv import bf16_order

    D_, n, K, k, fill, off_a, off_x = case
    rng = np.random.default_rng(n + K + (k or 0) + 10 * off_a + off_x)
    m = 777 if K < 3000 else 5000
    cols = rng.integers(0, m, size=(D_, n, K)).astype(np.int32)
    keep = np.sort(rng.random((D_, n, K)) < fill, axis=2)[..., ::-1]
    cols[~keep] = -1
    vals = rng.standard_normal((D_, n, K))
    vals[~keep] = np.nan
    cols = torch.as_tensor(cols, device=dev)
    vals = torch.as_tensor(vals, dtype=BF16, device=dev)
    x = torch.as_tensor(rng.standard_normal((D_, m) + (() if k is None else (k,))),
                        dtype=BF16, device=dev)
    c, v, xx = _offset_by(cols, off_a), _offset_by(vals, off_a), _offset_by(x, off_x)
    fn, plain = ((spmv.ell_spmv, ref.ell_spmv_ref) if k is None
                 else (spmv.ell_spmm, ref.ell_spmm_ref))
    before = fn.launches
    got = fn(c, v, xx)
    again = fn(c, v, xx)
    assert fn.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if bf16_order.bulk("ell_spmv" if k is None else "ell_spmm", D_ * n, K):
        W = bf16_order.lane_width(k or 1, xx.data_ptr(), got.data_ptr())
        want = bf16_order.emulate(cols.cpu(), vals.cpu(), x.cpu(), W=W)
        assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16)), \
            int((got.cpu() != want).sum())
    _close_bf16(got, plain(cols, vals, x), _absum(plain, cols, vals, x))


GRAPH_FIRST_USE = """
import sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels.spmv import spmv
g = torch.Generator().manual_seed(0)
# 4,320,000 slots: both kernels on the bulk design
cols = torch.randint(-1, 300, (8, 20000, 27), generator=g, dtype=torch.int32).cuda()
vals = torch.randn((8, 20000, 27), generator=g).to(torch.bfloat16).cuda()
x = torch.randn((8, 300), generator=g).to(torch.bfloat16).cuda()
X = torch.randn((8, 300, 8), generator=g).to(torch.bfloat16).cuda()
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph):          # the kernels' first launches
    y = spmv.ell_spmv(cols, vals, x)
    Y = spmv.ell_spmm(cols, vals, X)
for _ in range(2):
    vals.mul_(-1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, spmv.ell_spmv(cols, vals, x))
    assert torch.equal(Y, spmv.ell_spmm(cols, vals, X))
print("GRAPH_OK")
"""


def test_ell_bf16_first_launch_in_a_captured_graph(dev):
    """In a fresh process, the bfloat16 kernels' first launches (their
    shared-memory opt-in and resident-block count taken then) are made
    under CUDA-graph capture; two replays on new values equal eager
    launches bit for bit."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", GRAPH_FIRST_USE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "GRAPH_OK" in out.stdout, out.stderr[-3000:]


@pytest.mark.parametrize("bs", bcsr.BLOCK_SIZES)
@pytest.mark.parametrize("k", [None, 1, 8, 40])
@pytest.mark.parametrize("shape", ["wide", "level3", "level4"])
@pytest.mark.parametrize("cut", [None, 7])
def test_bcsr_bf16(dev, bs, k, shape, cut):
    """bfloat16 BCSR at both block sizes: sources m that are not a multiple
    of bs, results cut to the true rows, the path's level-3 and level-4
    shapes, k = 1 and 8 and a k of several column tiles."""
    rng = np.random.default_rng(bs + (k or 0) + 3)
    mb, Kb, m = {"wide": (37, 40, 29 * bs - 5), "level3": (-(-57 // bs), 8, 57),
                 "level4": (-(-13 // bs), 2, 13)}[shape]
    rows = None if cut is None else max(mb * bs - cut, m)
    nb = -(-m // bs)
    bcols = rng.integers(0, nb, size=(D, mb, Kb)).astype(np.int32)
    bcols[rng.random((D, mb, Kb)) < 0.25] = -1
    bcols[0, 0] = -1                              # a block row of padding
    bcols = torch.as_tensor(bcols, device=dev)
    bvals = torch.as_tensor(rng.standard_normal((D, mb, Kb, bs, bs)),
                            dtype=BF16, device=dev)
    x = torch.as_tensor(rng.standard_normal((D, m) + (() if k is None else (k,))),
                        dtype=BF16, device=dev)
    fn = bcsr.bcsr_spmv if k is None else bcsr.bcsr_spmm
    before = bcsr.bcsr_spmm.launches
    got = fn(bcols, bvals, x, rows=rows)
    assert bcsr.bcsr_spmm.launches == before + 1
    _close_bf16(got, ref.bcsr_apply_ref(bcols, bvals, x, rows),
                _absum(ref.bcsr_apply_ref, bcols, bvals, x, rows))


@pytest.mark.parametrize("k", [None, 8])
def test_spmv_bf16_at_the_amg_operands(dev, k):
    """Each bfloat16 kernel at the operands a bfloat16 lowering of
    laplace_3d(24) on 2x4 ranks gives it: every level's A (fused and on
    part, ELL or BCSR), P and R, against the plain version."""
    from repro_torch.amg.dist_solve import DistHierarchy
    from repro_torch.amg.hierarchy import setup
    from repro_torch.amg.problems import laplace_3d

    dh = DistHierarchy.build(setup(laplace_3d(24), max_coarse=30), 2, 4,
                             dtype=BF16, device=dev)
    rng = np.random.default_rng(4)
    seen = set()
    for dl, a in zip(dh.levels, dh._arrs):
        for name in ("A", "P", "R"):
            op = getattr(dl, name)
            if op is None:
                continue
            arrs = a[name]
            pairs = [("on_cols", "on_vals", op.plan.local_n),
                     ("cols", "vals", op.plan.local_n + op.plan.halo_len)]
            if "bcols" in arrs:
                pairs = [("on_bcols", "on_bvals", op.plan.local_n),
                         ("bcols", "bvals", op.plan.local_n + op.plan.halo_len)]
            for ci, vi, m in pairs:
                shape = (8, m) + (() if k is None else (k,))
                x = torch.as_tensor(rng.standard_normal(shape), dtype=BF16, device=dev)
                idx, vals = arrs[ci], arrs[vi]
                if vi.endswith("bvals"):
                    seen.add("bcsr")
                    args = (op.rows_local,)
                    fn, plain = ((bcsr.bcsr_spmv if k is None else bcsr.bcsr_spmm),
                                 ref.bcsr_apply_ref)
                else:
                    seen.add("ell")
                    args = ()
                    fn, plain = ((spmv.ell_spmv, ref.ell_spmv_ref) if k is None
                                 else (spmv.ell_spmm, ref.ell_spmm_ref))
                _close_bf16(fn(idx, vals, x, *args), plain(idx, vals, x, *args),
                            _absum(plain, idx, vals, x, *args))
    assert seen == {"ell", "bcsr"}


# the node types cudaGraphDebugDotPrint writes into a node's label
GRAPH_NODE_TYPES = ("KERNEL", "MEMSET", "MEMCPY", "HOST", "EMPTY", "GRAPH",
                    "EVENT_RECORD", "WAIT_EVENT", "MEM_ALLOC", "MEM_FREE",
                    "CONDITIONAL", "EXT_SEMAS")


def _graph_nodes(fn):
    """``fn()`` captured as one CUDA graph and replayed once: its output and
    the graph's nodes as ``(type, label)``, read from the graph's own DOT
    dump (``cudaGraphDebugDotPrint``), so the count depends on nothing a
    profiler may or may not report."""
    import os
    import re
    import tempfile

    g = torch.cuda.CUDAGraph(keep_graph=True)     # the graph outlives capture
    g.enable_debug_mode()
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        out = fn()
    g.instantiate()
    g.replay()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        g.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    # a node's definition opens its line; an edge line opens with its
    # source node and an arrow
    starts = list(re.finditer(r'^\s*"(graph_\d+_node_\d+)"\s*\[', dot, re.M))
    nodes = []
    for a, b in zip(starts, starts[1:] + [None]):
        label = dot[a.end(): b.start() if b is not None else len(dot)]
        kind = next((t for t in GRAPH_NODE_TYPES
                     if re.search(rf"\b{t}\b", label)), "UNKNOWN")
        nodes.append((kind, label))
    assert nodes and all(k != "UNKNOWN" for k, _ in nodes), dot[:4000]
    return out, nodes


@pytest.mark.parametrize("k", [None, 3])
def test_bcsr_apply_is_one_launch(dev, k):
    """One BCSR apply on the card is one ``bcsr_spmm`` launch and nothing
    else (no pad of x, no slice of y), returning ``[D, rows_local(, k)]``:
    the whole apply of an operator whose halo is empty, and the on-process
    product of one whose halo is not; both against the CPU's apply.  The
    apply's device work is counted from the node list of a CUDA graph that
    captures it (a profiler may see no device event at all)."""
    import copy

    from repro_torch.amg.csr import CSR
    from repro_torch.amg.dist_spmv import build_dist_operator
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.core.topology import Partition, Topology

    rng = np.random.default_rng(0)
    n = 100                                   # 8 ranks of 13 rows: 2 blocks of 8
    part = Partition.balanced(n, Topology(n_nodes=8, ppn=1))
    dense = np.zeros((n, n))
    for d in range(8):
        lo, hi = part.local_range(d)
        dense[lo:hi, lo:hi] = rng.normal(size=(hi - lo, hi - lo))
    r, c = np.nonzero(dense)
    empty = build_dist_operator(CSR.from_coo(r, c, dense[r, c], (n, n)), 8, 1,
                                "standard", dtype=np.float64)
    halo = build_dist_operator(laplace_3d(7), 2, 4, "standard", dtype=np.float64)
    for op, full in ((empty, True), (halo, False)):
        op = copy.copy(op)
        op.lower_bcsr(8)
        assert op.rows_local % 8 != 0
        xg = rng.standard_normal((op.col_part.n,) + (() if k is None else (k,)))
        xs = op.scatter_x(xg, dtype=np.float64)
        outs = {}
        for where in ("cpu", "cuda"):
            arrs = op.to_device(torch.device(where), torch.float64)
            x = torch.as_tensor(xs, device=where)
            fn = ((lambda: op.apply(arrs, x)) if full else
                  (lambda: op._on_product(arrs, x, True)))
            if where == "cuda":
                fn()                          # the kernel's build and load
                before = bcsr.bcsr_spmm.launches
                y, nodes = _graph_nodes(fn)
                assert bcsr.bcsr_spmm.launches == before + 1
                assert len(nodes) == 1 and nodes[0][0] == "KERNEL" \
                    and "bcsr_spmm_kernel" in nodes[0][1], nodes
            else:
                y = fn()
            assert y.shape == (8, op.rows_local) + (() if k is None else (k,))
            outs[where] = y
        _close(outs["cuda"], outs["cpu"].to("cuda"))


def test_degenerate_and_bad_operands(dev):
    cols = torch.full((D, 0, 3), -1, dtype=torch.int32, device=dev)
    vals = torch.zeros((D, 0, 3), dtype=torch.float64, device=dev)
    before = spmv.ell_spmv.launches
    y = spmv.ell_spmv(cols, vals, torch.ones((D, 4), dtype=torch.float64,
                                             device=dev))
    assert y.shape == (D, 0) and spmv.ell_spmv.launches == before
    cols = torch.zeros((D, 4, 3), dtype=torch.int32, device=dev)
    vals = torch.ones((D, 3, 4), dtype=torch.float64, device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        spmv.ell_spmv(cols, vals, torch.ones((D, 4), dtype=torch.float64,
                                             device=dev))
    with pytest.raises(ValueError, match="different devices"):
        spmv.ell_spmv(cols, vals.contiguous(), torch.ones((D, 4),
                                                          dtype=torch.float64))
    with pytest.raises(ValueError, match="block size"):
        bcsr.bcsr_spmm(torch.zeros((D, 1, 1), dtype=torch.int32, device=dev),
                       torch.zeros((D, 1, 1, 4, 4), device=dev),
                       torch.zeros((D, 4, 1), device=dev))


@pytest.mark.parametrize("overlap", [True, False])
def test_dist_pcg_on_the_card_matches_the_cpu(dev, overlap):
    from repro_torch.amg.dist_solve import DistHierarchy, dist_pcg
    from repro_torch.amg.hierarchy import setup
    from repro_torch.amg.problems import laplace_3d

    A = laplace_3d(16)
    h = setup(A, max_coarse=30)
    b = np.random.default_rng(0).standard_normal(A.nrows)
    B = np.stack([b, 2 * b, np.zeros_like(b)], axis=1)   # a zero column too
    runs = {}
    for where in ("cpu", "cuda"):
        dh = DistHierarchy.build(h, 2, 4, dtype=torch.float64, device=where,
                                 overlap=overlap)
        runs[where] = (dist_pcg(dh, b, tol=1e-10), dist_pcg(dh, B, tol=1e-10))
    (s_cpu, m_cpu), (s_gpu, m_gpu) = runs["cpu"], runs["cuda"]
    assert s_gpu.converged and s_gpu.iterations == s_cpu.iterations
    r0 = s_cpu.residuals[0]
    assert np.abs(np.subtract(s_gpu.residuals, s_cpu.residuals)).max() <= 1e-7 * r0
    assert m_gpu.converged and np.isfinite(m_gpu.x).all()
    assert not m_gpu.x[:, 2].any()                       # zero column stays 0
    assert np.abs(m_gpu.x - m_cpu.x).max() <= 1e-7 * np.abs(m_cpu.x).max()


# flash attention: each output row's error over the row's own max|plain|
# (``rel_err_rows``), float32 at the reference suite's 2e-5, bfloat16 at
# 1e-2 (its 8-bit mantissa; both sides round the output)
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# (B, Hq, Hkv, Sq, Skv, D, window)
FA_CASES = [
    (2, 16, 8, 256, 256, 128, None),     # the qwen3 shape, whole tiles
    (1, 4, 2, 77, 77, 128, None),        # ragged S: one partial tile
    (3, 2, 1, 1, 1, 64, None),           # a single token
    (1, 4, 4, 200, 200, 64, 17),         # window narrower than a tile
    (2, 8, 2, 130, 130, 128, 64),        # window of exactly one tile
    (1, 14, 2, 13, 301, 64, None),       # Sq < Skv, right-aligned (decode)
    (1, 4, 2, 96, 1000, 128, 300),       # decode alignment with a window
    (4, 16, 8, 1819, 1819, 128, None),   # served prefill: S no whole key tiles
    # head dim 256: recurrentgemma-9b's MQA (16:1)
    (4, 16, 1, 1819, 1819, 256, None),   # its served prefill
    (1, 16, 1, 1819, 1819, 256, 256),    # a window that binds
    (1, 4, 1, 77, 77, 256, 17),          # ragged S, a window inside a tile
    (1, 16, 1, 13, 301, 256, None),      # Sq < Skv, right-aligned (decode)
    # head dim 96: phi-3-vision-4.2b's 32 heads of 96, no GQA
    (4, 32, 32, 1819, 1819, 96, None),   # its served prefill
    (1, 32, 32, 1819, 1819, 96, 256),    # a window that binds
    (1, 4, 2, 77, 77, 96, 17),           # ragged S, GQA, a window inside a tile
    (1, 32, 32, 13, 301, 96, None),      # Sq < Skv, right-aligned (decode)
]


def _close_fa(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = rel_err_rows(got, want)
    assert err <= FA_TOL[want.dtype], err


def _qkv(case, dtype, dev, seed=0):
    B, Hq, Hkv, Sq, Skv, D, _ = case
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention(dev, case, causal, dtype):
    """Each case through the kernel the route table names for its type and
    head dim (bfloat16: the Hopper design), counted on the wrapper and on
    that kernel."""
    q, k, v = _qkv(case, dtype, dev)
    name = fa.route(dtype, case[5])
    before = fa.flash_attention.launches
    before_kernel = fa.flash_attention.by_kernel[name].launches
    out = fa.flash_attention(q, k, v, causal=causal, window=case[-1])
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.by_kernel[name].launches == before_kernel + 1
    if dtype == torch.bfloat16:
        assert name == "flash_attention_wgmma"
    _close_fa(out, attention_ref(q, k, v, causal=causal, window=case[-1]))


def _wgmma_key_tile(head_dim: int) -> int:
    import re
    from pathlib import Path

    src = (Path(fa.__file__).parent / "csrc" / "flash_attention_wgmma.cu").read_text()
    m = re.search(rf"struct Cfg<{head_dim}> \{{\s*static constexpr int BK = (\d+)", src) or \
        re.search(r"template <int D>\nstruct Cfg \{\s*static constexpr int BK = (\d+)", src)
    return int(m.group(1))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", [64, 96, 128, 256])
def test_flash_attention_bf16_stage_boundaries(dev, head_dim, causal):
    """bfloat16 cases whose edges fall on the Hopper kernel's key tiles and
    ring stages: Skv a whole number of tiles (2 stages, then 3 to wrap the
    ring), a window of exactly one and two tiles, Sq < Skv ending on a
    tile, and Skv one key past a stage."""
    bk = _wgmma_key_tile(head_dim)
    for B, Hq, Hkv, Sq, Skv, window in ((1, 4, 2, 2 * bk, 2 * bk, None),
                                        (1, 4, 1, 3 * bk, 3 * bk, bk),
                                        (2, 2, 2, 4 * bk, 4 * bk, 2 * bk),
                                        (1, 4, 2, bk, 3 * bk, None),
                                        (1, 2, 1, 2 * bk + 1, 2 * bk + 1, bk + 1)):
        case = (B, Hq, Hkv, Sq, Skv, head_dim, window)
        q, k, v = _qkv(case, torch.bfloat16, dev, seed=3)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        _close_fa(out, attention_ref(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("head_dim,heads", [(96, (32, 32)), (256, (16, 1))])
def test_flash_attention_bf16_time_major_views(dev, head_dim, heads):
    """phi-3-vision-4.2b's and recurrentgemma-9b's head dims in bfloat16 as
    the models pass them: time-major [B, S, H, D] tensors read in place
    through the tensor maps' strides (their h stride is D, their s stride
    H D), through the Hopper kernel."""
    Hq, Hkv = heads
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((2, 301, Hq, head_dim), generator=g, device=dev).bfloat16()
    k = torch.randn((2, 301, Hkv, head_dim), generator=g, device=dev).bfloat16()
    v = torch.randn((2, 301, Hkv, head_dim), generator=g, device=dev).bfloat16()
    before = fa.flash_attention.by_kernel["flash_attention_wgmma"].launches
    out = fa_ops.attention(q, k, v, causal=True, window=200)
    assert fa.flash_attention.by_kernel["flash_attention_wgmma"].launches == before + 1
    assert out.is_contiguous()
    _close_fa(out, fa_ops.attention(q, k, v, causal=True, window=200, use_kernel=False))


def test_flash_attention_wgmma_builds_without_spills_on_hgmma_and_tma(dev):
    """The Hopper kernel's build: one instance at each head dim, none
    spilling (ptxas), each running its products on HGMMA (wgmma) and its
    copies on UTMALDG (TMA) in its SASS, with no HMMA (mma.sync)."""
    import re
    import subprocess
    from pathlib import Path

    from repro_torch.kernels.build import build_report, kernel, library_path, nvcc_path

    kernel("flash_attention_wgmma")
    rows = build_report("flash_attention_wgmma")
    assert len(rows) == 4, rows
    for name, used in rows:
        assert "0 bytes spill stores, 0 bytes spill loads" in used, (name, used)
    sass = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass",
                           str(library_path("flash_attention_wgmma"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    assert len(funcs) == 4
    for f in funcs:
        assert re.search(r"\bHGMMA\b", f) and re.search(r"\bUTMALDG\b", f), f[:200]
        assert not re.search(r"\bHMMA\b", f), f[:200]


@pytest.mark.parametrize("kind", ["peaked", "offset"])
@pytest.mark.parametrize("case", [FA_CASES[0], (1, 14, 2, 301, 301, 64, None),
                                  (1, 16, 1, 301, 301, 256, None),
                                  (1, 32, 32, 301, 301, 96, None)])
def test_flash_attention_f32_large_scores(dev, case, kind):
    """float32 with q scaled by 8 (one key dominates a row's softmax) and
    with k + 50 (scores in the hundreds, where the TF32 low parts carry
    the differences between keys), each row within 2e-5 of the float64
    truth.  The truth, not the float32 plain version: with k + 50 that is
    itself further than 2e-5 from the truth
    (``tests/test_torch_flash_attention.py::
    test_3xtf32_emulation_holds_large_scores``)."""
    q, k, v = _qkv(case, torch.float32, dev, seed=2)
    if kind == "peaked":
        q = q * 8
    else:
        k = k + 50
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = rel_err_rows(out, attention_f64(q, k, v))
    assert err <= FA_TOL[torch.float32], err


def test_flash_attention_f32_instances_do_not_spill(dev):
    """The ptxas report of the float32 instances: no register spills at
    head dims 64, 96 and 128; the head-dim-256 instance, whose accumulator alone
    takes 128 of its 255 registers, spills at most 128 bytes (76 on the
    toolchain it was written on; its time beside the others' in
    PERF.md)."""
    import re

    from repro_torch.kernels.build import build_report, kernel

    kernel("flash_attention")
    rows = [(name, used) for name, used in build_report("flash_attention")
            if "<float," in name or "IfLi" in name]
    assert len(rows) == 4, build_report("flash_attention")
    for name, used in rows:
        if "256" in name:
            stores = int(re.search(r"(\d+) bytes spill stores", used).group(1))
            assert stores <= 128, (name, used)
        else:
            assert "0 bytes spill stores, 0 bytes spill loads" in used, (name, used)


def test_flash_attention_bf16_strides_must_allow_16_byte_copies(dev):
    """bfloat16 rows are copied in 16-byte pieces, so strides must be
    multiples of 8 elements; a stride of 68 (a multiple of 4, which float32
    takes) raises instead of reaching the kernel or the plain version."""
    q = torch.zeros((1, 2, 8, 68), dtype=torch.bfloat16, device=dev)[..., :64]
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before
    q = torch.zeros((1, 2, 8, 68), device=dev)[..., :64]
    out = fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before + 1 and out.shape == q.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_time_major_views(dev, dtype):
    """The models' [B, S, H, D] tensors go in as strided views, no copy."""
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((2, 150, 16, 128), generator=g, device=dev).to(dtype)
    k = torch.randn((2, 150, 8, 128), generator=g, device=dev).to(dtype)
    v = torch.randn((2, 150, 8, 128), generator=g, device=dev).to(dtype)
    out = fa_ops.attention(q, k, v, causal=True)
    assert out.is_contiguous()
    _close_fa(out, fa_ops.attention(q, k, v, causal=True, use_kernel=False))


def test_flash_attention_failed_launch_raises(dev, monkeypatch):
    """A head dim the kernel has no instance for: the C side refuses it
    (cudaErrorInvalidValue) and the wrapper raises instead of falling
    back; no launch is counted."""
    monkeypatch.setattr(fa, "HEAD_DIMS", (64, 80, 128))
    q, k, v = _qkv((1, 2, 2, 8, 8, 80, None), torch.float32, dev)
    before = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before
    q, k, v = _qkv((1, 2, 2, 9, 8, 64, None), torch.float32, dev)
    with pytest.raises(ValueError, match="Sq = 9 > Skv = 8"):
        fa.flash_attention(q, k, v)


def test_lm_forward_on_the_card_matches_the_cpu(dev):
    """A small qwen3 (head dim 64) through the kernel on the card against
    the plain version on the CPU: logits and one decode step at 1e-4."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm
    from repro_torch.serve import prefill_to_decode_cache

    cfg = get_arch("qwen3-1.7b").reduced(n_layers=3, d_model=256, n_heads=4,
                                        vocab=512)
    model = init_lm(cfg, seed=0, dtype=torch.float32, device="cuda")
    cpu = init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 300)), dtype=torch.long)
    before = fa.flash_attention.launches
    with torch.inference_mode():
        got, c_gpu = model(tokens.to(dev), return_cache=True)
        want, c_cpu = cpu(tokens, return_cache=True)
        assert fa.flash_attention.launches == before + cfg.n_layers
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
        step = tokens[:, -1:]
        lg, _ = model.decode_step(step.to(dev),
                                  prefill_to_decode_cache(cfg, c_gpu, 320, 300), 300)
        lc, _ = cpu.decode_step(step, prefill_to_decode_cache(cfg, c_cpu, 320, 300),
                                300)
        assert float((lg.cpu() - lc).abs().max()) <= 1e-4 * float(lc.abs().max())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi-3-vision-4.2b"])
def test_train_step_on_the_card_matches_the_cpu(dev, arch):
    """Two train steps (loss, AdamW) of a small model on the card against
    the same weights on the CPU, at S = 1100 with remat so the plain path
    runs ``chunked_attention``: losses at 1e-5, the parameters within 0.25
    lr (an element whose gradient is near zero moves by a ratio of two
    small numbers) and the moments at 1e-4 of their max."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm
    from repro_torch.train import (AdamWConfig, TrainOptions, init_opt_state,
                                   make_step_fn)

    kw = (dict(n_layers=2, d_model=192, n_heads=2, vocab=256)
          if arch.startswith("phi") else
          dict(n_layers=2, d_model=128, n_heads=4, vocab=256))
    cfg = get_arch(arch).reduced(**kw)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    rng = np.random.default_rng(0)
    B, S = 2, 1100
    batches = [{"inputs": torch.as_tensor(
                    rng.integers(0, cfg.vocab, (B, S)) if cfg.embed_input else
                    rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)),
                "targets": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)))}
               for _ in range(2)]
    runs = {}
    for device in ("cuda", "cpu"):
        model = init_lm(cfg, seed=0, dtype=torch.float32, device="cpu",
                        trainable=True).to(device)
        opt = init_opt_state(dict(model.named_parameters()))
        step = make_step_fn(cfg, acfg, TrainOptions(remat=True))
        losses = []
        for batch in batches:
            model, opt, m = step(model, opt, {k: v.to(device) for k, v in batch.items()})
            losses.append(float(m["loss"]))
        runs[device] = (losses, {n: p.detach().cpu() for n, p in model.named_parameters()},
                        {n: t.cpu() for n, t in opt["m"].items()})
    (lg, pg, mg), (lc, pc, mc) = runs["cuda"], runs["cpu"]
    assert np.allclose(lg, lc, rtol=1e-5, atol=0)
    for n in pc:
        assert float((pg[n] - pc[n]).abs().max()) <= 0.25 * acfg.lr, n
        assert float((mg[n] - mc[n]).abs().max()) <= 1e-4 * float(mc[n].abs().max()), n


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_recurrent_lm_on_the_card_matches_the_cpu(dev, arch):
    """A small recurrent arch on the card (recurrentgemma's attention at
    head dim 256 through the kernel) against the same weights on the CPU:
    logits and two decode steps at 1e-4 of max|logits|, and the recurrent
    states' tensors on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm
    from repro_torch.serve import prefill_to_decode_cache

    cfg = get_arch(arch).reduced(n_layers=5 if arch == "recurrentgemma-9b" else 8,
                                 d_model=512, n_heads=2, vocab=512)
    model = init_lm(cfg, seed=0, dtype=torch.float32, device="cuda")
    cpu = init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 300)), dtype=torch.long)
    n_attn = sum(k == "attn" for k in model.kinds)
    before = fa.flash_attention.launches
    with torch.inference_mode():
        got, c_gpu = model(tokens.to(dev), return_cache=True)
        want, c_cpu = cpu(tokens, return_cache=True)
        assert fa.flash_attention.launches == before + n_attn
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())
        caches = [prefill_to_decode_cache(cfg, c, 320, 300) for c in (c_gpu, c_cpu)]
        for t in range(2):
            step = tokens[:, t:t + 1]
            lg, _ = model.decode_step(step.to(dev), caches[0], 300 + t)
            lc, _ = cpu.decode_step(step, caches[1], 300 + t)
            assert float((lg.cpu() - lc).abs().max()) <= 1e-4 * float(lc.abs().max())
    groups, extra = caches[0]
    assert all(t.device.type == "cuda" for c in groups + extra for t in c.values())


# ------------------------------------------------ the block smoothers
def _rhs(rng, D, m, k, dtype, dev):
    shape = (D, m) + (() if k is None else (k,))
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [None, 1, 3, 33])
@pytest.mark.parametrize("bs,m", [(1, 13), (3, 13), (4, 64), (4, 1001),
                                  (8, 1), (8, 4097)])
def test_block_diag_apply(dev, bs, m, k, dtype):
    rng = np.random.default_rng(bs * m)
    nb = -(-m // bs)
    binv = torch.as_tensor(rng.standard_normal((D, nb, bs, bs)), dtype=dtype,
                           device=dev)
    r, x = _rhs(rng, D, m, k, dtype, dev), _rhs(rng, D, m, k, dtype, dev)
    before = sm.block_diag_apply.launches
    got = sm.block_diag_apply(binv, r, x, 0.7)
    assert sm.block_diag_apply.launches == before + 1
    _close(got, sref.block_diag_apply_ref(binv, r, x, 0.7))


def _order(cols, upper):
    """The kernel's row order: each rank's rows by level set and where the
    sets begin, as ``TriFactor.place`` builds them."""
    lev = sref.dag_levels(cols.cpu().numpy(), upper)
    return tuple(torch.as_tensor(f(lev), device=cols.device)
                 for f in (sref.rank_level_order, sref.rank_level_starts))


def _another_order(cols, upper, route):
    """Another valid order for the route: each rank's rows in plain row
    order (descending for the upper triangle) on the L2 route, which reads
    no level sets; on the block route each level set's rows reversed."""
    Dn, m = cols.shape[:2]
    order, starts = _order(cols, upper)
    if route == "l2":
        rows = np.arange(m)[::-1] if upper else np.arange(m)
        return torch.as_tensor(np.tile(rows, (Dn, 1)).astype(np.int32),
                               device=cols.device), starts
    order, st = order.cpu().numpy(), starts.cpu().numpy()
    for d in range(Dn):
        for lo, hi in zip(st[d, :-1], st[d, 1:]):
            order[d, lo:hi] = order[d, lo:hi][::-1].copy()
    return torch.as_tensor(order, device=cols.device), starts


def _triangle(rng, Dn, m, K, upper, dtype, dev, chain=False):
    """A random strict triangle in ELL (padding at the row's end, columns
    ascending), small values and a diagonal in [1, 2): a stable solve.
    ``chain`` adds each row's neighbour, so the DAG is m levels deep."""
    cols = np.full((Dn, m, K), -1, dtype=np.int32)
    vals = np.zeros((Dn, m, K))
    for d in range(Dn):
        for i in range(m):
            cand = np.arange(i + 1, m) if upper else np.arange(i)
            n = min(len(cand), int(rng.integers(0, K + 1)))
            c = rng.choice(cand, size=n, replace=False)
            if chain and len(cand) and (i + 1 if upper else i - 1) not in c:
                c = np.append(c[: K - 1], i + 1 if upper else i - 1)
            c = np.sort(c)
            cols[d, i, :c.size] = c
            vals[d, i, :c.size] = rng.standard_normal(c.size) * 0.5 / max(K, 1)
    diag = 1.0 + rng.random((Dn, m))
    return (torch.as_tensor(cols, device=dev),
            torch.as_tensor(vals, dtype=dtype, device=dev),
            torch.as_tensor(diag, dtype=dtype, device=dev))


def _stencil_triangle(rng, Dn, m, nx, ny, upper, dtype, dev):
    """The strict lower (or upper) triangle of the 27-point stencil on an
    nx × ny × ceil(m / (nx·ny)) box in natural order, cut to its first m
    rows (13 entries a row; the level-0 triangles of laplace_3d(64) on 2 x 4
    ranks are 32 x 32 x 32, depth 218), random values, diagonal in [1, 2)."""
    i = np.arange(m)
    x, y, zc = i % nx, (i // nx) % ny, i // (nx * ny)
    offs = [o for o in np.ndindex(3, 3, 3)
            if ((o > (1, 1, 1)) if upper else (o < (1, 1, 1)))]
    cols = np.full((m, len(offs)), -1, dtype=np.int32)
    for e, (dz, dy, dx) in enumerate(offs):
        cx, cy, cz = x + dx - 1, y + dy - 1, zc + dz - 1
        c = cx + nx * (cy + ny * cz)
        ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (cz >= 0) & (c < m)
        cols[ok, e] = c[ok]
    cols = np.sort(np.where(cols < 0, np.iinfo(np.int32).max, cols), axis=1)
    cols = np.where(cols == np.iinfo(np.int32).max, -1, cols).astype(np.int32)
    cols = np.broadcast_to(cols, (Dn, m, len(offs))).copy()
    vals = np.where(cols >= 0, rng.standard_normal(cols.shape) * 0.5 / 13, 0.0)
    diag = 1.0 + rng.random((Dn, m))
    return (torch.as_tensor(cols, device=dev),
            torch.as_tensor(vals, dtype=dtype, device=dev),
            torch.as_tensor(diag, dtype=dtype, device=dev))


def _solve_checked(cols, vals, diag, r, x, w, upper, route):
    """One launch on ``route``: the result, held against the plain version
    and repeated bit for bit by a second launch."""
    order = _order(cols, upper)
    before = sm.tri_solve.launches
    got = sm.tri_solve(cols, vals, diag, r, x, w, upper=upper, order=order,
                       route=route)
    again = sm.tri_solve(cols, vals, diag, r, x, w, upper=upper, order=order,
                         route=route)
    assert sm.tri_solve.launches == before + 2
    sched = sref.level_schedule(cols.cpu().numpy(), upper, cols.device)
    _close(got, sref.tri_solve_ref(cols, vals, diag, r, x, w, sched))
    assert torch.equal(got, again)
    return got


def _fits(m, k, dtype, dev):
    """Whether a rank of m rows and k right-hand sides fits a block (its
    solution z in ``sm.z_dtype(dtype)``)."""
    return m * (k or 1) * sm.z_dtype(dtype).itemsize <= sm.tri_smem(dev)


def _takes(route, cols, k, dtype, dev, upper=False):
    """Whether ``route`` can take the case (``sm.tri_routes``: the staged
    route only for bfloat16 at k = 1 where z, the starts and its smallest
    ring fit a block)."""
    Dn, m, K = cols.shape
    nlev = int(sref.dag_levels(cols.cpu().numpy(), upper).max(initial=-1)) + 1
    return route in sm.tri_routes(m, nlev, k or 1, dtype, sm.tri_smem(dev), K=K)


@pytest.mark.parametrize("route", sm.TRI_ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [None, 1, 2, 8, 33])
@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
@pytest.mark.parametrize("Dn,m,K,chain", [(1, 1, 0, False), (3, 37, 5, False),
                                          (8, 300, 13, False),
                                          (2, 200, 40, False),
                                          (8, 1000, 27, False),
                                          (2, 3000, 3, True)])
def test_tri_solve(dev, Dn, m, K, chain, upper, k, dtype, route):
    rng = np.random.default_rng(m + K)
    cols, vals, diag = _triangle(rng, Dn, m, K, upper, dtype, dev, chain)
    r, x = _rhs(rng, Dn, m, k, dtype, dev), _rhs(rng, Dn, m, k, dtype, dev)
    if chain:
        assert len(sref.level_schedule(cols.cpu().numpy(), upper)) == m
    if route == "block" and not _fits(m, k, dtype, dev):
        # a rank past a block's shared memory: the forced block refuses
        with pytest.raises(ValueError, match="do not fit"):
            sm.tri_solve(cols, vals, diag, r, x, 0.9, upper=upper,
                         order=_order(cols, upper), route=route)
        return
    if route == "staged":
        # bfloat16 only (test_tri_solve_bf16): a forced staged route refuses
        before = sm.tri_solve.launches
        with pytest.raises(ValueError, match="staged route"):
            sm.tri_solve(cols, vals, diag, r, x, 0.9, upper=upper,
                         order=_order(cols, upper), route=route)
        assert sm.tri_solve.launches == before
        return
    got = _solve_checked(cols, vals, diag, r, x, 0.9, upper, route)
    # the rows in another valid order (plain row order on the L2 route,
    # each level set reversed on the block route): the same answer, bit for
    # bit
    natural = sm.tri_solve(cols, vals, diag, r, x, 0.9, upper=upper,
                           order=_another_order(cols, upper, route),
                           route=route)
    assert torch.equal(got, natural)
    # the two routes sum each row in one order: the same bits
    if _fits(m, k, dtype, dev):
        other = sm.tri_solve(cols, vals, diag, r, x, 0.9, upper=upper,
                             order=_order(cols, upper),
                             route="block" if route == "l2" else "l2")
        assert torch.equal(got, other)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
def test_tri_solve_at_the_level_0_rank_size(dev, upper, k, dtype):
    """Level 0 of laplace_3d(64) on 2 x 4 ranks: 32,768 rows a rank, the
    27-point stencil's 13-entry triangles, 218 level sets, on the route the
    rule takes (L2: about 150 rows a level set), and on the block route
    where a rank fits one (f32, k = 1), bit-equal."""
    rng = np.random.default_rng(k)
    Dn, m = 2, 32_768
    cols, vals, diag = _stencil_triangle(rng, Dn, m, 32, 32, upper, dtype, dev)
    assert len(sref.level_schedule(cols.cpu().numpy(), upper)) == 218
    kk = None if k == 1 else k
    r, x = _rhs(rng, Dn, m, kk, dtype, dev), _rhs(rng, Dn, m, kk, dtype, dev)
    assert sm.tri_plan(m, 218, k, dtype, sm.tri_smem(dev)) == "l2"
    got = _solve_checked(cols, vals, diag, r, x, 1.0, upper, None)
    assert _fits(m, k, dtype, dev) == (dtype == torch.float32 and k == 1)
    if _fits(m, k, dtype, dev):
        assert torch.equal(got, _solve_checked(cols, vals, diag, r, x, 1.0,
                                               upper, "block"))


@pytest.mark.parametrize("side", ["fits", "one row more"])
@pytest.mark.parametrize("edge", ["width", "shared memory"])
def test_tri_solve_at_the_route_rule_edge(dev, edge, side):
    """The rule's two edges, f64, k = 1: a rank whose level sets hold
    BLOCK_MAX_WIDTH rows on average (20 sets of that many rows, each row
    needing one of the set before) and a chain whose rows just fill a
    block's shared memory take the block route; one row more (a row with no
    dependency, so the sets stay 20; one more link of the chain) takes the
    L2 route, where a forced block raises past the shared memory; all
    solve."""
    rng = np.random.default_rng(3)
    smem = sm.tri_smem(dev)
    more = side == "one row more"
    if edge == "width":
        w, nlev = sm.BLOCK_MAX_WIDTH[8], 20
        m = w * nlev + more
        dep = np.arange(m) - w
        dep[:w] = -1
        dep[w * nlev:] = -1
    else:
        m, nlev = smem // 8 + more, smem // 8 + more
        dep = np.arange(m) - 1
    cols = torch.as_tensor(dep.reshape(1, m, 1).astype(np.int32), device=dev)
    vals = torch.as_tensor(np.where(dep >= 0, 0.5, 0.0).reshape(1, m, 1),
                           dtype=torch.float64, device=dev)
    diag = torch.as_tensor(1.0 + rng.random((1, m)), dtype=torch.float64,
                           device=dev)
    assert len(sref.level_schedule(cols.cpu().numpy(), False)) == nlev
    r, x = _rhs(rng, 1, m, None, torch.float64, dev), _rhs(rng, 1, m, None,
                                                           torch.float64, dev)
    assert sm.tri_plan(m, nlev, 1, torch.float64, smem) == ("l2" if more else "block")
    if edge == "shared memory" and more:
        with pytest.raises(ValueError):
            sm.tri_plan(m, nlev, 1, torch.float64, smem, "block")
    _solve_checked(cols, vals, diag, r, x, 1.0, False, None)


@pytest.mark.parametrize("route", ["block", "l2"])
def test_tri_solve_deep_chain_finishes(dev, route):
    """A 20,000-row chain (each row needs the one before: depth = m) runs to
    its end on each route: 20,000 barriers on the block route, 20,000 waits
    on the L2 route, each well inside its polling trap."""
    rng = np.random.default_rng(4)
    cols, vals, diag = _triangle(rng, 1, 20_000, 3, False, torch.float64,
                                 dev, chain=True)
    r, x = _rhs(rng, 1, 20_000, None, torch.float64, dev), _rhs(
        rng, 1, 20_000, None, torch.float64, dev)
    _solve_checked(cols, vals, diag, r, x, 1.0, False, route)


@pytest.mark.parametrize("route", sm.TRI_ROUTES)
@pytest.mark.parametrize("k", [None, 8])
def test_tri_solve_nan_in_r_stays_nan(dev, k, route):
    """A NaN in r (the canonical one, and all-ones bits: the empty pattern
    the L2 route's z starts from) comes out as NaN in y at its row and at
    every row that depends on it, as in the plain version; the rest holds
    its bars.  (The staged route takes bfloat16 only: its NaN case is
    test_tri_solve_staged_edges'.)"""
    if route == "staged":
        pytest.skip("the staged route takes bfloat16 operands only")
    rng = np.random.default_rng(6)
    cols, vals, diag = _triangle(rng, 2, 300, 5, False, torch.float64, dev)
    r, x = _rhs(rng, 2, 300, k, torch.float64, dev), _rhs(rng, 2, 300, k,
                                                          torch.float64, dev)
    r[0, 17] = float("nan")
    r.view(torch.int64)[1, 40] = -1                       # all-ones bits
    got = sm.tri_solve(cols, vals, diag, r, x, 1.0, upper=False,
                       order=_order(cols, False), route=route)
    sched = sref.level_schedule(cols.cpu().numpy(), False, dev)
    want = sref.tri_solve_ref(cols, vals, diag, r, x, 1.0, sched)
    torch.cuda.synchronize()
    assert torch.isnan(want[0, 17]).all() and torch.isnan(want[1, 40]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    _close(got[keep], want[keep])


def test_tri_solve_without_an_order_raises(dev):
    """On the card the kernel needs the row order: none, or a bare order
    tensor with no level-set starts, raises a ValueError naming it before
    any launch."""
    rng = np.random.default_rng(7)
    cols, vals, diag = _triangle(rng, 2, 50, 4, False, torch.float64, dev)
    r, x = _rhs(rng, 2, 50, None, torch.float64, dev), _rhs(rng, 2, 50, None,
                                                            torch.float64, dev)
    before = sm.tri_solve.launches
    for order in (None, _order(cols, False)[0]):
        with pytest.raises(ValueError, match="order"):
            sm.tri_solve(cols, vals, diag, r, x, upper=False, order=order)
    assert sm.tri_solve.launches == before


@pytest.mark.parametrize("route", sm.TRI_ROUTES)
@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
def test_tri_solve_replays_in_a_graph(dev, upper, route):
    """Captured, a solve is one kernel node on the block and staged routes
    (z in shared memory, no scratch to clear; the staged route's slab built
    before the capture, in bfloat16) and a memset node (its z set empty)
    and a kernel node on the L2 route; every replay solves the values its
    static inputs hold then."""
    rng = np.random.default_rng(1)
    dtype = BF16 if route == "staged" else torch.float64
    cols, vals, diag = _triangle(rng, 8, 500, 13, upper, dtype, dev)
    r = _rhs(rng, 8, 500, None, dtype, dev)
    x = torch.zeros_like(r)
    # each rank's rows by level set (and the slab), built before the capture
    order = _order(cols, upper)
    kw = dict(upper=upper, order=order, route=route)
    if route == "staged":
        kw["slab"] = sm.TriSlab(cols, vals, diag, order[0])
    sm.tri_solve(cols, vals, diag, r, x, **kw)  # build, load
    y, nodes = _graph_nodes(lambda: sm.tri_solve(cols, vals, diag, r, x, **kw))
    want = ["KERNEL", "MEMSET"] if route == "l2" else ["KERNEL"]
    assert sorted(kind for kind, _ in nodes) == want, nodes
    assert any(f"tri_solve_{route}_kernel" in label for _, label in nodes)
    sched = sref.level_schedule(cols.cpu().numpy(), upper, dev)
    if route == "staged":
        _close_bf16(y, sref.tri_solve_ref(cols, vals, diag, r, x, 1.0, sched),
                    sref.tri_solve_absum(cols, vals, diag, r, x, 1.0, sched))
        # a slab that does not serve the values is refused under capture
        vals.mul_(0.5)
        with pytest.raises(RuntimeError, match="before a capture"):
            _graph_nodes(lambda: sm.tri_solve(cols, vals, diag, r, x, **kw))
    else:
        _close(y, sref.tri_solve_ref(cols, vals, diag, r, x, 1.0, sched))


@pytest.mark.parametrize("smoother", ["block_jacobi", "hybrid_gs",
                                      "hybrid_gs_sym"])
def test_block_smoother_pcg_on_the_card_matches_the_cpu(dev, smoother):
    """laplace_3d(16) on 2×4, f64: PCG through the captured graphs, one RHS
    and three, against the same solve on the CPU (≤ 1e-7 of r0); the
    graphs launch the smoother's kernel."""
    from repro_torch.amg.dist_solve import DistHierarchy, dist_pcg
    from repro_torch.amg.hierarchy import setup
    from repro_torch.amg.problems import laplace_3d
    from repro_torch.amg.solve import SolveOptions

    A = laplace_3d(16)
    h = setup(A, max_coarse=30)
    b = np.random.default_rng(0).standard_normal(A.nrows)
    B = np.stack([b, 2 * b, np.zeros_like(b)], axis=1)
    opts = SolveOptions(smoother=smoother)
    wrapper = sm.block_diag_apply if smoother == "block_jacobi" else sm.tri_solve
    runs = {}
    for where in ("cpu", "cuda"):
        dh = DistHierarchy.build(h, 2, 4, dtype=torch.float64, device=where)
        before = wrapper.launches
        runs[where] = (dist_pcg(dh, b, tol=1e-10, opts=opts),
                       dist_pcg(dh, B, tol=1e-10, opts=opts))
        if where == "cuda":
            assert wrapper.launches > before
            assert all(p.graph is not None for p in dh.programs.values())
    (s_cpu, m_cpu), (s_gpu, m_gpu) = runs["cpu"], runs["cuda"]
    assert s_gpu.converged and s_gpu.iterations == s_cpu.iterations
    r0 = s_cpu.residuals[0]
    assert np.abs(np.subtract(s_gpu.residuals, s_cpu.residuals)).max() <= 1e-7 * r0
    assert m_gpu.converged and not m_gpu.x[:, 2].any()
    assert np.abs(m_gpu.x - m_cpu.x).max() <= 1e-7 * np.abs(m_cpu.x).max()


# bfloat16 block smoothers: the kernels and their plain versions widen to
# float32, sum in float32 (tri_solve keeps z in float32 between level sets)
# and round y once, so an entry may differ by one bfloat16 ulp where the two
# float32 values fall on either side of a tie: the sparse kernels' bar, with
# Σ|a·x| the magnitudes each entry adds up (``ref.*_absum``)
@pytest.mark.parametrize("k", [None, 1, 3, 33])
@pytest.mark.parametrize("bs,m", [(1, 13), (3, 13), (4, 64), (4, 1001),
                                  (8, 1), (8, 4097)])
def test_block_diag_apply_bf16(dev, bs, m, k):
    rng = np.random.default_rng(bs * m + 1)
    nb = -(-m // bs)
    binv = torch.as_tensor(rng.standard_normal((D, nb, bs, bs)), dtype=BF16,
                           device=dev)
    r, x = _rhs(rng, D, m, k, BF16, dev), _rhs(rng, D, m, k, BF16, dev)
    before = sm.block_diag_apply.launches
    got = sm.block_diag_apply(binv, r, x, 0.7)
    assert sm.block_diag_apply.launches == before + 1
    _close_bf16(got, sref.block_diag_apply_ref(binv, r, x, 0.7),
                sref.block_diag_apply_absum(binv, r, x, 0.7))
    assert torch.equal(got, sm.block_diag_apply(binv, r, x, 0.7))
    # the order of sums of both paths (bs 4 with whole blocks: a thread a
    # block; else a thread an output), bit for bit
    assert torch.equal(got, sorder.block_diag_apply_emulate(binv, r, x, 0.7))


def _solve_checked_bf16(cols, vals, diag, r, x, w, upper, route):
    """``_solve_checked`` in bfloat16: one launch on ``route`` against the
    plain version at the bfloat16 bar, repeated bit for bit."""
    order = _order(cols, upper)
    before = sm.tri_solve.launches
    got = sm.tri_solve(cols, vals, diag, r, x, w, upper=upper, order=order,
                       route=route)
    assert sm.tri_solve.launches == before + 1
    sched = sref.level_schedule(cols.cpu().numpy(), upper, cols.device)
    _close_bf16(got, sref.tri_solve_ref(cols, vals, diag, r, x, w, sched),
                sref.tri_solve_absum(cols, vals, diag, r, x, w, sched))
    assert torch.equal(got, sm.tri_solve(cols, vals, diag, r, x, w,
                                         upper=upper, order=order,
                                         route=route))
    return got


@pytest.mark.parametrize("route", sm.TRI_ROUTES)
@pytest.mark.parametrize("k", [None, 1, 8, 33])
@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
@pytest.mark.parametrize("Dn,m,K,chain", [(1, 1, 0, False), (3, 37, 5, False),
                                          (8, 1000, 27, False),
                                          (2, 3000, 3, True)])
def test_tri_solve_bf16(dev, Dn, m, K, chain, upper, k, route):
    """bfloat16 on each route: against the plain version at the bar, bit
    for bit run to run, in another valid order and across every route that
    takes the case (z is float32 on all, so a rank fits a block at 4 bytes
    a value; the staged route at k = 1 only, where a forced one at k > 1
    refuses)."""
    rng = np.random.default_rng(m + K + 1)
    cols, vals, diag = _triangle(rng, Dn, m, K, upper, BF16, dev, chain)
    r, x = _rhs(rng, Dn, m, k, BF16, dev), _rhs(rng, Dn, m, k, BF16, dev)
    if route == "block" and not _fits(m, k, BF16, dev):
        with pytest.raises(ValueError, match="do not fit"):
            sm.tri_solve(cols, vals, diag, r, x, 0.9, upper=upper,
                         order=_order(cols, upper), route=route)
        return
    if route == "staged" and not _takes(route, cols, k, BF16, dev, upper):
        assert k not in (None, 1)
        with pytest.raises(ValueError, match="staged route"):
            sm.tri_solve(cols, vals, diag, r, x, 0.9, upper=upper,
                         order=_order(cols, upper), route=route)
        return
    got = _solve_checked_bf16(cols, vals, diag, r, x, 0.9, upper, route)
    assert torch.equal(got, sm.tri_solve(
        cols, vals, diag, r, x, 0.9, upper=upper,
        order=_another_order(cols, upper, route), route=route))
    for other in sm.TRI_ROUTES:
        if other != route and _takes(other, cols, k, BF16, dev, upper):
            assert torch.equal(got, sm.tri_solve(
                cols, vals, diag, r, x, 0.9, upper=upper,
                order=_order(cols, upper), route=other)), other
    if k in (None, 1):                    # the kernels' order of sums
        sched = sref.level_schedule(cols.cpu().numpy(), upper, dev)
        assert torch.equal(got, sorder.tri_solve_emulate(
            cols, vals, diag, r.reshape(Dn, m), x.reshape(Dn, m), 0.9,
            sched).reshape(got.shape))


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
def test_tri_solve_bf16_at_the_level_0_rank_size(dev, upper, k):
    """Level 0's rank size (32,768 rows, 218 level sets) in bfloat16: the
    rule takes the staged route at k = 1 (z's 128 KiB and a ring of 13-slot
    stages) and the L2 route at k = 8, the block route fits at k = 1 only
    (128 KiB of float32 z), and the routes agree bit for bit."""
    rng = np.random.default_rng(k + 2)
    Dn, m = 2, 32_768
    cols, vals, diag = _stencil_triangle(rng, Dn, m, 32, 32, upper, BF16, dev)
    kk = None if k == 1 else k
    r, x = _rhs(rng, Dn, m, kk, BF16, dev), _rhs(rng, Dn, m, kk, BF16, dev)
    assert sm.tri_plan(m, 218, k, BF16, sm.tri_smem(dev),
                       K=13) == ("staged" if k == 1 else "l2")
    got = _solve_checked_bf16(cols, vals, diag, r, x, 1.0, upper, None)
    assert _fits(m, k, BF16, dev) == (k == 1)
    if k == 1:
        for route in ("block", "l2"):
            assert torch.equal(got, _solve_checked_bf16(cols, vals, diag, r, x,
                                                        1.0, upper, route))


@pytest.mark.parametrize("case", ["chain 20000", "chain 8192 on 8 ranks",
                                  "one set of 5000", "sets across stages",
                                  "ranks apart", "rows of 40 slots", "nan"])
def test_tri_solve_staged_edges(dev, case):
    """The staged route at its edges, bfloat16, k = 1, against the plain
    version at the bar and the L2 route bit for bit: a 20,000-row chain
    (20,000 barriers, 157 stages through a ring of 8); a pure chain of
    8,192 rows on each of 8 ranks (the one-step floor's operand), solved 20
    times, the same bits each time; one level set of 5,000 rows (wider
    than the ring: solved in passes that release their stages); level sets
    of 100-300 rows that straddle stages; 8 ranks with different depths
    (each block its own number of sets, the rest empty); rows of up to 40
    slots (the instance for K past 32); a NaN in r, which stays at its row
    and those that depend on it."""
    rng = np.random.default_rng(len(case))
    if case == "chain 20000":
        cols, vals, diag = _triangle(rng, 1, 20_000, 3, False, BF16, dev,
                                     chain=True)
    elif case == "chain 8192 on 8 ranks":
        m = 8192
        dep = np.arange(-1, m - 1, dtype=np.int32)
        cols = torch.as_tensor(np.tile(dep, (8, 1))[..., None], device=dev)
        vals = torch.as_tensor(rng.standard_normal((8, m, 1)) * 0.5, dtype=BF16,
                               device=dev).masked_fill(cols < 0, 0)
        diag = torch.as_tensor(1.0 + rng.random((8, m)), dtype=BF16, device=dev)
    elif case == "rows of 40 slots":
        cols, vals, diag = _triangle(rng, 4, 2000, 40, False, BF16, dev)
    elif case == "one set of 5000":
        cols = torch.full((2, 5000, 3), -1, dtype=torch.int32, device=dev)
        vals = torch.zeros((2, 5000, 3), dtype=BF16, device=dev)
        diag = torch.as_tensor(1.0 + rng.random((2, 5000)), dtype=BF16,
                               device=dev)
    elif case == "sets across stages":
        # level sets of 100-300 consecutive rows, each row depending on a
        # random row of the set before
        m = 3000
        edges = np.concatenate([[0], np.cumsum(100 + rng.integers(0, 200, 30))])
        edges = np.append(edges[edges < m], m)
        dep = np.full(m, -1)
        for a, b, c in zip(edges[:-2], edges[1:-1], edges[2:]):
            dep[b:c] = rng.integers(a, b, c - b)
        cols = torch.as_tensor(dep.reshape(1, m, 1).astype(np.int32), device=dev)
        vals = torch.as_tensor(np.where(dep >= 0, 0.3, 0.0).reshape(1, m, 1),
                               dtype=BF16, device=dev)
        diag = torch.as_tensor(1.0 + rng.random((1, m)), dtype=BF16, device=dev)
    else:
        cols, vals, diag = _triangle(rng, 8, 1000, 13, False, BF16, dev)
        cols[3, :, :] = -1                     # a rank of one level set
    Dn, m, _ = cols.shape
    r, x = _rhs(rng, Dn, m, None, BF16, dev), _rhs(rng, Dn, m, None, BF16, dev)
    if case == "nan":
        r[0, 17] = float("nan")
    assert _takes("staged", cols, 1, BF16, dev)
    order = _order(cols, False)
    got = sm.tri_solve(cols, vals, diag, r, x, 0.9, upper=False, order=order,
                       route="staged")
    if case == "chain 8192 on 8 ranks":
        slab = sm.TriSlab(cols, vals, diag, order[0])
        for _ in range(20):
            assert torch.equal(got, sm.tri_solve(
                cols, vals, diag, r, x, 0.9, upper=False, order=order,
                route="staged", slab=slab))
    sched = sref.level_schedule(cols.cpu().numpy(), False, dev)
    want = sref.tri_solve_ref(cols, vals, diag, r, x, 0.9, sched)
    torch.cuda.synchronize()
    keep = ~torch.isnan(want)
    assert torch.equal(torch.isnan(got), ~keep)
    _close_bf16(got[keep], want[keep],
                sref.tri_solve_absum(cols, vals, diag, r, x, 0.9, sched)[keep])
    l2 = sm.tri_solve(cols, vals, diag, r, x, 0.9, upper=False, order=order,
                      route="l2")
    assert torch.equal(got[keep], l2[keep])


# ------------------------------------------------ ERT micro-kernels
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 255, 257, 1 << 20, (1 << 22) + 3])
def test_ert_kernels_match_plain_on_the_card(dev, dtype, n):
    from repro_torch.kernels.ert.ert import ert_gather, ert_stream
    from repro_torch.kernels.ert.ref import ert_gather_ref, ert_stream_ref

    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=gen, device=dev, dtype=dtype)
    idx = torch.randint(0, n, (2 * n + 1,), generator=gen, device=dev,
                        dtype=torch.int64).to(torch.int32)
    for t in (1, 16, 64):
        got, want = ert_stream(x, t), ert_stream_ref(x, t, 1.0000001, 0.5)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())
    n0 = ert_gather.launches
    assert torch.equal(ert_gather(x, idx), ert_gather_ref(x, idx))
    assert ert_gather.launches == n0 + 1


def test_ert_sweep_on_the_card(dev):
    from repro_torch.launch import roofline
    sw = roofline.ert_sweep(smoke=True, reps=2)
    assert sw["device"] == torch.cuda.get_device_name(0)
    assert sw["stream_bw"] > 0 and sw["gather_bw"] > 0 and sw["flops"] > 0
    assert np.isfinite([p["seconds"] for p in sw["points"]]).all()
