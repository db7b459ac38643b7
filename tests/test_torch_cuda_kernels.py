"""The CUDA kernels on the card (marker ``cuda``; skipped where there is no
card): each kernel against its plain version over ragged shapes — every
lane-group width of the ELL SpMV, rows that do not fill a block, sources
that are not a multiple of the BCSR block size, degenerate shapes — and a
small distributed PCG on the card against the same solve on the CPU.

Run on a machine with an NVIDIA card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 4, 5, 8, 9, 16, 17, 27, 33, 70])
def test_ell_spmv_every_group_width(dev, K, dtype):
    rng = np.random.default_rng(K)
    n, m = 1000 + K, 777
    cols, vals = _ell(rng, n, m, K, dtype, dev)
    x = torch.as_tensor(rng.standard_normal((D, m)), dtype=dtype, device=dev)
    before = spmv.ell_spmv.launches
    _close(spmv.ell_spmv(cols, vals, x), ref.ell_spmv_ref(cols, vals, x))
    assert spmv.ell_spmv.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,k", [(1, 1), (7, 3), (27, 8), (40, 16)])
def test_ell_spmm(dev, K, k, dtype):
    rng = np.random.default_rng(K * k)
    n, m = 513, 300
    cols, vals = _ell(rng, n, m, K, dtype, dev)
    X = torch.as_tensor(rng.standard_normal((D, m, k)), dtype=dtype, device=dev)
    _close(spmv.ell_spmm(cols, vals, X), ref.ell_spmm_ref(cols, vals, X))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", bcsr.BLOCK_SIZES)
@pytest.mark.parametrize("k", [None, 1, 5, 8])
def test_bcsr(dev, bs, k, dtype):
    rng = np.random.default_rng(bs + (k or 0))
    mb, Kb, m = 37, 5, 29 * bs - 5
    nb = -(-m // bs)
    bcols = rng.integers(0, nb, size=(D, mb, Kb)).astype(np.int32)
    bcols[rng.random((D, mb, Kb)) < 0.25] = -1
    bcols = torch.as_tensor(bcols, device=dev)
    bvals = torch.as_tensor(rng.standard_normal((D, mb, Kb, bs, bs)),
                            dtype=dtype, device=dev)
    x = torch.as_tensor(rng.standard_normal((D, m) + (() if k is None else (k,))),
                        dtype=dtype, device=dev)
    fn = bcsr.bcsr_spmv if k is None else bcsr.bcsr_spmm
    _close(fn(bcols, bvals, x), ref.bcsr_apply_ref(bcols, bvals, x))


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
