"""On a CUDA device: each of the port's kernels against its plain PyTorch
version on the same tensors, and IVF-PQ on the card against the same index
state on the CPU. Skips without a card (a CUDA kernel has no CPU
mode). The file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: rtol 1e-5, atol 1e-4 (another summation order; bf16 x bf16
products are exact in f32); ids equal wherever values are apart.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import assert_topk_parity, n
from vector_db_tpu_torch.ops.cuda.block_min import (
    block_min_plain,
    block_min_scan,
)
from vector_db_tpu_torch.ops.cuda.block_topm import (
    block_topm_plain,
    block_topm_scan,
)
from vector_db_tpu_torch.ops.cuda.adc_probe import (
    adc_probe_plain,
    adc_probe_scores,
)
from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk, adc_topk_plain
from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk, l2_topk_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tensor(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nrows,dim,b,k", [(1000, 64, 1, 10),
                                           (5000, 200, 70, 100),
                                           (300, 32, 5, 256)])
def test_l2_topk_kernel_matches_plain(cuda, dtype, nrows, dim, b, k):
    rng = np.random.default_rng(4)
    x = _tensor(rng, (nrows, dim), cuda)
    x[1:5] = x[0]                      # duplicate rows: tied values
    valid = torch.ones(nrows, dtype=torch.bool, device=cuda)
    valid[::9] = False
    q = _tensor(rng, (b, dim), cuda)
    x_sq = (x * x).sum(-1)
    tab = x.to(dtype)
    before = l2_topk.launches
    got = l2_topk(q, tab, valid, k, x_sq=x_sq)
    torch.cuda.synchronize()
    assert l2_topk.launches == before + 1
    want = l2_topk_plain(q, tab, valid, k, x_sq)
    assert_topk_parity(*got, *want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nrows,ds,b,m", [(1000, 128, 1, 2),
                                          (4096 + 70, 200, 70, 4)])
def test_block_kernels_match_plain(cuda, dtype, nrows, ds, b, m):
    rng = np.random.default_rng(5)
    tab = _tensor(rng, (nrows, ds), cuda)
    tab[1:200] = tab[0]                # one block of equal rows: first match
    xsq = torch.from_numpy((rng.random(nrows) * 10).astype(np.float32)).to(
        cuda)
    xsq[1:200] = xsq[0]
    xsq[::13] = 2e38                   # invalid rows
    q = _tensor(rng, (b, ds), cuda)
    tab = tab.to(dtype)
    vals, rows = block_topm_scan(q, tab, xsq, m=m)
    mins = block_min_scan(q, tab, xsq)
    torch.cuda.synchronize()
    pv, pr = block_topm_plain(q, tab, xsq, m)
    assert_topk_parity(n(vals).reshape(-1, m), n(rows).reshape(-1, m),
                       n(pv).reshape(-1, m), n(pr).reshape(-1, m),
                       rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(n(mins), n(block_min_plain(q, tab, xsq)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,p,m,ksub", [(1, 70, 4, 16), (64, 7824, 16, 256),
                                         (5, 333, 8, 256), (3, 100, 6, 16)])
def test_adc_probe_kernel_matches_plain(cuda, b, p, m, ksub):
    rng = np.random.default_rng(6)
    lut = torch.from_numpy((rng.standard_normal((b, m, ksub)) ** 2).astype(
        np.float32)).to(cuda)
    codes = torch.from_numpy(rng.integers(0, ksub, (b, p, m)).astype(
        np.uint8)).to(cuda)
    codes[:, 1] = codes[:, 0]          # duplicate candidates tie
    corr = _tensor(rng, (b, p), cuda)
    valid = torch.from_numpy(rng.random((b, p)) > 0.2).to(cuda)
    before = adc_probe_scores.launches
    got = adc_probe_scores(lut, codes, corr, valid)
    torch.cuda.synchronize()
    assert adc_probe_scores.launches == before + 1
    np.testing.assert_allclose(n(got), n(adc_probe_plain(lut, codes, corr,
                                                         valid)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("code_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("nrows,m,ksub,b,k", [(1000, 16, 256, 1, 10),
                                              (5000 + 70, 8, 16, 70, 100),
                                              (300, 4, 16, 5, 256),
                                              (1 << 16, 16, 256, 128, 100)])
def test_adc_topk_kernel_matches_plain(cuda, code_dtype, nrows, m, ksub, b,
                                       k):
    rng = np.random.default_rng(7)
    lut = torch.from_numpy((rng.standard_normal((b, m, ksub)) ** 2).astype(
        np.float32)).to(cuda)
    codes = torch.from_numpy(rng.integers(0, ksub, (nrows, m))).to(
        code_dtype).to(cuda)
    codes[1:6] = codes[0]              # duplicate rows tie
    valid = torch.ones(nrows, dtype=torch.bool, device=cuda)
    valid[::9] = False
    if nrows == 300:
        valid[200:] = False            # k above the valid rows
    before = adc_topk.launches
    got = adc_topk(lut, codes, valid, k)
    torch.cuda.synchronize()
    assert adc_topk.launches == before + 1
    want = adc_topk_plain(lut, codes, valid, k)
    assert_topk_parity(*got, *want, rtol=1e-5, atol=1e-4)


def test_adc_kernels_empty_inputs_launch_nothing(cuda):
    lut = torch.rand((3, 4, 16), device=cuda)
    before = (adc_topk.launches, adc_probe_scores.launches)
    d, i = adc_topk(lut, torch.zeros((0, 4), dtype=torch.uint8, device=cuda),
                    torch.zeros(0, dtype=torch.bool, device=cuda), 5)
    assert (n(d) >= 3e38).all() and (n(i) == -1).all() and d.shape == (3, 5)
    out = adc_probe_scores(lut, torch.zeros((3, 0, 4), dtype=torch.uint8,
                                            device=cuda),
                           torch.zeros((3, 0), device=cuda),
                           torch.zeros((3, 0), dtype=torch.bool, device=cuda))
    assert out.shape == (3, 0)
    assert (adc_topk.launches, adc_probe_scores.launches) == before


def test_ivf_pq_on_cuda_matches_cpu(cuda):
    """One IVF-PQ state on both devices: the kernels' answers equal the
    plain versions' after the exact rerank."""
    from vector_db_tpu_torch.index.ivf import IvfIndex

    rng = np.random.default_rng(8)
    x = rng.standard_normal((4000, 32)).astype(np.float32)
    q = rng.standard_normal((20, 32)).astype(np.float32)
    cpu = IvfIndex(k=32, device="cpu")
    cpu.build_arrays(range(4000), x, seed=0, iters=10)
    cpu.enable_pq(chunks=8, ksub=64, opq_iters=2)
    gpu = IvfIndex(k=32, device=cuda)
    gpu.load_state(cpu._store.emb.numpy(), cpu._store.valid.numpy(),
                   cpu._store.export_id_map(), cpu.centroids,
                   cpu.inverted_lists,
                   codebooks=cpu._pq.codebooks.numpy(),
                   rotation=cpu._pq.rotation.numpy(), residual=True,
                   codes=cpu._codes_np, sx=cpu._sx_np)
    before = adc_probe_scores.launches
    for pq in (False, True):
        got = gpu.search_batch(q, n_probe=8, top_k=10, pq=pq)
        want = cpu.search_batch(q, n_probe=8, top_k=10, pq=pq)
        assert_topk_parity(*got, *want, rtol=1e-5, atol=1e-4)
    assert adc_probe_scores.launches > before


def test_wrappers_reject_cpu_mixed_devices(cuda):
    x = torch.zeros((256, 8), device=cuda)
    with pytest.raises(ValueError, match="not CUDA"):
        l2_topk(x[:2], x, torch.ones(256, dtype=torch.bool), 3,
                x_sq=torch.zeros(256, device=cuda))
    lut = torch.zeros((2, 4, 16), device=cuda)
    with pytest.raises(ValueError, match="not CUDA"):
        adc_topk(lut, torch.zeros((8, 4), dtype=torch.uint8), torch.ones(
            8, dtype=torch.bool, device=cuda), 3)
    with pytest.raises(ValueError, match="uint8"):
        adc_probe_scores(lut, torch.zeros((2, 5, 4), dtype=torch.int32,
                                          device=cuda),
                         torch.zeros((2, 5), device=cuda),
                         torch.ones((2, 5), dtype=torch.bool, device=cuda))
