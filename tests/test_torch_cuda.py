"""On a CUDA device: each of the port's kernels against its plain PyTorch
version on the same tensors, and IVF-PQ and HNSW on the card against the
same index state on the CPU. Skips without a card (a CUDA kernel has no CPU
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
from vector_db_tpu_torch.ops.cuda.sorted_topk import (
    sorted_topk,
    sorted_topk_plain,
)

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


@pytest.mark.parametrize("b,n_cols,topk,dtype,presorted,ties", [
    (1, 100, 10, torch.float32, 0, False),          # B = 1
    (7, 1003, 999, torch.bfloat16, 0, False),       # n not a power of two
    (5, 9216, 2048, torch.bfloat16, 2048, False),   # the wide-beam shape
    (3, 40000, 3000, torch.float32, 0, False),      # n > 16384, topk > 2048
    (2, 70000, 8192, torch.bfloat16, 0, False),     # three rounds of slices
    (6, 5000, 2500, torch.bfloat16, 0, True),       # many equal keys
    (4, 4097, 4097, torch.float32, 0, True)])
def test_sorted_topk_kernel_matches_plain(cuda, b, n_cols, topk, dtype,
                                          presorted, ties):
    """The kernel's order is total (key, then column): keys and payloads
    equal the plain stable sort's exactly."""
    g = torch.Generator(device=cuda).manual_seed(b * n_cols)
    d = torch.randn(b, n_cols, generator=g, device=cuda)
    if ties:
        d = (d * 4).round()
    if presorted:
        d[:, :presorted] = d[:, :presorted].sort(dim=1).values
    d = d.to(dtype)
    d[:, 1::7] = 3.0e38
    v = torch.randint(0, 1 << 30, (b, n_cols), generator=g, device=cuda,
                      dtype=torch.int32)
    before = sorted_topk.launches
    got = sorted_topk(d, v, topk, presorted=presorted)
    torch.cuda.synchronize()
    assert sorted_topk.launches > before
    assert sorted_topk.launches == before + 1 or n_cols > 16384
    want = sorted_topk_plain(d, v, topk)
    assert got[0].dtype == dtype
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sorted_topk_rejects_what_the_kernel_does_not_take(cuda):
    d = torch.zeros((2, 20000), device=cuda)
    v = torch.zeros((2, 20000), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="8192"):
        sorted_topk(d, v, 8193)
    with pytest.raises(ValueError, match="not CUDA"):
        sorted_topk(d, v.cpu(), 10)
    with pytest.raises(ValueError, match="dtype"):
        sorted_topk(d.half(), v, 10)


def test_hnsw_on_cuda_matches_cpu(cuda):
    """One HNSW state on both devices: classic and wide-beam search (the
    merge through the kernel) reach the same recall."""
    import random

    from vector_db_tpu_torch.index.hnsw import HNSW

    rng = np.random.default_rng(9)
    x = rng.standard_normal((4000, 48)).astype(np.float32)
    q = rng.standard_normal((50, 48)).astype(np.float32)
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10]

    def rec(ids):
        return np.mean([len(set(a) & set(b)) / 10
                        for a, b in zip(ids.tolist(), gt.tolist())])

    cpu = HNSW(M=8, ef_construction=100, rng=random.Random(42),
               capacity=4000, l_max=4, device="cpu")
    cpu.bulk_build(range(4000), x)
    gpu = HNSW(M=8, ef_construction=100, rng=random.Random(42), l_max=4,
               device=cuda)
    gpu.load_state(cpu.graph.neighbors.numpy(), cpu.graph.levels.numpy(),
                   cpu.graph.entry, cpu.graph.entry_level,
                   cpu._store.emb.numpy(), cpu._store.valid.numpy(),
                   cpu._store.export_id_map())
    for idx in (cpu, gpu):
        idx.enable_wide(dims=None, seeds=512)
    for kw in (dict(ef=64), dict(ef=100, filter_ids=set(range(0, 4000, 3)))):
        a, b = cpu.search_batch(q, 10, **kw), gpu.search_batch(q, 10, **kw)
        if "filter_ids" in kw:
            assert (b[1] % 3 == 0).all()
        else:
            assert abs(rec(a[1]) - rec(b[1])) <= 0.01
    before = sorted_topk.launches
    a = cpu.search_batch_wide(q, k=10, ef=256, frontier=32, steps=10,
                              merge_kernel=True)
    b = gpu.search_batch_wide(q, k=10, ef=256, frontier=32, steps=10,
                              merge_kernel=True)
    assert sorted_topk.launches == before + 10
    assert abs(rec(a[1]) - rec(b[1])) <= 0.01
    c = gpu.search_batch_wide(q, k=10, ef=256, frontier=32, steps=10)
    np.testing.assert_array_equal(b[1], c[1])


def test_build_repeats_exactly_on_cuda(cuda, monkeypatch):
    """k-means and the clustered bulk build give the same bits in two runs
    on the card (the M-step adds in a fixed order, not with atomics)."""
    import random

    import vector_db_tpu_torch.index.hnsw as hnsw
    from vector_db_tpu_torch.ops.kmeans import kmeans

    rng = np.random.default_rng(3)
    x = rng.standard_normal((20000, 64)).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda)
    runs = [kmeans(xd, 128, torch.Generator().manual_seed(0), iters=5)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    monkeypatch.setattr(hnsw, "BULK_EXACT_THRESHOLD", 4000)
    graphs = []
    for _ in range(2):
        idx = hnsw.HNSW(M=8, ef_construction=100, rng=random.Random(42),
                        capacity=20000, l_max=4, device=cuda)
        idx.bulk_build(range(20000), x)
        graphs.append(idx.graph.neighbors)
    assert torch.equal(graphs[0], graphs[1])
