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
                                           (300, 32, 5, 256),
                                           (3000, 100, 33, 10)])
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


def _terms(q, x_sq):
    """Per query: the size of the terms a distance is the difference of."""
    return ((q * q).sum(-1) + x_sq.max()).cpu().numpy()


@pytest.mark.parametrize("k", [1, 10, 64, 65, 200, 256])
@pytest.mark.parametrize("dim", [128, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_topk_kernel_widths(cuda, dtype, dim, k):
    """Every query group (k picks 128, 64 or 32 queries per CTA), B and N off
    the 128-row tile and the query group, invalid and duplicate rows."""
    rng = np.random.default_rng(k + dim)
    nrows, b = 4096 + 77, 130
    x = _tensor(rng, (nrows, dim), cuda)
    x[1:5] = x[0]
    valid = torch.ones(nrows, dtype=torch.bool, device=cuda)
    valid[::9] = False
    q = _tensor(rng, (b, dim), cuda)
    q[0] = x[0]                        # a zero distance: term-scale error
    x_sq = (x * x).sum(-1)
    tab = x.to(dtype)
    got = l2_topk(q, tab, valid, k, x_sq=x_sq)
    want = l2_topk_plain(q, tab, valid, k, x_sq)
    assert_topk_parity(*got, *want, rtol=1e-5, atol=1e-4,
                       scale=_terms(q, x_sq))


@pytest.mark.parametrize("b", [3, 130])   # lists in shared memory, registers
@pytest.mark.parametrize("k", [2, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_topk_lower_row_wins_ties(cuda, dtype, k, b):
    """Copies of one row in different tiles and corpus splits score the
    same bits; the lower rows come first, and a cut inside the run keeps
    the lowest."""
    rng = np.random.default_rng(11)
    nrows = 40000
    x = _tensor(rng, (nrows, 96), cuda)
    copies = [7, 200, 300, 9000, 21000, 39999]  # tiles 0, 1; then splits
    x[copies] = x[copies[0]].clone()
    q = x[copies[0]][None].repeat(b, 1).clone()
    valid = torch.ones(nrows, dtype=torch.bool, device=cuda)
    _, ids = l2_topk(q, x.to(dtype), valid, k, x_sq=(x * x).sum(-1))
    run = min(k, len(copies))
    assert n(ids)[:, :run].tolist() == [copies[:run]] * b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_topk_invalid_rows(cuda, dtype):
    """No valid row: all (BIG, -1); fewer valid rows than k: the live ones,
    then the pad."""
    rng = np.random.default_rng(12)
    x = _tensor(rng, (3000, 64), cuda)
    q = _tensor(rng, (5, 64), cuda)
    valid = torch.zeros(3000, dtype=torch.bool, device=cuda)
    tab, x_sq = x.to(dtype), (x * x).sum(-1)
    d, i = l2_topk(q, tab, valid, 10, x_sq=x_sq)
    assert (n(d) >= 3e38).all() and (n(i) == -1).all()
    valid[[4, 700, 2999]] = True
    d, i = l2_topk(q, tab, valid, 10, x_sq=x_sq)
    assert sorted(n(i)[0, :3].tolist()) == [4, 700, 2999]
    assert (n(i)[:, 3:] == -1).all() and (n(d)[:, 3:] >= 3e38).all()


def test_l2_topk_f32_within_float64_bound(cuda):
    """The f32 table through 3xTF32: every returned row lies within
    (1 + 1e-5) of the float64 k-th distance, on unnormalised rows with
    large norms."""
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((20000 + 64, 768)) * 30 + 5).astype(np.float32)
    x, q = x[:20000], x[20000:]
    xd = torch.from_numpy(x).to(cuda)
    _, ids = l2_topk(torch.from_numpy(q).to(cuda), xd,
                     torch.ones(20000, dtype=torch.bool, device=cuda), 10,
                     x_sq=(xd * xd).sum(-1))
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    d64 = np.sqrt(np.maximum((q64 * q64).sum(1)[:, None] - 2 * q64 @ x64.T
                             + (x64 * x64).sum(1)[None], 0))
    kth = np.sort(d64, axis=1)[:, 9]
    assert (np.take_along_axis(d64, n(ids).astype(np.int64), axis=1)
            <= (1 + 1e-5) * kth[:, None]).all()


def _block_terms(q, tab, xsq):
    """Per output row (query, block): max |xsq_eff live| + 2 ||q|| max ||x||.
    The bf16 table's products run on tensor cores, whose sum runs in
    another order than the plain product's, so a score errs relative to
    the size of the terms it is the sum of, not to itself."""
    live = xsq[xsq < 1e37]
    top = live.abs().max() if live.numel() else xsq.new_zeros(())
    s = top + 2 * q.norm(dim=1) * tab.float().norm(dim=1).max()
    return np.repeat(n(s), -(-tab.shape[0] // 128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nrows,ds,b,m", [
    (1000, 128, 1, 2),            # the main path's ds and m, B = 1
    (4096 + 70, 200, 70, 4),      # TMA zero-fills past ds = 200
    (300, 32, 5, 1),              # 64-byte rows: element loads
    (4096 + 70, 100, 1000, 16),   # 200-byte rows: element loads; 8 groups
    (1000, 128, 70, 128),         # m = 128: every row of a block
    (300, 200, 1000, 1),
    (4096 + 70, 32, 70, 128),
    (4096 + 70, 128, 1000, 2),
    (1000, 300, 70, 2)])          # bf16 too wide for the tensor-core path
def test_block_kernels_match_plain(cuda, dtype, nrows, ds, b, m):
    rng = np.random.default_rng(5)
    tab = _tensor(rng, (nrows, ds), cuda)
    tab[1:200] = tab[0]                # one block of equal rows: first match
    tab[[131, 194, 255]] = tab[3].clone()  # other threads and quads of a block
    xsq = torch.from_numpy((rng.random(nrows) * 10).astype(np.float32)).to(
        cuda)
    xsq[1:200] = xsq[0]
    xsq[[131, 194, 255]] = xsq[3].clone()
    xsq[::13] = 2e38                   # invalid rows
    q = _tensor(rng, (b, ds), cuda)
    tab = tab.to(dtype)
    before = (block_topm_scan.launches, block_min_scan.launches)
    vals, rows = block_topm_scan(q, tab, xsq, m=m)
    mins = block_min_scan(q, tab, xsq)
    torch.cuda.synchronize()
    assert (block_topm_scan.launches, block_min_scan.launches) == (
        before[0] + 1, before[1] + 1)
    mw = min(m + 1, 128)  # the next value too: near-ties at the m-th place
    pv, pr = block_topm_plain(q, tab, xsq, mw)
    scale = _block_terms(q, tab, xsq)
    assert_topk_parity(n(vals).reshape(-1, m), n(rows).reshape(-1, m),
                       n(pv).reshape(-1, mw), n(pr).reshape(-1, mw),
                       rtol=1e-5, atol=1e-4, scale=scale, extra=mw - m)
    assert_topk_parity(n(mins).reshape(-1, 1), np.zeros((mins.numel(), 1)),
                       n(block_min_plain(q, tab, xsq)).reshape(-1, 1),
                       np.zeros((mins.numel(), 1)), rtol=1e-5, atol=1e-4,
                       scale=scale)


@pytest.mark.parametrize("b", [3, 130])   # one query group, two
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_topm_lower_row_wins_ties(cuda, dtype, b):
    """Copies of one row are the best rows of their blocks: in one block
    they land in different threads and quads (rows 3, 66, 127) and come out
    in row order with equal values; copies in other blocks (and so other
    CTAs) score the same value."""
    rng = np.random.default_rng(14)
    nrows, m = 4096 + 70, 4
    x = _tensor(rng, (nrows, 128), cuda)
    copies = [3, 66, 127, 130, 255, 1000, 3000, 4100]
    x[copies] = x[copies[0]].clone()
    xsq = torch.full((nrows,), 1e4, device=cuda)
    xsq[copies] = 0.0
    q = _tensor(rng, (b, 128), cuda)
    vals, rows = block_topm_scan(q, x.to(dtype), xsq, m=m)
    vals, rows = n(vals).reshape(b, -1, m), n(rows).reshape(b, -1, m)
    assert (rows[:, 0, :3] == [3, 66, 127]).all()
    assert (rows[:, 1, :2] == [130, 255]).all()
    assert (rows[:, [7, 23, 32], 0] == [1000, 3000, 4100]).all()
    assert (vals[:, 0, :3] == vals[:, 0, :1]).all()
    assert (vals[:, 1, :2] == vals[:, 0, :1]).all()
    np.testing.assert_allclose(vals[:, [7, 23, 32], 0],
                               np.repeat(vals[:, 0, :1], 3, axis=1),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,p,m,ksub", [(1, 70, 4, 16), (64, 7824, 16, 256),
                                         (5, 333, 8, 256), (3, 100, 6, 16),
                                         (4, 501, 32, 256), (2, 77, 64, 16),
                                         (3, 300, 240, 16),
                                         (2, 150, 200, 256)])
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
                                              (1 << 16, 16, 256, 128, 100),
                                              (3000 + 7, 192, 16, 5, 10),
                                              (3000 + 7, 160, 256, 2, 50)])
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


def _adc_lut(rng, b, m, ksub, dev):
    return torch.from_numpy((rng.standard_normal((b, m, ksub)) ** 2).astype(
        np.float32)).to(dev)


@pytest.mark.parametrize("b,k", [(1, 1), (70, 100), (128, 256)])
@pytest.mark.parametrize("ksub", [16, 256])
@pytest.mark.parametrize("m", [4, 6, 8, 16, 32])   # 6: the generic m
def test_adc_topk_kernel_shapes(cuda, m, ksub, b, k):
    """Every m instantiation (and the generic one), both code widths, B
    off the query group, k from 1 to 256, N off the tile."""
    rng = np.random.default_rng(m * 1000 + ksub + b)
    nrows = 5000 + 77
    lut = _adc_lut(rng, b, m, ksub, cuda)
    codes = torch.from_numpy(rng.integers(0, ksub, (nrows, m))).to(cuda)
    codes[1:6] = codes[0]
    valid = torch.from_numpy(rng.random(nrows) > 0.1).to(cuda)
    for dtype in (torch.uint8, torch.int32):
        got = adc_topk(lut, codes.to(dtype), valid, k)
        torch.cuda.synchronize()
        assert_topk_parity(*got, *adc_topk_plain(lut, codes, valid, k),
                           rtol=1e-5, atol=1e-4)


def test_adc_topk_all_rows_invalid(cuda):
    rng = np.random.default_rng(11)
    lut = _adc_lut(rng, 9, 16, 256, cuda)
    codes = torch.from_numpy(rng.integers(0, 256, (3000, 16)).astype(
        np.uint8)).to(cuda)
    d, i = adc_topk(lut, codes, torch.zeros(3000, dtype=torch.bool,
                                            device=cuda), 100)
    assert (n(d) >= 3e38).all() and (n(i) == -1).all()


@pytest.mark.parametrize("ksub", [16, 256])
def test_adc_topk_out_of_range_codes_clamp(cuda, ksub):
    """int32 codes below 0 or at/above ksub clamp (never wrap): the result
    of the clamped uint8 table, bit for bit; uint8 codes at/above ksub read
    entry ksub - 1 as well."""
    rng = np.random.default_rng(12)
    lut = _adc_lut(rng, 70, 8, ksub, cuda)
    raw = rng.integers(-300, ksub + 300, (20000 + 5, 8)).astype(np.int32)
    clamped = torch.from_numpy(np.clip(raw, 0, ksub - 1).astype(
        np.uint8)).to(cuda)
    valid = torch.from_numpy(rng.random(raw.shape[0]) > 0.1).to(cuda)
    want = adc_topk(lut, clamped, valid, 50)
    got = adc_topk(lut, torch.from_numpy(raw).to(cuda), valid, 50)
    assert_topk_parity(*got, *want, rtol=0, atol=0)
    assert_topk_parity(*got, *adc_topk_plain(lut, clamped, valid, 50),
                       rtol=1e-5, atol=1e-4)
    if ksub < 256:
        wide = torch.from_numpy(np.clip(raw, 0, 255).astype(np.uint8)).to(
            cuda)
        assert_topk_parity(*adc_topk(lut, wide, valid, 50),
                           *adc_topk_plain(lut, wide, valid, 50),
                           rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b", [3, 128])
@pytest.mark.parametrize("k", [2, 10])
def test_adc_topk_lower_row_wins_ties(cuda, k, b):
    """Copies of the best row in one warp, in other tiles and in other
    corpus splits: equal values come out in row order."""
    rng = np.random.default_rng(13)
    nrows = 300000
    lut = _adc_lut(rng, b, 16, 256, cuda) + 1.0
    lut[:, :, 0] = 0.0                  # code 0 in every subspace: distance 0
    codes = torch.from_numpy(rng.integers(1, 256, (nrows, 16)).astype(
        np.uint8)).to(cuda)
    copies = [7, 8, 300, 41000, 150001, nrows - 1]
    codes[copies] = 0
    valid = torch.ones(nrows, dtype=torch.bool, device=cuda)
    d, i = adc_topk(lut, codes, valid, k)
    run = min(k, len(copies))
    assert n(i)[:, :run].tolist() == [copies[:run]] * b
    assert (n(d)[:, :run] == 0).all()


def test_adc_topk_unaligned_uint8_codes(cuda):
    """uint8 codes off the 16-byte alignment the bulk copies need go
    through the narrowing pass; the result is the same."""
    rng = np.random.default_rng(14)
    lut = _adc_lut(rng, 5, 16, 256, cuda)
    flat = torch.from_numpy(rng.integers(0, 256, 4000 * 16 + 1).astype(
        np.uint8)).to(cuda)
    codes = flat[1:].view(4000, 16)
    assert codes.data_ptr() % 16
    valid = torch.ones(4000, dtype=torch.bool, device=cuda)
    assert_topk_parity(*adc_topk(lut, codes, valid, 30),
                       *adc_topk(lut, codes.clone(), valid, 30), rtol=0,
                       atol=0)


def _bias_inputs(rng, b, nrows, m, group, dev):
    """adc_topk inputs as the full-scan IVF-PQ gives them: codes of padded
    cells of ``group`` slots, a live prefix of each cell, a per-row scalar
    and a per-(query, cell) term of mixed sign."""
    lut = _adc_lut(rng, b, m, 256, dev)
    codes = torch.from_numpy(rng.integers(0, 256, (nrows, m)).astype(
        np.uint8)).to(dev)
    cells = -(-nrows // group)
    live = rng.integers(0, group + 1, (cells, 1))
    valid = (np.arange(group)[None] < live).reshape(-1)[:nrows]
    row_bias = _tensor(rng, (nrows,), dev)
    group_bias = 4.0 * _tensor(rng, (b, cells), dev)
    return lut, codes, torch.from_numpy(valid).to(dev), row_bias, group_bias


@pytest.mark.parametrize("terms", ["both", "group", "row"])
@pytest.mark.parametrize("b,nrows,group,k", [
    (5, 3000, 3000, 10),        # one group
    (70, 20000 + 3, 489, 128),  # groups straddling the 512-row tiles
    (128, 1 << 16, 256, 256),   # groups on tile edges, B a multiple of 8
    (3, 7000, 1, 20)])          # a group a row
def test_adc_topk_biased_matches_plain(cuda, terms, b, nrows, group, k):
    rng = np.random.default_rng(b + nrows + group)
    lut, codes, valid, rb, gb = _bias_inputs(rng, b, nrows, 16, group, cuda)
    rb = rb if terms in ("both", "row") else None
    gb = gb if terms in ("both", "group") else None
    before = adc_topk.launches
    got = adc_topk(lut, codes, valid, k, row_bias=rb, group_bias=gb,
                   group=group)
    torch.cuda.synchronize()
    assert adc_topk.launches == before + 1
    want = adc_topk_plain(lut, codes, valid, k + 1, row_bias=rb,
                          group_bias=gb, group=group)
    scale = lut.amax(-1).sum(-1) + (0 if rb is None else rb.abs().max()) + (
        0 if gb is None else gb.abs().amax(-1))
    assert_topk_parity(*got, *want, rtol=1e-5, atol=1e-4, scale=scale,
                       extra=1)


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("b,nrows,k", [
    (1, 30000 + 11, 257),       # one past the lists of l2_topk
    (9, 30000 + 11, 512),       # a CTA of 4 queries (m = 16, ksub = 256)
    (130, 1 << 16, 1024),
    (70, 20000 + 3, 2048),      # the longest list: 2 queries a CTA
    (5, 1500, 2048)])           # k above the valid rows
def test_adc_topk_long_lists_match_plain(cuda, biased, b, nrows, k):
    """k past 256: fewer queries a CTA, longer bitonic merges; the full
    scan's fetch of a top_k above 64 runs here."""
    rng = np.random.default_rng(b + k)
    lut, codes, valid, rb, gb = _bias_inputs(rng, b, nrows, 16, 489, cuda)
    kw = (dict(row_bias=rb, group_bias=gb, group=489) if biased else {})
    before = adc_topk.launches
    got = adc_topk(lut, codes, valid, k, **kw)
    torch.cuda.synchronize()
    assert adc_topk.launches == before + 1
    want = adc_topk_plain(lut, codes, valid, k + 1, **kw)
    scale = lut.amax(-1).sum(-1) + (
        rb.abs().max() + gb.abs().amax(-1) if biased else 0)
    assert_topk_parity(*got, *want, rtol=1e-5, atol=1e-4, scale=scale,
                       extra=1)


def test_adc_topk_lists_past_shared_memory_raise(cuda):
    """m = 200, ksub = 256 holds one query's LUT at k = 256, not beside
    a list of 2048; and no list is longer than 2048."""
    rng = np.random.default_rng(3)
    lut = _adc_lut(rng, 2, 200, 256, cuda)
    codes = torch.zeros((100, 200), dtype=torch.uint8, device=cuda)
    valid = torch.ones(100, dtype=torch.bool, device=cuda)
    adc_topk(lut, codes, valid, 256)
    with pytest.raises(ValueError, match="do not fit"):
        adc_topk(lut, codes, valid, 2048)
    with pytest.raises(ValueError, match="2048"):
        adc_topk(lut, codes, valid, 2049)


def test_ivf_full_scans_answer_at_every_fetch_on_cuda(cuda):
    """On the card each full scan runs its kernel at every fetch: one
    launch up to its lists (adc_topk 2048, the flat RP route's l2_topk
    256), passes past them (2560: two launches of adc_topk; top_k 100,
    fetch 400: two of l2_topk bf16); the answer equals the same index
    state's on the CPU."""
    from vector_db_tpu_torch.index.ivf import IvfIndex

    rng = np.random.default_rng(9)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    cpu = IvfIndex(k=4, device="cpu")
    cpu.build_arrays(range(3000), x, seed=0, iters=5)
    cpu.enable_pq(chunks=8, ksub=16)
    cpu.enable_rp(dims=16)
    gpu = IvfIndex(k=4, device=cuda)
    gpu.load_state(cpu._store.emb.numpy(), cpu._store.valid.numpy(),
                   cpu._store.export_id_map(), cpu.centroids,
                   cpu.inverted_lists,
                   codebooks=cpu._pq.codebooks.numpy(),
                   rotation=None, residual=cpu._pq_residual,
                   codes=cpu._codes_np,
                   sx=cpu._sx_np, rp_proj=cpu._rp_proj,
                   rp_mu=cpu._rp_mu_dev.numpy(), rp_res_ratio=1.0)
    cpu._rp_res_ratio = 1.0            # the flat RP route
    for kw, counter, launches in (
            (dict(pq=True, fetch=2048), "adc", 1),
            (dict(pq=True, fetch=2560), "adc", 2),
            (dict(rp=True, fetch=256), "l2", 1),
            (dict(rp=True, top_k=100), "l2", 2)):   # fetch 400
        kw = {"n_probe": 4, "top_k": 10, **kw}
        before = (adc_topk.launches if counter == "adc"
                  else l2_topk.launches_bf16)
        got = gpu.search_batch(q, **kw)
        after = (adc_topk.launches if counter == "adc"
                 else l2_topk.launches_bf16)
        assert after - before == launches, kw
        assert_topk_parity(*got, *cpu.search_batch(q, **kw), rtol=1e-5,
                           atol=1e-4)


def _start(b, dev):
    """A floor before every row."""
    return (torch.full((b,), -float("inf"), device=dev),
            torch.full((b,), -1, dtype=torch.int32, device=dev))


def _floor(lists, j):
    """Each query's pair at column j: a floor in the values of the scan
    that gave them (the kernel's and the plain version's may differ in the
    last bits, so each is floored at its own)."""
    return lists[0][:, j].contiguous(), lists[1][:, j].contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_topk_floor_matches_plain(cuda, dtype):
    """A floored launch against the floored plain version, the floor at a
    run of tied rows (duplicates) so that it splits the run; then the
    exact scan at k = 600 (three launches of 256, each from the last
    one's final pair) against the plain scan at k."""
    from vector_db_tpu_torch.ops.exact import exact_search

    rng = np.random.default_rng(12)
    x = _tensor(rng, (20000 + 37, 96), cuda)
    x[100:400] = x[7]                      # a run of 301 tied rows
    valid = torch.ones(x.shape[0], dtype=torch.bool, device=cuda)
    valid[::11] = False
    q = x[7:8].repeat(5, 1) + 0.01 * _tensor(rng, (5, 96), cuda)
    x_sq = (x * x).sum(-1)
    tab = x.to(dtype)
    first = l2_topk(q, tab, valid, 256, x_sq=x_sq)
    plain = l2_topk_plain(q, tab, valid, 256, x_sq, after=_start(5, cuda))
    assert torch.equal(first[1], plain[1])   # both in (value, row) order
    before = l2_topk.launches
    got = l2_topk(q, tab, valid, 256, x_sq=x_sq, after=_floor(first, 100))
    assert l2_topk.launches == before + 1
    want = l2_topk_plain(q, tab, valid, 257, x_sq, after=_floor(plain, 100))
    assert_topk_parity(*got, *want, rtol=1e-5, atol=1e-4,
                       scale=_terms(q, x_sq), extra=1)
    assert_topk_parity(*l2_topk(q, tab, valid, 256, x_sq=x_sq,
                                after=_start(5, cuda)), *first, rtol=0,
                       atol=0)
    if dtype == torch.float32:
        before = l2_topk.launches
        got = exact_search(q, x, valid, 600, x_sq=x_sq)
        assert l2_topk.launches == before + 3
        want = l2_topk_plain(q, x, valid, 601, x_sq)
        assert_topk_parity(*got, *want, rtol=1e-5, atol=1e-4,
                           scale=_terms(q, x_sq), extra=1)


@pytest.mark.parametrize("biased", [False, True])
def test_adc_topk_floor_matches_plain(cuda, biased):
    """A floored launch against the floored plain version, the floor split
    by a run of tied rows (the smallest value, so that both scans list
    them first, in row order); then adc_search at top_k 2500 (two launches
    of 2048) against the plain scan at 2500."""
    from vector_db_tpu_torch.index.pq import PQCodec

    rng = np.random.default_rng(14 + biased)
    lut, codes, valid, rb, gb = _bias_inputs(rng, 9, 30000 + 11, 16, 489,
                                             cuda)
    lut[:, :, 0] = 0.0
    codes[200:2600] = 0                  # a run of 2,400 tied rows
    valid[200:2600] = True
    kw = (dict(row_bias=rb, group_bias=gb, group=489) if biased else {})
    if biased:
        rb[200:2600] = rb.min() - 1.0
        kw["group_bias"] = torch.zeros_like(gb)
    first = adc_topk(lut, codes, valid, 2048, **kw)
    plain = adc_topk_plain(lut, codes, valid, 2048, after=_start(9, cuda),
                           **kw)
    assert torch.equal(first[1][:, :1001], plain[1][:, :1001])
    before = adc_topk.launches
    got = adc_topk(lut, codes, valid, 2048, after=_floor(first, 1000), **kw)
    assert adc_topk.launches == before + 1
    want = adc_topk_plain(lut, codes, valid, 2049,
                          after=_floor(plain, 1000), **kw)
    scale = lut.amax(-1).sum(-1) + (rb.abs().max() if biased else 0)
    assert_topk_parity(*got, *want, rtol=1e-5, atol=1e-4, scale=scale,
                       extra=1)
    if not biased:
        codec = PQCodec.from_arrays(rng.standard_normal(
            (16, 256, 2)).astype(np.float32), device=cuda)
        qs = rng.standard_normal((3, 32)).astype(np.float32)
        before = adc_topk.launches
        d, i = codec.adc_search(qs, codes, top_k=2500, valid=valid)
        assert adc_topk.launches == before + 2
        dw, iw = codec.adc_search(qs, codes, top_k=2501, valid=valid,
                                  mode="gather")
        assert_topk_parity(d, i, dw, iw, rtol=1e-5, atol=1e-4,
                           scale=codec.adc_lut(qs).amax(-1).sum(-1), extra=1)


def test_adc_topk_zero_biases_equal_unbiased(cuda):
    """Zero terms leave every value and id as the unbiased scan gives it;
    int32 codes (the narrowing pass) take the terms too."""
    rng = np.random.default_rng(21)
    lut, codes, valid, rb, gb = _bias_inputs(rng, 33, 9000, 16, 300, cuda)
    plain = adc_topk(lut, codes, valid, 64)
    got = adc_topk(lut, codes.int(), valid, 64, row_bias=torch.zeros_like(rb),
                   group_bias=torch.zeros_like(gb), group=300)
    assert_topk_parity(*got, *plain, rtol=0, atol=0)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", [4, 6, 8, 16, 32])
def test_adc_probe_kernel_dead_runs(cuda, m, aligned):
    """Candidates as the padded cell table gives them: each query's P
    slots are 16 cells of 113 (P ragged), live for a random prefix of each
    cell and dead after it; codes at any alignment (off it, m in 4..32
    takes the generic loads)."""
    rng = np.random.default_rng(15 + m)
    b, cells, width, ksub = 7, 16, 113, 256
    p = cells * width
    lut = _adc_lut(rng, b, m, ksub, cuda)
    flat = torch.from_numpy(rng.integers(0, ksub, b * p * m + 1).astype(
        np.uint8)).to(cuda)
    codes = (flat[:-1] if aligned else flat[1:]).view(b, p, m)
    live = rng.integers(0, width + 1, (b, cells, 1))
    valid = torch.from_numpy((np.arange(width)[None, None] < live).reshape(
        b, p)).to(cuda)
    corr = _tensor(rng, (b, p), cuda)
    got = adc_probe_scores(lut, codes, corr, valid)
    torch.cuda.synchronize()
    want = adc_probe_plain(lut, codes, corr, valid)
    scale = (lut.amax(-1).sum(-1) + corr.abs().amax(-1))[:, None]
    assert (n(got)[~n(valid)] >= 3e38).all()
    assert (np.abs(n(got) - n(want))
            <= 1e-4 + 1e-5 * (np.abs(n(want)) + n(scale)))[n(valid)].all()


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ties_across_cut", "all_equal",
                                  "signed_zeros", "big_at_cut", "main_shape",
                                  "max_width"])
def test_sorted_topk_select_edges(cuda, case, dtype):
    """Where the radix select and the cut could go wrong: a run of keys
    equal to the threshold crossing the cut (the lowest columns stay, as in
    the stable sort), a row of one key, +0.0 and -0.0 as one key, BIG
    sentinels at the cut, the wide-beam shape, and the widest row one CTA
    holds."""
    g = torch.Generator(device=cuda).manual_seed(len(case))
    b, n_cols, topk = 6, 9216, 2048
    d = torch.randn(b, n_cols, generator=g, device=cuda)
    if case == "ties_across_cut":
        d = (d * 2).round()            # runs of hundreds of equal keys
    elif case == "all_equal":
        d = torch.full_like(d, 1.5)
    elif case == "signed_zeros":
        zero = torch.zeros_like(d)
        d = torch.where(d > 0, zero, -zero)  # the cut falls in this run
        d[:, ::5] = torch.randn(b, d[:, ::5].shape[1], generator=g,
                                device=cuda)
    elif case == "big_at_cut":
        d[:, :n_cols - topk + 5] = 3.0e38  # the cut falls inside the BIGs
    elif case == "main_shape":
        b = 1024
        d = torch.randn(b, n_cols, generator=g, device=cuda)
    else:
        n_cols, topk = 16384, 8192
        d = torch.randn(b, n_cols, generator=g, device=cuda)
    d = d.to(dtype)
    v = torch.randint(0, 1 << 30, (b, n_cols), generator=g, device=cuda,
                      dtype=torch.int32)
    before = sorted_topk.launches
    got = sorted_topk(d, v, topk)
    torch.cuda.synchronize()
    assert sorted_topk.launches == before + 1
    want = sorted_topk_plain(d, v, topk)
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


def _stream_pair(cuda, x, n0, batches, **kw):
    """The same bulk build (its host branch: identical tables) and
    streamed batches on the CPU and on the card; l2_topk launches per
    batch on the card, and the entry level before each batch."""
    import random

    from vector_db_tpu_torch.index.hnsw import HNSW

    pair, launches, entry_levels = [], [], []
    for dev in ("cpu", cuda):
        idx = HNSW(M=8, ef_construction=kw.get("efc", 100),
                   rng=random.Random(42), capacity=len(x), l_max=4,
                   device=dev)
        idx.construction_mode = kw.get("mode", "exact")
        idx.bulk_build(range(n0), x[:n0])
        for s, e in batches:
            before = l2_topk.launches
            entry_levels.append(idx.graph.entry_level)
            idx.insert_arrays(range(s, e), x[s:e])
            torch.cuda.synchronize()
            launches.append(l2_topk.launches - before)
        pair.append(idx)
    nb = len(batches)
    return pair, launches[nb:], entry_levels[nb:]


@pytest.mark.parametrize("mode", ["exact", "beam"])
def test_hnsw_stream_on_cuda_matches_cpu(cuda, mode):
    """Streamed inserts on the card and on the CPU: equal levels and
    entry, neighbor rows equal as sets on >= 99 % of rows; the exact
    candidates launch l2_topk 1 + (entry level) times a batch (level 0,
    then one gathered table per upper level), the beam none."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3000, 48)).astype(np.float32)
    batches = [(2000, 2256), (2256, 2512), (2512, 3000)]
    (cpu, gpu), launches, entry_levels = _stream_pair(cuda, x, 2000, batches,
                                                      mode=mode)
    np.testing.assert_array_equal(gpu.graph.levels.cpu().numpy(),
                                  cpu.graph.levels.numpy())
    np.testing.assert_array_equal(gpu._levels_host, cpu._levels_host)
    assert (gpu.graph.entry, gpu.graph.entry_level) == (
        cpu.graph.entry, cpu.graph.entry_level)
    a, b = gpu.graph.neighbors.cpu().numpy(), cpu.graph.neighbors.numpy()
    assert np.mean([set(u) == set(v) for u, v in zip(a, b)]) >= 0.99
    want = [1 + e for e in entry_levels] if mode == "exact" else [0] * 3
    assert launches == want
    _, ids = gpu.search_batch(x[2000:2100], 1, ef=64)
    assert (ids[:, 0] == np.arange(2000, 2100)).mean() >= 0.97


@pytest.mark.parametrize("k", [64, 200])
def test_candidate_scan_l2_topk_under_a_level_mask(cuda, k):
    """The insert candidate scan's kernel call: the f32 table under a
    level mask (committed rows of level >= l, batch rows excluded) at
    k = 200 (level 0 at ef_construction 200) and 64 (upper levels), with
    the table's norms passed in; then construction_candidates_exact on the
    card against the CPU."""
    from vector_db_tpu_torch.index import hnsw_kernels as HK

    rng = np.random.default_rng(13)
    nrows, dim, b = 20000, 128, 300
    x = _tensor(rng, (nrows, dim), cuda)
    levels = torch.from_numpy(np.minimum(
        (-np.log(rng.random(nrows)) / np.log(16)).astype(np.int32), 4)).to(
        cuda)
    levels[-b:] = -1                       # the batch: valid, uncommitted
    valid = torch.ones(nrows, dtype=torch.bool, device=cuda)
    valid[::11] = False
    q = x[-b:].clone()
    x_sq = (x * x).sum(-1)
    for level in (0, 1):
        mask = valid & (levels >= level)
        got = l2_topk(q, x, mask, k, x_sq=x_sq)
        want = l2_topk_plain(q, x, mask, k, x_sq)
        assert_topk_parity(*got, *want, rtol=1e-5, atol=1e-4)
    graph = HK.Graph(neighbors=torch.empty(0), levels=levels, entry=0,
                     entry_level=4)
    before = l2_topk.launches
    gd, gs = HK.construction_candidates_exact(graph, x, valid, q, l_max=5,
                                              ef_construction=k, ef_upper=64)
    torch.cuda.synchronize()
    n_upper = int((levels >= 1).any()) + int((levels >= 2).any()) + int(
        (levels >= 3).any()) + int((levels >= 4).any())
    assert l2_topk.launches == before + 1 + n_upper
    cpu_graph = HK.Graph(neighbors=torch.empty(0), levels=levels.cpu(),
                         entry=0, entry_level=4)
    cd, cs = HK.construction_candidates_exact(
        cpu_graph, x.cpu(), valid.cpu(), q.cpu(), l_max=5,
        ef_construction=k, ef_upper=64)
    for lv in range(5):
        assert_topk_parity(gd[:, lv], gs[:, lv], cd[:, lv], cs[:, lv],
                           rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("saver", ["cuda", "cpu"])
def test_hnsw_save_on_one_device_load_on_the_other(cuda, tmp_path, saver):
    import random

    from vector_db_tpu_torch.index.hnsw import HNSW
    from vector_db_tpu_torch.storage import InMemoryNodeStorage
    from vector_db_tpu_torch.types import Node

    rng = np.random.default_rng(14)
    x = rng.standard_normal((1500, 32)).astype(np.float32)
    q = rng.standard_normal((40, 32)).astype(np.float32)
    storage = InMemoryNodeStorage()
    devs = (cuda, "cpu") if saver == "cuda" else ("cpu", cuda)
    src = HNSW(M=8, ef_construction=60, rng=random.Random(1),
               storage=storage, index_file=tmp_path / "g.npz",
               device=devs[0])
    src.bulk_build(range(1000), x[:1000])
    src.insert_nodes([Node(id=i, embedding=x[i]) for i in range(1000, 1500)])
    src.delete_node(3)
    for i in range(1000):       # bulk_build writes no storage
        if i != 3:
            storage.save(Node(id=i, embedding=x[i]))
    src.enable_wide(dims=16, seeds=128)
    src.save_index()
    dst = HNSW(M=4, ef_construction=10, rng=random.Random(0),
               storage=storage, index_file=tmp_path / "g.npz",
               device=devs[1])
    assert dst.size == 1499 and dst.recover_unlinked() == 0
    assert torch.equal(dst.graph.neighbors.cpu(), src.graph.neighbors.cpu())
    assert torch.equal(dst.graph.levels.cpu(), src.graph.levels.cpu())
    assert (dst.graph.entry, dst.graph.entry_level) == (
        src.graph.entry, src.graph.entry_level)
    assert torch.equal(dst._wb_proj.cpu(), src._wb_proj.cpu())
    # one graph, two devices' f32 sums: ids as sets, near-ties may swap
    a, b = dst.search_batch(q, 10, ef=64)[1], src.search_batch(q, 10, ef=64)[1]
    assert np.mean([set(u) == set(v) for u, v in zip(a, b)]) >= 0.95


def _svc_config(tmp_path, **index):
    import yaml

    cfg = {"embedding": {"model": "fake-32", "dimension": 32},
           "device": "cuda",
           "index": {"M": 8, "ef_construction": 64, "flush_threshold": 1000,
                     **index},
           "vector_db": {"file_path": str(tmp_path / "vdb"), "dimension": 32,
                         "capacity": 8192}}
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def _same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_hnsw_service_routes_on_cuda(cuda, tmp_path):
    """The hnsw service with device: cuda: the bulk route, a streamed
    batch, then the scan, wide (merge_kernel auto: on), filtered and
    single-query routes, each equal to the direct index call, and the
    scan's exact mode equal to the same table's scan on the CPU."""
    import random

    from vector_db_tpu_torch.datasets import embedding_like
    from vector_db_tpu_torch.index.hnsw import HNSW
    from vector_db_tpu_torch.services.indexing_service import IndexingService
    from vector_db_tpu_torch.services.storage_service import StorageService
    from vector_db_tpu_torch.types import Node

    x = embedding_like(6000 + 300, 32, seed=4)
    q = np.ascontiguousarray(x[6000:])
    nodes = [Node(id=i, embedding=x[i], metadata={"t": i % 4})
             for i in range(6000)]
    cfg = _svc_config(tmp_path, scan_batch_threshold=128,
                      wide={"dims": 0, "seeds": 256, "min_size": 1024,
                            "merge_kernel": "auto"})
    st = StorageService(str(tmp_path / "vdb"), dim=32, capacity=8192)
    svc = IndexingService(storage=st.storage, config_path=cfg)
    assert svc.index.device.type == "cuda" and svc._resolve_merge_kernel()
    st.save_many(nodes[:5000])
    svc.insert_nodes(nodes[:5000])            # the bulk route
    l2_topk.launches = l2_topk.launches_bf16 = sorted_topk.launches = 0
    st.save_many(nodes[5000:])
    svc.insert_nodes(nodes[5000:])            # streamed
    assert l2_topk.launches > 0
    idx = svc.index
    _same(svc.search_batch(q, 10), idx.search_batch_scan(q, 10))
    assert l2_topk.launches_bf16 > 0
    _same(svc.search_batch(q[:16], 10),
          idx.search_batch_wide(q[:16], 10, ef=200, seen_mask=False,
                                merge_kernel=True))
    assert sorted_topk.launches > 0
    allowed = st.filter_by_metadata({"t": 1})
    got = svc.search_batch(q[:16], 10, filter_ids=allowed)
    _same(got, idx.search_batch_scan(q[:16], 10, filter_ids=allowed))
    assert set(got[1].ravel().tolist()) <= allowed
    res = svc.search(q[0], k=10)
    assert [n.id for n, _ in res] == idx.search_batch_wide(
        q[:1], 10, ef=200, seen_mask=False, merge_kernel=True)[1][0].tolist()
    cpu_idx = HNSW(M=8, ef_construction=64, rng=random.Random(0),
                   device="cpu")
    g = idx.graph
    cpu_idx.load_state(g.neighbors.cpu().numpy(), g.levels.cpu().numpy(),
                       g.entry, g.entry_level, idx._emb.cpu().numpy(),
                       idx._has_emb.cpu().numpy(), idx._id_of_slot)
    d_c, i_c = cpu_idx.search_batch_scan(q, 10, mode="exact")
    d_g, i_g = idx.search_batch_scan(q, 10, mode="exact")
    assert_topk_parity(d_g ** 2, i_g, d_c ** 2, i_c, scale=2.0)


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_flat_and_ivf_services_on_cuda(cuda, tmp_path, kind):
    """The flat (l2_topk) and IVF-PQ (adc_probe) services with device:
    cuda: answers equal to the direct index calls."""
    from vector_db_tpu_torch.datasets import embedding_like
    from vector_db_tpu_torch.services.indexing_service import IndexingService
    from vector_db_tpu_torch.storage import InMemoryNodeStorage
    from vector_db_tpu_torch.types import Node

    x = embedding_like(5000 + 64, 32, seed=5)
    q = np.ascontiguousarray(x[5000:])
    extra = ({"ivf_k": 32, "pq": {"chunks": 8, "min_size": 1024}}
             if kind == "ivf" else {})
    cfg = _svc_config(tmp_path, type=kind, **extra)
    svc = IndexingService(storage=InMemoryNodeStorage(), config_path=cfg,
                          index_file=str(tmp_path / "i.npz"))
    svc.insert_nodes([Node(id=i, embedding=x[i]) for i in range(5000)])
    l2_topk.launches = adc_probe_scores.launches = 0
    got = svc.search_batch(q, 10)
    if kind == "flat":
        _same(got, svc.index.search_batch(q, 10, filter_ids=None))
        assert l2_topk.launches > 0
    else:
        assert svc._pq_active
        _same(got, svc.index.search_batch(q, n_probe=10, top_k=10,
                                          filter_ids=None, pq=True,
                                          adc="pallas"))
        assert adc_probe_scores.launches > 0


def _four_on(dev):
    from vector_db_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[dev] * 4)


def test_sharded_flat_and_ivf_on_cuda_match_cpu(cuda):
    """Four shards on one card against four CPU shards over the same rows:
    the flat index's l2_topk answers equal the plain scan's; the IVF on the
    same centroids returns the same ids (no ties in this corpus)."""
    from vector_db_tpu_torch.parallel import sharded

    rng = np.random.default_rng(11)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((40, 32)).astype(np.float32)
    idx = []
    for dev in (cuda, torch.device("cpu")):
        flat = sharded.ShardedFlatIndex(mesh=_four_on(dev), dim=32,
                                        capacity_per_shard=1024)
        flat.insert(range(3000), x)
        flat.delete(7)
        idx.append(flat)
    before = l2_topk.launches
    dg, ig = idx[0].search_batch(q, 10)
    assert l2_topk.launches == before + 4
    dc, ic = idx[1].search_batch(q, 10)
    assert_topk_parity(dg ** 2, ig, dc ** 2, ic, scale=70.0)
    assert 7 not in ig
    cpu = sharded.ShardedIVF(mesh=_four_on(torch.device("cpu")), dim=32,
                             capacity_per_shard=1024, k_cells=16)
    cpu.build(range(3000), x)
    gpu = sharded.ShardedIVF(mesh=_four_on(cuda), dim=32,
                             capacity_per_shard=1024, k_cells=16)
    gpu.insert(range(3000), x)
    gpu._centroids = [c.to(cuda) for c in cpu._centroids]
    gpu._lists = [t.to(cuda) for t in cpu._lists]
    for n_probe in (2, 16):
        got = gpu.search_batch(q, 10, n_probe=n_probe)
        want = cpu.search_batch(q, 10, n_probe=n_probe)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_sharded_hnsw_on_cuda_matches_cpu(cuda, tmp_path):
    """ShardedHNSW with four shards on one card against four CPU shards:
    bulk_build (knn_exact on l2_topk) and streamed inserts draw the same
    levels and routing; on the CPU graph (saved and loaded on the card) the
    classic, wide (sorted_topk merge) and beam searches return the CPU's
    id sets on >= 95 % of the rows; deletes unlink on both alike."""
    from vector_db_tpu_torch.datasets import embedding_like
    from vector_db_tpu_torch.parallel import sharded

    x = embedding_like(4000 + 64, 32, seed=6)
    q = np.ascontiguousarray(x[4000:])
    built = []
    for dev in (cuda, torch.device("cpu")):
        h = sharded.ShardedHNSW(M=8, ef_construction=64, mesh=_four_on(dev),
                                dim=32, capacity_per_shard=1024)
        h.bulk_build(range(3500), x[:3500])
        h.insert(range(3500, 4000), x[3500:4000])
        built.append(h)
    gs, cs = built[0].host_state(), built[1].host_state()
    np.testing.assert_array_equal(gs["levels"], cs["levels"])
    np.testing.assert_array_equal(built[0]._id_of_gslot,
                                  built[1]._id_of_gslot)
    path = tmp_path / "cpu.npz"
    built[1].save_index(path)
    gpu = sharded.ShardedHNSW(M=8, ef_construction=64, mesh=_four_on(cuda),
                              dim=32, capacity_per_shard=1024)
    gpu.load_index(path)
    cpu = built[1]
    for h in (gpu, cpu):
        h.delete_batch([3, 500, 3999])
        h.enable_wide(dims=None, seeds=128)
    gs, cs = gpu.host_state(), cpu.host_state()
    np.testing.assert_array_equal(gs["neighbors"], cs["neighbors"])
    np.testing.assert_array_equal(gs["entry"], cs["entry"])
    before = sorted_topk.launches
    for call in (lambda h: h.search_batch(q, 10, ef=64),
                 lambda h: h.search_batch_wide(q, 10, ef=128, frontier=32,
                                               steps=8, merge_kernel=True),
                 lambda h: h.search_batch_beam(q, 10, frontier=32,
                                               steps=8)):
        a, b = call(gpu)[1], call(cpu)[1]
        assert np.mean([set(u) == set(v) for u, v in zip(a, b)]) >= 0.95
        assert not {3, 500, 3999} & set(a.ravel().tolist())
    assert sorted_topk.launches > before


def test_autotune_and_sharded_services_on_cuda(cuda, tmp_path):
    """The hnsw service with index.autotune and the sharded-hnsw service
    (one shard a visible card) with device: cuda: calibrated decisions
    for B = 1 and B = 64 whose routed answers meet their targets less
    0.02 against the exact scan, and the sharded service's answers equal
    to its direct index call, after a restart too."""
    from vector_db_tpu_torch.datasets import embedding_like
    from vector_db_tpu_torch.services.indexing_service import IndexingService
    from vector_db_tpu_torch.storage import InMemoryNodeStorage
    from vector_db_tpu_torch.types import Node

    x = embedding_like(6000 + 64, 32, seed=7)
    q = np.ascontiguousarray(x[6000:])
    nodes = [Node(id=i, embedding=x[i]) for i in range(6000)]
    cfg = _svc_config(tmp_path, wide={"dims": 0, "seeds": 256,
                                      "min_size": 1024},
                      autotune={"sample": 64, "k": 10, "min_size": 1024,
                                "ef_ladder": [64, 256]})
    svc = IndexingService(storage=InMemoryNodeStorage(), config_path=cfg,
                          index_file=str(tmp_path / "at.npz"))
    svc.insert_nodes(nodes)
    _, truth = svc.index.search_batch_scan(q, 10, mode="exact")
    got = svc.search_batch(q, 10)
    single = [n.id for n, _ in svc.search(q[0], k=10)]
    decs = svc._autotune._decisions
    assert [key[0] for key in decs] == [64, 8]
    for dec, ids in zip(decs.values(), (got[1], np.asarray([single]))):
        hits = np.mean([len(set(a) & set(b)) / 10
                        for a, b in zip(ids.tolist(), truth.tolist())])
        assert hits >= dec["target"] - 0.02, (dec, hits)
    sh_cfg = str(tmp_path / "sharded.yaml")
    import yaml

    conf = yaml.safe_load(open(cfg))
    conf["index"] = {"M": 8, "ef_construction": 64, "flush_threshold": 1000,
                     "type": "sharded-hnsw"}
    open(sh_cfg, "w").write(yaml.safe_dump(conf))
    storage = InMemoryNodeStorage()
    sh = IndexingService(storage=storage, config_path=sh_cfg,
                         index_file=str(tmp_path / "sh.npz"))
    assert sh.index.n_shards == torch.cuda.device_count()
    for s in range(0, 6000, 2000):
        sh.insert_nodes(nodes[s:s + 2000])
    got = sh.search_batch(q, 10)
    _same(got, sh.index.search_batch(q, 10, ef=50))
    sh.force_save_index()
    again = IndexingService(storage=storage, config_path=sh_cfg,
                            index_file=str(tmp_path / "sh.npz"))
    _same(again.search_batch(q, 10), got)
