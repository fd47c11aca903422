"""On a CUDA device: each of the port's kernels against its plain PyTorch
version on the same tensors. Skips without a card (a CUDA kernel has no CPU
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


def test_wrappers_reject_cpu_mixed_devices(cuda):
    x = torch.zeros((256, 8), device=cuda)
    with pytest.raises(ValueError, match="not CUDA"):
        l2_topk(x[:2], x, torch.ones(256, dtype=torch.bool), 3,
                x_sq=torch.zeros(256, device=cuda))
