"""The six ported ops/exact.py functions against the JAX package on the same
numpy inputs. The Pallas phase-1 kernels run as the JAX tests run them on
the CPU (interpret mode). f32 tolerance rtol 1e-5, atol 1e-5; ids equal
except between tied values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_topk_parity, n, recall, t
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.ops import exact as jx
from vector_db_tpu_torch.ops import exact as px

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _low_rank(seed, nrows, dim, b, rank=24, noise=0.01):
    """Corpus and queries near a rank-``rank`` subspace: the mirror-scored
    scans see well-separated neighbours, as on embedding corpora."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rank, dim)).astype(np.float32)
    x = (rng.standard_normal((nrows, rank)).astype(np.float32) @ a
         + noise * rng.standard_normal((nrows, dim)).astype(np.float32))
    q = (rng.standard_normal((b, rank)).astype(np.float32) @ a
         + noise * rng.standard_normal((b, dim)).astype(np.float32))
    valid = np.ones(nrows, bool)
    valid[::11] = False
    return x, q, valid


def _pca_mirror(x, ds):
    """Projection, bf16 table and f32 norms, built once in numpy and handed
    to both packages."""
    cov = x.T.astype(np.float64) @ x / x.shape[0]
    _, v = np.linalg.eigh(cov)
    proj = np.ascontiguousarray(v[:, ::-1][:, :ds], np.float32)
    tab = (x @ proj).astype(jnp.bfloat16)
    return proj, tab, (x * x).sum(-1)


@pytest.mark.parametrize("nrows,dim,b,k", [(300, 16, 4, 5),
                                           (2000, 64, 16, 10)])
def test_exact_search(nrows, dim, b, k):
    x, q, valid = _low_rank(0, nrows, dim, b, rank=dim)
    got = px.exact_search(t(q), t(x), t(valid), k)
    want = jx.exact_search(jnp.asarray(q), jnp.asarray(x),
                           jnp.asarray(valid), k)
    assert_topk_parity(*got, *want)


@pytest.mark.parametrize("tile", [256, 1000, 4096])
def test_exact_search_tiled(tile):
    x, q, valid = _low_rank(1, 3000, 48, 12, rank=48)
    got = px.exact_search_tiled(t(q), t(x), t(valid), 10, tile=tile)
    want = jx.exact_search_tiled(jnp.asarray(q), jnp.asarray(x),
                                 jnp.asarray(valid), 10, tile=tile)
    assert_topk_parity(*got, *want)


def test_approx_search_tiled_bf16():
    """bf16 table: on the CPU the JAX approx_min_k selects exactly, so ids
    agree up to ties; recall against f32 exact is at least JAX's."""
    x, q, valid = _low_rank(2, 4096, 64, 32, noise=0.05)
    x16 = x.astype(jnp.bfloat16)
    x_sq = (x * x).sum(-1)
    got = px.approx_search_tiled(t(q), t(x).bfloat16(), t(valid), 10,
                                 tile=1024, x_sq=t(x_sq))
    want = jx.approx_search_tiled(jnp.asarray(q), jnp.asarray(x16),
                                  jnp.asarray(valid), 10, tile=1024,
                                  x_sq=jnp.asarray(x_sq))
    assert_topk_parity(*got, *want, atol=1e-4)
    _, truth = jx.exact_search(jnp.asarray(q), jnp.asarray(x),
                               jnp.asarray(valid), 10)
    assert recall(got[1], truth) >= recall(want[1], truth)


def test_rescore_exact():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 32)).astype(np.float32)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    cand = rng.integers(0, 500, (6, 12)).astype(np.int32)
    cand[:, -3:] = -1
    got = px.rescore_exact(t(q), t(x), t(cand))
    want = jx.rescore_exact(jnp.asarray(q), jnp.asarray(x),
                            jnp.asarray(cand))
    assert got[1].dtype == torch.int32
    np.testing.assert_allclose(n(got[0]), n(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(got[1]), n(want[1]))


@pytest.mark.parametrize("nrows,ds,k,blocks_k,rows_k", [
    (2048, 32, 5, 0, 0),
    (3000, 64, 10, 20, 80),     # N not a multiple of 128
])
def test_block_select_search_3p(nrows, ds, k, blocks_k, rows_k):
    x, q, valid = _low_rank(4, nrows, 64, 16)
    proj, tab, x_sq = _pca_mirror(x, ds)
    qp = q @ proj
    got = px.block_select_search_3p(
        t(q), t(tab.astype(np.float32)).bfloat16(), t(qp), t(x_sq), t(x),
        t(valid), k, blocks_k=blocks_k, rows_k=rows_k)
    want = jx.block_select_search_3p(
        jnp.asarray(q), jnp.asarray(tab), jnp.asarray(qp),
        jnp.asarray(x_sq), jnp.asarray(x), jnp.asarray(valid), k,
        tile=1024, blocks_k=blocks_k, rows_k=rows_k, pallas_phase1=True,
        p1_tile=1024, p1_qtile=64)
    assert_topk_parity(*got, *want)


@pytest.mark.parametrize("nrows,m,rows_k", [(2048, 4, 64), (3000, 2, 0)])
def test_block_select_search_2p(nrows, m, rows_k):
    x, q, valid = _low_rank(5, nrows, 64, 16)
    proj, tab, x_sq = _pca_mirror(x, 32)
    qp = q @ proj
    got = px.block_select_search_2p(
        t(q), t(tab.astype(np.float32)).bfloat16(), t(qp), t(x_sq), t(x),
        t(valid), 5, m=m, rows_k=rows_k)
    want = jx.block_select_search_2p(
        jnp.asarray(q), jnp.asarray(tab), jnp.asarray(qp),
        jnp.asarray(x_sq), jnp.asarray(x), jnp.asarray(valid), 5, m=m,
        rows_k=rows_k, p1_tile=1024, p1_qtile=64)
    assert_topk_parity(*got, *want)


def test_block_select_never_returns_invalid_rows():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2048, 32)).astype(np.float32)
    q = x[:8] + 0.01  # queries next to deleted rows
    valid = np.arange(2048) % 2 == 1
    x_sq = (x * x).sum(-1)
    tab = t(x).bfloat16()
    for fn in (px.block_select_search_2p, px.block_select_search_3p):
        _, ids = fn(t(q), tab, t(q), t(x_sq), t(x), t(valid), 10)
        ids = n(ids)
        assert ((ids == -1) | (ids % 2 == 1)).all() and (ids >= 0).any()


def test_block_select_search_approx_blocks_selects_exactly():
    """``approx_blocks=True``: the port selects the blocks exactly (no
    ``approx_min_k`` on the card), so its answer equals the one without the
    flag, and its recall against f32 exact is at or above the JAX
    function's with ``approx_blocks=True`` on the same corpus."""
    x, q, valid = _low_rank(8, 4096, 64, 32, noise=0.05)
    x_sq = (x * x).sum(-1)
    tab = x.astype(jnp.bfloat16)
    args = (t(q), t(tab.astype(np.float32)).bfloat16(), t(q), t(x_sq), t(x),
            t(valid), 10)
    got = px.block_select_search(*args, tile=1024, blocks_k=10,
                                 approx_blocks=True)
    plain = px.block_select_search(*args, tile=1024, blocks_k=10)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    want = jx.block_select_search(
        jnp.asarray(q), jnp.asarray(tab), jnp.asarray(q), jnp.asarray(x_sq),
        jnp.asarray(x), jnp.asarray(valid), 10, tile=1024, blocks_k=10,
        approx_blocks=True)
    _, truth = jx.exact_search(jnp.asarray(q), jnp.asarray(x),
                               jnp.asarray(valid), 10)
    assert recall(got[1], truth) >= recall(want[1], truth)
