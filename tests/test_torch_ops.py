"""vector_db_tpu_torch.ops.distance / ops.topk against the JAX package on
the same numpy inputs (f32 tolerance: rtol 1e-5, atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import ATOL, RTOL, assert_topk_parity, n, t
from vector_db_tpu.ops import distance as jd
from vector_db_tpu.ops import topk as jt
from vector_db_tpu_torch.ops import distance as pd
from vector_db_tpu_torch.ops import topk as pt


def _data(seed, b, nrows, dim, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, dim)) * scale).astype(np.float32)
    x = (rng.standard_normal((nrows, dim)) * scale).astype(np.float32)
    return q, x


def test_sentinels_match():
    assert np.float32(pd.BIG) == jd.BIG


@pytest.mark.parametrize("nrows,dim", [(1, 3), (257, 64), (4096, 128)])
def test_squared_norms(nrows, dim):
    _, x = _data(0, 1, nrows, dim)
    np.testing.assert_allclose(n(pd.squared_norms(t(x))),
                               n(jd.squared_norms(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_squared_norms_chunked(monkeypatch):
    monkeypatch.setattr(pd, "_NORM_CHUNK", 100)
    _, x = _data(1, 1, 1000, 16)
    np.testing.assert_allclose(n(pd.squared_norms(t(x))),
                               (x.astype(np.float64) ** 2).sum(-1),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_xsq", [False, True])
@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_l2_sq_pairwise(with_xsq, scale):
    q, x = _data(2, 16, 700, 64, scale)
    x_sq = (x * x).sum(-1) if with_xsq else None
    got = pd.l2_sq_pairwise(t(q), t(x), None if x_sq is None else t(x_sq))
    want = jd.l2_sq_pairwise(jnp.asarray(q), jnp.asarray(x),
                             None if x_sq is None else jnp.asarray(x_sq))
    assert (n(got) >= 0).all()
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL,
                               atol=ATOL * scale * scale)


def test_l2_sq_pairwise_clamps_self_matches():
    _, x = _data(3, 1, 50, 32, scale=30.0)
    got = n(pd.l2_sq_pairwise(t(x), t(x)))
    want = n(jd.l2_sq_pairwise(jnp.asarray(x), jnp.asarray(x)))
    assert (got >= 0).all()
    np.testing.assert_allclose(np.diag(got), np.diag(want), atol=0.05)


def test_cosine_distance_pairwise():
    q, x = _data(4, 8, 300, 48)
    np.testing.assert_allclose(
        n(pd.cosine_distance_pairwise(t(q), t(x))),
        n(jd.cosine_distance_pairwise(jnp.asarray(q), jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


def test_exact_rows_sq_matches_float64():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((6, 40)).astype(np.float32)
    rows = rng.standard_normal((6, 9, 40)).astype(np.float32)
    want = ((rows.astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(n(pd.exact_rows_sq(t(q), t(rows))), want,
                               rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("k", [1, 5, 32])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_top_k_smallest(k, masked):
    rng = np.random.default_rng(6)
    d = rng.random((12, 64)).astype(np.float32)
    ids = np.arange(64, dtype=np.int32)
    valid = rng.random((12, 64)) < (0.3 if masked else 2.0)
    got = pt.masked_top_k_smallest(t(d), t(ids), k, valid=t(valid))
    want = jt.masked_top_k_smallest(jnp.asarray(d), jnp.asarray(ids), k,
                                    valid=jnp.asarray(valid))
    assert got[1].dtype == torch.int32
    assert_topk_parity(*got, *want)


def test_masked_top_k_pads_with_big_and_minus_one():
    d = np.array([[3.0, 1.0, 2.0, 0.5]], np.float32)
    valid = np.array([[True, False, True, False]])
    got_d, got_i = pt.masked_top_k_smallest(
        t(d), t(np.arange(4, dtype=np.int32)), 3, valid=t(valid))
    assert n(got_i).tolist() == [[2, 0, -1]]
    assert n(got_d)[0, 2] == np.float32(pd.BIG)


def test_merge_top_k():
    rng = np.random.default_rng(7)
    da = np.sort(rng.random((5, 8)).astype(np.float32), axis=1)
    db = np.sort(rng.random((5, 8)).astype(np.float32), axis=1)
    ia = rng.integers(0, 1000, (5, 8)).astype(np.int32)
    ib = rng.integers(1000, 2000, (5, 8)).astype(np.int32)
    got = pt.merge_top_k(t(da), t(ia), t(db), t(ib), 8)
    want = jt.merge_top_k(*(jnp.asarray(a) for a in (da, ia, db, ib)), 8)
    assert_topk_parity(*got, *want)


@pytest.mark.parametrize("kind", ["distinct", "ties", "pads"])
def test_smallest_stable_matches_lax_top_k(kind):
    """ops.topk.smallest_stable: the k smallest with lax.top_k's order
    (ties to the lower position, membership included), on both of its
    paths (no copies of the k-th value past the cut, and copies past it)."""
    import jax

    from vector_db_tpu_torch.ops.topk import smallest_stable

    rng = np.random.default_rng(len(kind))
    hi = {"distinct": 1 << 30, "ties": 6, "pads": 1 << 30}[kind]
    x = rng.integers(0, hi, (9, 257)).astype(np.float32)
    if kind == "pads":
        x[:, rng.integers(0, 257, 200)] = 3e38
    for k in (1, 17, 100, 257):
        v, p = smallest_stable(torch.from_numpy(x), k)
        nv, npos = jax.lax.top_k(-x, k)
        np.testing.assert_array_equal(v.numpy(), -np.asarray(nv))
        np.testing.assert_array_equal(p.numpy(), np.asarray(npos))
