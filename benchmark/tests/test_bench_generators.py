"""The benchmark's generators draw from the same distributions as the
port's ``datasets`` recipes (not the same bytes): row norms, spectrum and,
for the SIFT shape, value statistics and cluster structure."""

import numpy as np
import pytest
import torch

from benchmark.generators import embedding_like, sift_like
from vector_db_tpu_torch import datasets


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(mod, rows, queries, dim, params, seed):
    gen = torch.Generator().manual_seed(seed)
    src = mod.make(dim, params, gen, torch.device("cpu"))
    x = src.rows(rows)
    return x.numpy(), src.rows(queries).numpy()


def _spectrum(x):
    s = np.linalg.svd(x - x.mean(0), compute_uv=False) ** 2
    return np.cumsum(s) / s.sum()


def _nn_ratio(x, q):
    """Mean distance of each query to its nearest corpus row over the
    median distance: small where the rows cluster."""
    d = np.sqrt(np.maximum((q * q).sum(1)[:, None] + (x * x).sum(1)[None]
                           - 2 * q @ x.T, 0))
    return d.min(1).mean() / np.median(d)


def test_embedding_like_matches_the_port():
    ours, q = _draw(embedding_like, 4000, 200, 256,
                    {"intrinsic": 64, "noise": 0.05}, 11)
    port = datasets.embedding_like(4200, 256, seed=11)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1, atol=1e-5)
    a, b = _spectrum(ours), _spectrum(port[:4000])
    # the rank-64 mixing holds nearly all the energy, the noise the rest
    assert abs(a[63] - b[63]) < 0.01 and a[63] > 0.9
    assert abs(a[31] - b[31]) < 0.03
    assert abs(_nn_ratio(ours, q) - _nn_ratio(port[:4000], port[4000:])) \
        < 0.03


def test_sift_like_matches_the_port():
    params = {"clusters": 1024, "directions": 12, "floor": 4.0}
    ours, q = _draw(sift_like, 20000, 300, 128, params, 7)
    port, pq = datasets.sift_like(20000, 128, seed=7, queries=300)
    assert ours.min() == 0.0 and port.min() == 0.0
    for stat in (np.mean, np.std, lambda x: np.linalg.norm(x, axis=1).mean()):
        a, b = stat(ours), stat(port)
        assert abs(a - b) <= 0.05 * abs(b), (a, b)
    # ~1 % of the values clip at 0 in both
    assert abs((ours == 0).mean() - (port == 0).mean()) < 0.003
    ra, rb = _nn_ratio(ours, q), _nn_ratio(port, pq)
    assert abs(ra - rb) <= 0.1 * rb, (ra, rb)
    a, b = _spectrum(ours), _spectrum(port)
    assert np.abs(a[:32] - b[:32]).max() < 0.05


def test_a_seed_draws_the_same_corpus_whatever_the_pool():
    for mod, params in ((embedding_like, {}), (sift_like, {})):
        x1, _ = _draw(mod, 300, 10, 32, params, 5)
        x2, q2 = _draw(mod, 300, 50, 32, params, 5)
        x3, _ = _draw(mod, 300, 10, 32, params, 6)
        np.testing.assert_array_equal(x1, x2)
        assert not np.array_equal(x1, x3)
        assert q2.shape == (50, 32)
