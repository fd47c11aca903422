"""The port's bulk graph-construction ops (vector_db_tpu_torch/ops/
graph_build.py and ops/exact.knn_exact) against the JAX package's, on the
same numpy inputs on the CPU.

Edge selection compares distances, and the two packages sum products in
different orders, so a decision at an exact tie of the last bit may flip:
row-wise equality is required for at least 98 % of rows and ids are
otherwise held as sets; distances agree within rtol 1e-5, atol 1e-4. The
reverse merges are pure index arithmetic over given inputs and must agree
exactly, ties included.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_parity import assert_topk_parity, n, t
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.index.hnsw import _reverse_merge as jax_host_reverse_merge
from vector_db_tpu.ops import graph_build as J
from vector_db_tpu.ops.exact import knn_exact as jax_knn_exact
from vector_db_tpu_torch.index.hnsw import _reverse_merge
from vector_db_tpu_torch.ops import graph_build as P
from vector_db_tpu_torch.ops.exact import knn_exact

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 1e-5, 1e-4


def _emb(seed, rows=512, dim=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, dim)).astype(np.float32)
    x[7] = x[3]                       # an exact duplicate row
    return rng, x


def _rows_equal(a, b) -> float:
    return float(np.mean(np.all(np.asarray(a) == np.asarray(b), axis=1)))


def _set_recall(got, want) -> float:
    hits = sum(len(set(g[g >= 0].tolist()) & set(w[w >= 0].tolist()))
               for g, w in zip(np.asarray(got), np.asarray(want)))
    return hits / max(1, int((np.asarray(want) >= 0).sum()))


def _exact_knn(x, k):
    d = ((x[:, None] - x[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1).astype(np.float32), order


def test_knn_exact_matches_jax():
    _, x = _emb(0)
    valid = np.ones(len(x), bool)
    valid[::17] = False
    qi = np.arange(40, 104, dtype=np.int32)
    want = jax_knn_exact(jnp.asarray(x[qi]), jnp.asarray(qi), jnp.asarray(x),
                         jnp.asarray(valid), 12, tile=128)
    got = knn_exact(t(x[qi]), t(qi), t(x), t(valid), 12)
    assert_topk_parity(*got, *want, rtol=RTOL, atol=ATOL)
    assert not (n(got[1]) == qi[:, None]).any()


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_occlusion_prune_matches_jax(alpha):
    _, x = _emb(1)
    cd, ci = _exact_knn(x, 24)
    ci = ci.astype(np.int32)
    ci[::5, -4:] = -1                 # padded candidates
    cd[::5, -4:] = 3.0e38
    ce = x[np.maximum(ci, 0)]
    jd, ji = J.occlusion_prune(jnp.asarray(cd), jnp.asarray(ci),
                               jnp.asarray(ce), 8, alpha)
    pd, pi = P.occlusion_prune(t(cd), t(ci), t(ce), 8, alpha)
    assert _rows_equal(n(pi), ji) >= 0.98
    same = np.all(n(pi) == np.asarray(ji), axis=1)
    np.testing.assert_allclose(n(pd)[same], np.asarray(jd)[same], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_build_forward_edges_matches_jax(alpha):
    _, x = _emb(2)
    valid = np.ones(len(x), bool)
    valid[-12:] = False               # padding rows, as the caller pads
    jd, ji = J.build_forward_edges(jnp.asarray(x), jnp.asarray(valid), deg=8,
                                   k_cand=32, chunk=128, alpha=alpha)
    pd, pi = P.build_forward_edges(t(x), t(valid), deg=8, k_cand=32,
                                   chunk=100, alpha=alpha)
    assert _rows_equal(n(pi), ji) >= 0.98
    assert (n(pi)[~valid] == -1).all()
    assert _set_recall(n(pi), ji) >= 0.99


def _forward_tables(seed, rows=300, deg=6):
    """Forward edge tables with -1 pads and tied distances."""
    rng = np.random.default_rng(seed)
    fi = rng.integers(0, rows, (rows, deg)).astype(np.int32)
    fd = np.sort(rng.integers(0, 40, (rows, deg)).astype(np.float32), 1)
    fi[::7, -2:] = -1
    fd[::7, -2:] = np.inf
    return fd, fi


@pytest.mark.parametrize("width", [4, 12])
def test_device_reverse_merge_matches_jax_exactly(width):
    fd, fi = _forward_tables(3)
    fd = np.where(np.isinf(fd), np.float32(3.0e38), fd)
    want = J.reverse_merge(jnp.asarray(fd), jnp.asarray(fi), width=width)
    np.testing.assert_array_equal(n(P.reverse_merge(t(fd), t(fi), width)),
                                  np.asarray(want))


@pytest.mark.parametrize("width", [4, 12])
def test_host_reverse_merge_matches_jax_exactly(width):
    fd, fi = _forward_tables(4)
    np.testing.assert_array_equal(_reverse_merge(fi, fd, width),
                                  jax_host_reverse_merge(fi, fd, width))


def test_assign_topk_clusters_matches_jax():
    rng, x = _emb(5, rows=1024)
    cents = rng.standard_normal((20, x.shape[1])).astype(np.float32)
    want = J.assign_topk_clusters(jnp.asarray(x), jnp.asarray(cents), k=3,
                                  chunk=256)
    got = P.assign_topk_clusters(t(x), t(cents), k=3, chunk=300)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def _members(rows, cells=6, spill=2, seed=6):
    rng = np.random.default_rng(seed)
    lmax = 256
    members = np.full((cells, lmax), -1, np.int32)
    fill = np.zeros(cells, int)
    for p in range(rows):
        for c in rng.choice(cells, spill, replace=False):
            if fill[c] < lmax:
                members[c, fill[c]] = p
                fill[c] += 1
    return members


def test_clustered_knn_merge_matches_jax():
    _, x = _emb(6, rows=600)
    members = _members(len(x))
    jd, ji = J.clustered_knn_merge(jnp.asarray(x), jnp.asarray(members), 8)
    pd, pi = P.clustered_knn_merge(t(x), t(members), 8)
    assert _set_recall(n(pi), ji) >= 0.99
    for got, want in ((pd, jd), (pi, ji)):
        assert n(got).shape == np.asarray(want).shape
    live = np.asarray(ji) >= 0
    # where both agree on the id, the distance agrees
    same = n(pi) == np.asarray(ji)
    np.testing.assert_allclose(n(pd)[same & live], np.asarray(jd)[same & live],
                               rtol=RTOL, atol=ATOL)
    # each id at most once per row
    for row in n(pi):
        ids = row[row >= 0]
        assert len(set(ids.tolist())) == len(ids)


def test_nn_descent_round_matches_jax():
    _, x = _emb(7, rows=512)
    members = _members(len(x), cells=8, spill=1, seed=7)
    fd, fi = P.clustered_knn_merge(t(x), t(members), 8)
    jd, ji = J.nn_descent_round(jnp.asarray(x), jnp.asarray(n(fd)),
                                jnp.asarray(n(fi)), 8, chunk=128, sample=4)
    pd, pi = P.nn_descent_round(t(x), fd, fi, 8, chunk=100, sample=4)
    assert _rows_equal(n(pi), ji) >= 0.98
    assert _set_recall(n(pi), ji) >= 0.99
    _, true_i = _exact_knn(x, 8)
    # the round only improves the tables
    assert _set_recall(n(pi), true_i) >= _set_recall(n(fi), true_i)


def test_occlusion_prune_tiled_matches_jax():
    _, x = _emb(8)
    cd, ci = _exact_knn(x, 16)
    jd, ji = J.occlusion_prune_tiled(jnp.asarray(x), jnp.asarray(cd),
                                     jnp.asarray(ci.astype(np.int32)), deg=6,
                                     chunk=128, alpha=1.2)
    pd, pi = P.occlusion_prune_tiled(t(x), t(cd), t(ci.astype(np.int32)),
                                     deg=6, chunk=100, alpha=1.2)
    assert _rows_equal(n(pi), ji) >= 0.98
