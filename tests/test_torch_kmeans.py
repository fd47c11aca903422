"""The ported k-means against vector_db_tpu/ops/kmeans.py on the same numpy
inputs. Trained centroids cannot match bit for bit (jax.random and
torch.Generator draw different initial rows), so Lloyd's iterations are
compared from the same initial centroids: centroids within 1e-4 (f32 sums
in another order), labels equal on well-separated data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import n, t
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.ops.kmeans import _lloyd as jax_lloyd
from vector_db_tpu.ops.kmeans import assign_tiled as jax_assign_tiled
from vector_db_tpu.ops.kmeans import kmeans as jax_kmeans
from vector_db_tpu_torch.ops.kmeans import (
    _lloyd,
    assign_tiled,
    kmeans,
    kmeans_multi,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _blobs(seed, k=6, per=60, dim=8, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)).astype(np.float32) * 5
    pts = np.concatenate([c + spread * rng.standard_normal((per, dim))
                          for c in centers]).astype(np.float32)
    return rng, centers, pts


@pytest.mark.parametrize("iters", [1, 10])
def test_lloyd_matches_jax_from_same_init(iters):
    rng, _, x = _blobs(0)
    init = x[rng.choice(x.shape[0], 6, replace=False)]
    c, lab, inertia = _lloyd(t(x), t(init), iters)
    jc, jlab, jinertia = jax_lloyd(jnp.asarray(x), jnp.asarray(init), iters)
    np.testing.assert_allclose(n(c), np.asarray(jc), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(n(lab), np.asarray(jlab))
    assert lab.dtype == torch.int32
    assert float(inertia) == pytest.approx(float(jinertia), rel=1e-4)


def test_batched_lloyd_matches_jax_per_subspace():
    """The subspace-batched form (PQ's vmap) equals one JAX run each."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 200, 4)).astype(np.float32)
    init = x[:, :8].copy()
    c, lab, _ = _lloyd(t(x), t(init), 8)
    for s in range(3):
        jc, jlab, _ = jax_lloyd(jnp.asarray(x[s]), jnp.asarray(init[s]), 8)
        np.testing.assert_allclose(n(c)[s], np.asarray(jc), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(n(lab)[s], np.asarray(jlab))


def test_empty_cluster_keeps_its_centroid():
    _, _, x = _blobs(2, k=3)
    far = np.full((1, 8), 1e3, np.float32)            # attracts no point
    init = np.concatenate([x[[0, 60, 120]], far])
    c, lab, _ = _lloyd(t(x), t(init), 5)
    jc, _, _ = jax_lloyd(jnp.asarray(x), jnp.asarray(init), 5)
    np.testing.assert_array_equal(n(c)[3], far[0])
    np.testing.assert_allclose(n(c), np.asarray(jc), rtol=1e-4, atol=1e-4)
    assert 3 not in set(n(lab).tolist())


def test_assign_tiled_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    cents = rng.standard_normal((20, 16)).astype(np.float32)
    got = assign_tiled(t(x), t(cents), tile=256, n_cand=3)
    want = jax_assign_tiled(jnp.asarray(x), jnp.asarray(cents), tile=256,
                            n_cand=3)
    assert got.dtype == torch.int32 and got.shape == (1000, 3)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_kmeans_multi_shapes_and_nearest_labels():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 80, 4)).astype(np.float32)
    c, lab = kmeans_multi(t(x), 4, torch.Generator().manual_seed(2),
                          iters=10, restarts=2)
    assert c.shape == (3, 4, 4) and lab.shape == (3, 80)
    assert lab.dtype == torch.int32 and int(lab.max()) < 4
    d = ((x[:, :, None, :] - n(c)[:, None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(n(lab), d.argmin(-1))


def test_kmeans_recovers_blobs_like_jax():
    """The JAX test's contract (tests/ops/test_kmeans.py) on the port."""
    _, centers, pts = _blobs(5, k=4, per=50, spread=0.05)
    c, labels = kmeans(t(pts), 4, torch.Generator().manual_seed(0),
                       iters=25, restarts=8)
    jc, _ = jax_kmeans(jnp.asarray(pts), 4, jax.random.key(0), iters=25,
                       restarts=8)
    for cc in (n(c), np.asarray(jc)):
        d = np.linalg.norm(centers[:, None, :] - cc[None, :, :], axis=-1)
        assert np.all(d.min(axis=1) < 0.5)
    labels = n(labels)
    for b in range(4):
        assert len(set(labels[b * 50:(b + 1) * 50].tolist())) == 1


def test_initial_rows_are_points_drawn_apart_per_subspace():
    """The 'points' draw: each subspace and restart starts from k distinct
    rows, and subspaces draw apart (never one draw for all), as JAX splits
    its key per subspace. Row i of every subspace holds the value i, so
    zero Lloyd's iterations return the drawn rows."""
    s, rows, k = 16, 500, 32
    x = torch.arange(rows, dtype=torch.float32)[None, :, None].expand(
        s, rows, 1).contiguous()
    gen = torch.Generator().manual_seed(0)
    drawn = [n(kmeans_multi(x, k, gen, iters=0)[0])[..., 0].astype(int)
             for _ in range(2)]
    for d in drawn:
        assert all(len(set(row.tolist())) == k for row in d)
        assert len({tuple(sorted(row.tolist())) for row in d}) == s
    assert (drawn[0] != drawn[1]).any()
    # the sample is uniform over the rows: their mean is near the middle
    assert abs(np.concatenate(drawn).mean() - (rows - 1) / 2) < 15
