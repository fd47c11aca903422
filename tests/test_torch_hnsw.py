"""The ported HNSW (bulk build, classic beam, wide beam) against the JAX
HNSW on the CPU, at the sizes of tests/index/test_wide_beam.py: n = 4000,
d = 48, M = 8, l_max = 4.

- The host branch of ``bulk_build`` gives the same neighbor table, levels
  and entry as the JAX package, exactly (same rng stream, same numpy).
- With the level thresholds patched down, the ``build_forward_edges`` and
  clustered branches give an edge recall against exact kNN within 0.02 of
  the JAX build's (their k-means seeds and selection ties differ).
- On a JAX graph carried over with ``load_state``, classic and wide-beam
  search reach recall@10 against brute force no lower than the JAX search's
  minus 0.01, with filter, delete, schedule, early exit and the merge
  kernel. The port selects exactly (JAX: ``approx_min_k``), so ids are held
  by recall, not one by one; reported distances are exact f32 L2.
- The port's own ``datasets`` copy gives the JAX package's bytes.
"""

import random

import numpy as np
import pytest

import vector_db_tpu.index.hnsw as jax_hnsw
import vector_db_tpu_torch.index.hnsw as port_hnsw
from vector_db_tpu import datasets as jax_datasets
from vector_db_tpu.index.hnsw import HNSW as JaxHNSW
from vector_db_tpu_torch import datasets
from vector_db_tpu_torch.index.hnsw import HNSW
from vector_db_tpu_torch.types import Node

N, DIM, M, L_MAX = 4000, 48, 8, 4


def _data():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    q = rng.normal(size=(50, DIM)).astype(np.float32)
    return x, q


def _gt(x, q, allowed=None, k=10):
    ids = np.arange(len(x)) if allowed is None else np.asarray(sorted(allowed))
    d = ((q[:, None] - x[ids][None]) ** 2).sum(-1)
    return ids[np.argsort(d, 1)[:, :k]]


def _recall(ids, gt):
    k = gt.shape[1]
    return float(np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist())) / k
                          for i in range(len(gt))]))


def _build(cls, x, **kw):
    idx = cls(M=M, ef_construction=100, rng=random.Random(42), capacity=N,
              l_max=L_MAX, **kw)
    idx.bulk_build(list(range(N)), x)
    return idx


def _carry(ref):
    """A port HNSW holding the JAX index's graph and table."""
    port = HNSW(M=ref.M, ef_construction=ref.ef_construction,
                rng=random.Random(0), l_max=ref.l_max, device="cpu")
    g = ref.graph
    port.load_state(np.asarray(g.neighbors), np.asarray(g.levels),
                    int(g.entry), int(g.entry_level),
                    np.asarray(ref._store.emb), np.asarray(ref._store.valid),
                    ref._store.export_id_map())
    return port


@pytest.fixture(scope="module")
def pair():
    x, q = _data()
    ref = _build(JaxHNSW, x)
    return ref, _carry(ref), x, q


def test_host_branch_build_equals_jax(pair):
    ref, _, x, _ = pair
    port = _build(HNSW, x, device="cpu")
    np.testing.assert_array_equal(port.graph.neighbors.numpy(),
                                  np.asarray(ref.graph.neighbors))
    np.testing.assert_array_equal(port.graph.levels.numpy(),
                                  np.asarray(ref.graph.levels))
    assert (port.entry_node_id, port.max_level) == (ref.entry_node_id,
                                                    ref.max_level)
    for nid in (0, 17, port.entry_node_id):
        for level in range(L_MAX):
            assert port.neighbors_of(nid, level) == ref.neighbors_of(nid,
                                                                     level)


def _edge_recall(idx, x, k=M):
    """Mean share of each node's exact k nearest found in its level-0
    row."""
    nb = np.asarray(idx.graph.neighbors)[:, :2 * M]
    sq = (x * x).sum(1)
    d = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    np.fill_diagonal(d, np.inf)
    true = np.argsort(d, 1)[:, :k]
    return float(np.mean([len(set(nb[i].tolist()) & set(true[i].tolist())) / k
                          for i in range(len(x))]))


@pytest.mark.parametrize("branch,alpha", [("forward", 1.0), ("forward", 1.2),
                                          ("clustered", 1.0),
                                          ("clustered", 1.2)])
def test_device_branches_edge_recall_near_jax(monkeypatch, branch, alpha):
    x, _ = _data()
    for mod in (jax_hnsw, port_hnsw):
        monkeypatch.setattr(mod, "BULK_HOST_THRESHOLD", 600)
        if branch == "clustered":
            monkeypatch.setattr(mod, "BULK_EXACT_THRESHOLD", 2000)
    ref = JaxHNSW(M=M, ef_construction=100, rng=random.Random(42),
                  capacity=N, l_max=L_MAX)
    ref.bulk_build(list(range(N)), x, alpha=alpha)
    port = HNSW(M=M, ef_construction=100, rng=random.Random(42), capacity=N,
                l_max=L_MAX, device="cpu")
    port.bulk_build(list(range(N)), x, alpha=alpha)
    np.testing.assert_array_equal(port.graph.levels.numpy(),
                                  np.asarray(ref.graph.levels))
    want, got = _edge_recall(ref, x), _edge_recall(port, x)
    assert abs(got - want) <= 0.02, (got, want)
    # upper levels (<= 600 nodes) took the host branch in both: identical
    np.testing.assert_array_equal(port.graph.neighbors.numpy()[:, 2 * M:],
                                  np.asarray(ref.graph.neighbors)[:, 2 * M:])


@pytest.mark.parametrize("ef,expand", [(50, 1), (100, 1), (64, 4)])
def test_classic_search_recall_near_jax(pair, ef, expand):
    ref, port, x, q = pair
    gt = _gt(x, q)
    _, want = ref.search_batch(q, 10, ef=ef, expand=expand)
    d, got = port.search_batch(q, 10, ef=ef, expand=expand)
    assert _recall(got, gt) >= _recall(want, gt) - 0.01
    dref = np.sqrt(((q[:, None] - x[np.maximum(got, 0)]) ** 2).sum(-1))
    np.testing.assert_allclose(d, dref, rtol=1e-5, atol=1e-5)
    assert (np.diff(d, axis=1) >= 0).all()


def test_classic_bf16_traversal_recall_near_jax(pair):
    ref, port, x, q = pair
    gt = _gt(x, q)
    ref.precision = port.precision = "bf16"
    try:
        _, want = ref.search_batch(q, 10, ef=64)
        _, got = port.search_batch(q, 10, ef=64)
    finally:
        ref.precision = port.precision = "f32"
    assert _recall(got, gt) >= _recall(want, gt) - 0.01


def test_classic_filter_recall_near_jax(pair):
    ref, port, x, q = pair
    allowed = set(range(0, N, 4))
    gt = _gt(x, q, allowed)
    _, want = ref.search_batch(q, 10, ef=100, filter_ids=allowed)
    _, got = port.search_batch(q, 10, ef=100, filter_ids=allowed)
    assert set(got[got >= 0].tolist()) <= allowed
    assert _recall(got, gt) >= _recall(want, gt) - 0.01


@pytest.mark.parametrize("merge_kernel", [False, True])
def test_wide_recall_near_jax(pair, merge_kernel):
    ref, port, x, q = pair
    gt = _gt(x, q)
    for idx in (ref, port):
        idx.enable_wide(dims=None, seeds=512)
    kw = dict(k=10, ef=128, frontier=16, steps=8, merge_kernel=merge_kernel)
    _, want = ref.search_batch_wide(q, **kw)
    d, got = port.search_batch_wide(q, **kw)
    assert _recall(got, gt) >= _recall(want, gt) - 0.01
    for i in range(len(q)):
        ids = got[i][got[i] >= 0]
        assert len(set(ids.tolist())) == len(ids)
        dref = np.sqrt(((q[i] - x[ids]) ** 2).sum(-1))
        np.testing.assert_allclose(d[i][: len(ids)], dref, rtol=1e-5,
                                   atol=1e-5)


def test_wide_merge_kernel_changes_nothing_on_the_port(pair):
    # both merges are the exact stable top-P: the same pool every step
    _, port, _, q = pair
    port.enable_wide(dims=None, seeds=512)
    for kw in (dict(seen_mask=False), dict(dedup_window=0)):
        a = port.search_batch_wide(q, k=10, ef=256, frontier=32, steps=10,
                                   **kw)
        b = port.search_batch_wide(q, k=10, ef=256, frontier=32, steps=10,
                                   merge_kernel=True, **kw)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("mode", ["schedule", "early_exit", "pca"])
def test_wide_modes_recall_near_jax(pair, mode):
    ref, port, x, q = pair
    gt = _gt(x, q)
    dims = 24 if mode == "pca" else None
    for idx in (ref, port):
        idx.enable_wide(dims=dims, seeds=512)
    kw = {"schedule": dict(schedule=((64, 3), (32, 3), (16, 6))),
          "early_exit": dict(frontier=32, steps=12, early_exit=True),
          "pca": dict(frontier=32, steps=12)}[mode]
    _, want = ref.search_batch_wide(q, k=10, ef=256, **kw)
    _, got = port.search_batch_wide(q, k=10, ef=256, **kw)
    assert _recall(got, gt) >= _recall(want, gt) - 0.01


@pytest.mark.parametrize("schedule", [None, ((64, 4), (32, 4), (16, 4))])
def test_wide_filter_recall_near_jax(pair, schedule):
    ref, port, x, q = pair
    rng = np.random.default_rng(3)
    allowed = set(int(i) for i in rng.choice(N, N // 5, replace=False))
    gt = _gt(x, q, allowed)
    for idx in (ref, port):
        idx.enable_wide(dims=None, seeds=512)
    kw = dict(k=10, ef=256, rerank_k=128, filter_ids=allowed)
    kw.update(dict(schedule=schedule) if schedule else dict(frontier=32,
                                                           steps=12))
    _, want = ref.search_batch_wide(q, **kw)
    _, got = port.search_batch_wide(q, **kw)
    assert set(got[got >= 0].tolist()) <= allowed
    assert _recall(got, gt) >= _recall(want, gt) - 0.01


def test_delete_matches_jax_and_never_returns_deleted():
    x, q = _data()
    ref = _build(JaxHNSW, x)
    port = _carry(ref)
    victims = [ref.entry_node_id] + list(range(0, N, 40))
    for idx in (ref, port):
        for v in victims:
            idx.delete_node(v)
    np.testing.assert_array_equal(port.graph.neighbors.numpy(),
                                  np.asarray(ref.graph.neighbors))
    assert (port.entry_node_id, port.max_level) == (ref.entry_node_id,
                                                    ref.max_level)
    live = np.setdiff1d(np.arange(N), victims)
    gt = _gt(x, q, set(live.tolist()))
    _, want = ref.search_batch(q, 10, ef=100)
    _, got = port.search_batch(q, 10, ef=100)
    assert not set(got.ravel().tolist()) & set(victims)
    assert _recall(got, gt) >= _recall(want, gt) - 0.01
    for idx in (ref, port):
        idx.enable_wide(dims=None, seeds=512)
    _, want = ref.search_batch_wide(q, k=10, ef=128, frontier=16, steps=10)
    _, got = port.search_batch_wide(q, k=10, ef=128, frontier=16, steps=10)
    assert not set(got.ravel().tolist()) & set(victims)
    assert _recall(got, gt) >= _recall(want, gt) - 0.01


def test_small_batches_and_padding(pair):
    _, port, _, q = pair
    port.enable_wide(dims=None, seeds=512)
    d, i = port.search_batch_wide(q[:3], k=7, ef=128, frontier=16, steps=10)
    assert d.shape == (3, 7) and i.shape == (3, 7)
    d, i = port.search_batch(q[:1], 5, ef=20)
    assert d.shape == (1, 5) and (i >= 0).all()
    d, i = port.search_batch_wide(q[:5], k=10, ef=128, frontier=16, steps=10,
                                  qchunk=2)
    np.testing.assert_array_equal(
        i, port.search_batch_wide(q[:5], k=10, ef=128, frontier=16, steps=10,
                                  qchunk=0)[1])


def test_insert_nodes_bulk_builds_an_empty_index_and_search_returns_nodes():
    """insert_nodes on an empty index streams, as the JAX package's does
    (bulk_build is the caller's choice): the same levels and entry as
    JAX's from the same rng, neighbor rows equal as sets on >= 99 % of
    rows; search returns the stored nodes."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(600, 8)).astype(np.float32)
    nodes = [Node(id=100 + i, embedding=x[i], metadata={"i": i})
             for i in range(len(x))]
    ref = JaxHNSW(M=8, ef_construction=50, rng=random.Random(1))
    idx = HNSW(M=8, ef_construction=50, rng=random.Random(1), device="cpu")
    for index in (ref, idx):
        index.insert_nodes(nodes[:10])
        index.insert_nodes(nodes)            # the first 10: a no-op
    assert idx.size == len(x) and idx.storage.size() == len(x)
    np.testing.assert_array_equal(idx.graph.levels.numpy(),
                                  np.asarray(ref.graph.levels))
    assert (idx.graph.entry, idx.graph.entry_level) == (
        int(ref.graph.entry), int(ref.graph.entry_level))
    got, want = idx.graph.neighbors.numpy(), np.asarray(ref.graph.neighbors)
    assert np.mean([set(a) == set(b) for a, b in zip(got, want)]) >= 0.99
    hits = idx.search(x[5], 3, ef=32)
    assert hits[0][0].id == 105 and hits[0][0].metadata == {"i": 5}
    assert hits[0][1] == pytest.approx(0.0, abs=1e-6)
    idx.storage.delete(105)
    idx.sync_storage()
    assert 105 not in idx.search_batch(x[5:6], 3, ef=32)[1]


def test_datasets_copy_gives_the_same_bytes(tmp_path):
    a = datasets.embedding_like(300, 24, seed=3, intrinsic=8)
    b = jax_datasets.embedding_like(300, 24, seed=3, intrinsic=8,
                                    device="numpy")
    assert a.tobytes() == b.tobytes()
    for got, want in zip(datasets.sift_like(500, dim=16, seed=1, queries=5,
                                            n_clusters=20),
                         jax_datasets.sift_like(500, dim=16, seed=1,
                                                queries=5, n_clusters=20)):
        assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="numpy"):
        datasets.embedding_like(10, 4, seed=0, device="jax")
    recs = np.arange(12, dtype=np.int32).reshape(3, 4)
    raw = np.concatenate([np.full((3, 1), 4, np.int32), recs], 1)
    raw.tofile(tmp_path / "x.ivecs")
    raw.tofile(tmp_path / "x.fvecs")
    for name in ("read_ivecs", "read_fvecs"):
        got = getattr(datasets, name)(tmp_path / f"x.{name[5:]}")
        want = getattr(jax_datasets, name)(tmp_path / f"x.{name[5:]}")
        assert got.tobytes() == want.tobytes() and got.dtype == want.dtype
    assert datasets.load_sift1m(str(tmp_path)) is None
