"""HNSW PQ and projected (RP) traversal of the port against the JAX HNSW on
the CPU.

On a JAX graph carried over with ``load_state``, with JAX's codebooks, OPQ
rotation, codes and projection carried too (so both packages score with
the same trained state), ``search_batch_pq`` and ``search_batch_rp`` return
the same id sets on >= 99 % of the queries, with exact distances within
rtol 1e-5 (the rerank is exact f32). Both beams are the classic best-first
beam; each step's selection is ``lax.top_k`` in JAX and ``torch.topk`` in
the port, so a tie of two ADC sums could order them apart: ids are held as
sets. Un-reranked PQ distances are ADC estimates, f32 sums in another order
(rtol 1e-5, atol 1e-4). The JAX package's own contracts
(tests/index/test_hnsw_pq.py, test_hnsw_rp.py, test_hnsw_persist_aux.py)
run on the port too, and the codes after add and delete equal a fresh
encode.
"""

import random

import numpy as np
import pytest
import torch

from vector_db_tpu.index.hnsw import HNSW as JaxHNSW
from vector_db_tpu.storage.mmap import MMapNodeStorage as JaxMMap
from vector_db_tpu.types import Node as JaxNode
from vector_db_tpu_torch.index.hnsw import HNSW
from vector_db_tpu_torch.index.pq import _encode_scan
from vector_db_tpu_torch.storage.mmap import MMapNodeStorage
from vector_db_tpu_torch.types import Node

N, DIM, M = 1500, 32, 8


def _lowrank(n, dim, rank, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, rank)).astype(np.float32)
    v = rng.standard_normal((rank, dim)).astype(np.float32)
    x = u @ v + 0.05 * rng.standard_normal((n, dim)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _carry(ref, **state):
    port = HNSW(M=ref.M, ef_construction=ref.ef_construction,
                rng=random.Random(0), l_max=ref.l_max, device="cpu")
    g = ref.graph
    port.load_state(np.asarray(g.neighbors), np.asarray(g.levels),
                    int(g.entry), int(g.entry_level),
                    np.asarray(ref._store.emb), np.asarray(ref._store.valid),
                    ref._store.export_id_map(), **state)
    return port


def _trained_state(ref):
    """The JAX index's PQ and RP state as load_state takes it."""
    rot = ref._pq.rotation
    return dict(pq_codebooks=np.asarray(ref._pq.codebooks),
                pq_rotation=None if rot is None else np.asarray(rot),
                pq_codes=np.asarray(ref._pq_codes),
                rp_proj=np.asarray(ref._rp_proj))


@pytest.fixture(scope="module")
def pair():
    x = _lowrank(N + 40, DIM, 12, seed=1)
    x, q = x[:N], x[N:]
    ref = JaxHNSW(M=M, ef_construction=80, rng=random.Random(42),
                  capacity=2048, l_max=4)
    ref.bulk_build(list(range(N)), x)
    ref.enable_pq(chunks=8, ksub=32, opq_iters=2)
    ref.enable_rp(dims=16)
    return ref, _carry(ref, **_trained_state(ref)), x, q


def _same_sets(got, want, share=0.99):
    return np.mean([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                    for a, b in zip(got, want)]) >= share


def _exact(d, ids, x, q):
    live = ids >= 0
    ref = np.sqrt(((x[np.maximum(ids, 0)] - q[:, None]) ** 2).sum(-1))
    np.testing.assert_allclose(d[live], ref[live], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ef,expand", [(32, 1), (64, 4)])
def test_search_batch_pq_matches_jax(pair, ef, expand):
    ref, port, x, q = pair
    d, got = port.search_batch_pq(q, 10, ef=ef, expand=expand)
    dw, want = ref.search_batch_pq(q, 10, ef=ef, expand=expand)
    assert _same_sets(got, want)
    _exact(d, got, x, q)
    np.testing.assert_allclose(np.sort(d, 1), np.sort(dw, 1), rtol=1e-5,
                               atol=1e-5)


def test_search_batch_pq_unreranked_matches_jax(pair):
    ref, port, _, q = pair
    d, got = port.search_batch_pq(q, 10, ef=48, rerank=False)
    dw, want = ref.search_batch_pq(q, 10, ef=48, rerank=False)
    assert _same_sets(got, want)
    np.testing.assert_allclose(d, dw, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("ef,expand", [(32, 1), (64, 4)])
def test_search_batch_rp_matches_jax(pair, ef, expand):
    ref, port, x, q = pair
    d, got = port.search_batch_rp(q, 10, ef=ef, expand=expand)
    dw, want = ref.search_batch_rp(q, 10, ef=ef, expand=expand)
    assert _same_sets(got, want)
    _exact(d, got, x, q)
    np.testing.assert_allclose(d, dw, rtol=1e-5, atol=1e-5)


def test_rp_mirror_equals_jax(pair):
    ref, port, _, _ = pair
    rp, xsq = port._rp_tables()
    jrp, jxsq = ref._rp_tables()
    np.testing.assert_allclose(rp.float().numpy(),
                               np.asarray(jrp, np.float32), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(xsq.numpy(), np.asarray(jxsq), rtol=1e-5,
                               atol=1e-5)


def test_codes_after_add_and_delete_equal_a_fresh_encode(pair):
    """refresh_pq_codes (and the PQ search, which refreshes codes the table
    has outgrown) leaves codes equal to encoding the current table, and
    equal to JAX's refresh on the same table."""
    ref, _, x, q = pair
    port = _carry(ref, **_trained_state(ref))
    fresh = x[:4] + 0.02
    for idx in (port, ref):
        idx.insert_arrays([9000 + i for i in range(4)], fresh)
        for v in (3, 4, 5):
            idx.delete_node(v)
        idx.refresh_pq_codes()
    codes = port._pq_table()
    want = _encode_scan(port._emb, port._pq.codebooks,
                        rotation=port._pq.rotation)
    np.testing.assert_array_equal(codes.numpy(), want.numpy())
    live = port._has_emb.numpy()
    np.testing.assert_array_equal(codes.numpy()[live],
                                  np.asarray(ref._pq_codes)[live])
    _, own = port.search_batch_pq(fresh, 1, ef=48)
    np.testing.assert_array_equal(own[:, 0], [9000, 9001, 9002, 9003])
    _, ids = port.search_batch_rp(x[3:6], 5, ef=48)
    assert not set(ids.ravel().tolist()) & {3, 4, 5}
    # a PQ search after a write re-encodes by itself
    port.insert_arrays([9100], x[10:11] + 0.03)
    _, own = port.search_batch_pq(x[10:11] + 0.03, 1, ef=48)
    assert own[0, 0] == 9100


def test_independent_training_recall_within_001():
    """Both packages train their own PQ codebooks and projection on one
    graph: recall@10 of the PQ and RP traversals within 0.01 (PQ within
    0.03: both k-means draw other initial rows)."""
    x = _lowrank(N + 40, DIM, 12, seed=2)
    x, q = x[:N], x[N:]
    gt = np.argsort(((x[None] - q[:, None]) ** 2).sum(-1), 1)[:, :10]
    ref = JaxHNSW(M=M, ef_construction=80, rng=random.Random(42),
                  capacity=2048, l_max=4)
    ref.bulk_build(list(range(N)), x)
    port = _carry(ref)
    for idx in (ref, port):
        idx.enable_rp(dims=16)
        idx.enable_pq(chunks=8, ksub=32)

    def rec(ids):
        return np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                        for a, b in zip(ids, gt)])

    assert abs(rec(port.search_batch_rp(q, 10, ef=64)[1])
               - rec(ref.search_batch_rp(q, 10, ef=64)[1])) <= 0.01
    assert abs(rec(port.search_batch_pq(q, 10, ef=64)[1])
               - rec(ref.search_batch_pq(q, 10, ef=64)[1])) <= 0.03


# -- the JAX package's contracts (tests/index/test_hnsw_pq.py,
# test_hnsw_rp.py), on the port ----------------------------------------
def test_pq_search_recall():
    rng = np.random.default_rng(0)
    n, dim = 400, 32
    x = rng.standard_normal((n, dim)).astype(np.float32)
    index = HNSW(M=8, ef_construction=50, rng=random.Random(42),
                 capacity=512, l_max=4, device="cpu")
    index.insert_arrays(list(range(n)), x, batch_size=400)
    index.enable_pq(chunks=8, ksub=32)
    q = rng.standard_normal((10, dim)).astype(np.float32)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), 1)[:, :5]
    _, exact_ids = index.search_batch(q, k=5, ef=50)
    _, pq_ids = index.search_batch_pq(q, k=5, ef=50)
    rec = [np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids, gt)])
           for ids in (exact_ids, pq_ids)]
    assert rec[1] >= rec[0] - 0.2
    assert rec[1] >= 0.5


def test_pq_self_query_with_rerank():
    x = np.random.default_rng(1).standard_normal((200, 16)).astype(
        np.float32)
    index = HNSW(M=8, ef_construction=40, rng=random.Random(42),
                 capacity=256, l_max=4, device="cpu")
    index.insert_arrays(list(range(200)), x, batch_size=200)
    index.enable_pq(chunks=4, ksub=16)
    dists, ids = index.search_batch_pq(x[:5], k=1, ef=40, rerank=True)
    np.testing.assert_array_equal(ids[:, 0], np.arange(5))
    assert np.all(dists[:, 0] < 1e-3)


def test_rp_traversal_matches_f32():
    data = _lowrank(2048 + 32, 96, 16, seed=3)
    x, q = data[:2048], data[2048:]
    gt = np.argsort(((x[None] - q[:, None]) ** 2).sum(-1), 1)[:, :10]
    index = HNSW(M=16, ef_construction=80, rng=random.Random(42),
                 capacity=2048, l_max=4, device="cpu")
    index.bulk_build(list(range(2048)), x)
    index.enable_rp(dims=32)

    def rec(ids):
        return np.mean([len(set(ids[i, :10].tolist()) & set(gt[i])) / 10
                        for i in range(32)])

    _, ids_f = index.search_batch(q, k=10, ef=80, expand=4)
    _, ids_rp = index.search_batch_rp(q, k=10, ef=80, expand=4)
    assert rec(ids_rp) >= rec(ids_f) - 0.02
    d, ids = index.search_batch_rp(x[:4], k=1, ef=32)
    np.testing.assert_array_equal(ids[:, 0], np.arange(4))
    assert np.all(d[:, 0] < 1e-2)


def test_rp_mirror_tracks_mutations():
    data = _lowrank(512 + 1, 64, 8, seed=4)
    x, extra = data[:512], data[512]
    index = HNSW(M=8, ef_construction=50, rng=random.Random(42),
                 capacity=1024, l_max=4, device="cpu")
    index.bulk_build(list(range(512)), x)
    index.enable_rp(dims=16)
    index.search_batch_rp(x[:1], k=1, ef=16)
    index.insert_node(Node(id=9999, embedding=extra, metadata={}))
    d, ids = index.search_batch_rp(extra[None, :], k=1, ef=32)
    assert ids[0, 0] == 9999 and d[0, 0] < 1e-2


@pytest.mark.parametrize("mode", ["pq", "rp"])
def test_requires_enable(mode):
    for cls, kw in ((JaxHNSW, {}), (HNSW, {"device": "cpu"})):
        index = cls(M=4, ef_construction=20, rng=random.Random(42), **kw)
        with pytest.raises(ValueError, match=f"enable_{mode}"):
            getattr(index, f"search_batch_{mode}")(
                np.zeros((1, 8), np.float32), k=1)


# -- tests/index/test_hnsw_persist_aux.py, on the port, both ways ---------
def _stored(tmp_path, cls, storage_cls, node_cls, **kw):
    x = np.random.default_rng(11).normal(size=(600, 32)).astype(np.float32)
    storage = storage_cls(str(tmp_path / "emb.npy"), str(tmp_path /
                                                         "meta.npy"),
                          dim=32, capacity=1024)
    idx = cls(M=8, ef_construction=60, rng=random.Random(42),
              storage=storage, index_file=tmp_path / "g.npz", capacity=1024,
              l_max=3, **kw)
    idx.insert_nodes([node_cls(id=i, embedding=x[i], metadata={},
                               content=None) for i in range(600)])
    return idx, x


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_pq_rp_wide_state_roundtrip(tmp_path, reader):
    """The port saves its trained PQ (OPQ), RP and wide state; the port
    and JAX reload it bit-equal, with no retraining, and the port's reload
    answers as before the save."""
    idx, x = _stored(tmp_path, HNSW, MMapNodeStorage, Node, device="cpu")
    idx.enable_pq(chunks=4, ksub=16, opq_iters=2)
    idx.enable_rp(dims=16)
    idx.enable_wide(dims=16, seeds=128)
    q = x[:8] + 0.01
    before = {"pq": idx.search_batch_pq(q, k=5, ef=64),
              "rp": idx.search_batch_rp(q, k=5, ef=64),
              "wide": idx.search_batch_wide(q, k=5, ef=64, frontier=16,
                                            steps=8)}
    idx.save_index()
    if reader == "port":
        again = HNSW(M=8, ef_construction=60, rng=random.Random(42),
                     storage=MMapNodeStorage(str(tmp_path / "emb.npy"),
                                             str(tmp_path / "meta.npy"),
                                             dim=32, capacity=1024),
                     index_file=tmp_path / "g.npz", capacity=1024, l_max=3,
                     device="cpu")
    else:
        again = JaxHNSW(M=8, ef_construction=60, rng=random.Random(42),
                        storage=JaxMMap(str(tmp_path / "emb.npy"),
                                        str(tmp_path / "meta.npy"), dim=32,
                                        capacity=1024),
                        index_file=tmp_path / "g.npz", capacity=1024,
                        l_max=3)

    def arr(a):
        return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    for name in ("codebooks", "rotation"):
        np.testing.assert_array_equal(arr(getattr(again._pq, name)),
                                      arr(getattr(idx._pq, name)))
    np.testing.assert_array_equal(arr(again._rp_proj), arr(idx._rp_proj))
    np.testing.assert_array_equal(arr(again._wb_proj), arr(idx._wb_proj))
    if reader == "port":
        d, i = again.search_batch_pq(q, k=5, ef=64)
        np.testing.assert_array_equal(i, before["pq"][1])
        np.testing.assert_allclose(d, before["pq"][0], rtol=1e-5)
        np.testing.assert_array_equal(
            again.search_batch_rp(q, k=5, ef=64)[1], before["rp"][1])
        np.testing.assert_array_equal(again.search_batch_wide(
            q, k=5, ef=64, frontier=16, steps=8)[1], before["wide"][1])
    else:
        assert _same_sets(again.search_batch_pq(q, k=5, ef=64)[1],
                          before["pq"][1], share=0.85)


def test_jax_file_loads_into_live_pq_rp_state(tmp_path):
    """A JAX index file with trained PQ and RP state: the port reloads it
    into live state (codes re-encoded) and serves PQ and RP searches like
    the JAX index."""
    ref, x = _stored(tmp_path, JaxHNSW, JaxMMap, JaxNode)
    ref.enable_pq(chunks=4, ksub=16, opq_iters=2)
    ref.enable_rp(dims=16)
    ref.save_index()
    port = HNSW(M=8, ef_construction=60, rng=random.Random(42),
                storage=MMapNodeStorage(str(tmp_path / "emb.npy"),
                                        str(tmp_path / "meta.npy"), dim=32,
                                        capacity=1024),
                index_file=tmp_path / "g.npz", capacity=1024, l_max=3,
                device="cpu")
    q = x[:16] + 0.01
    assert _same_sets(port.search_batch_pq(q, 5, ef=64)[1],
                      ref.search_batch_pq(q, 5, ef=64)[1])
    assert _same_sets(port.search_batch_rp(q, 5, ef=64)[1],
                      ref.search_batch_rp(q, 5, ef=64)[1])


def test_plain_index_roundtrip_unaffected(tmp_path):
    idx, x = _stored(tmp_path, HNSW, MMapNodeStorage, Node, device="cpu")
    idx.save_index()
    again = HNSW(M=8, ef_construction=60, rng=random.Random(42),
                 storage=MMapNodeStorage(str(tmp_path / "emb.npy"),
                                         str(tmp_path / "meta.npy"), dim=32,
                                         capacity=1024),
                 index_file=tmp_path / "g.npz", capacity=1024, l_max=3,
                 device="cpu")
    assert again._pq is None and again._rp_proj is None
    np.testing.assert_array_equal(idx.search_batch(x[:4] + 0.01, 5, ef=64)[1],
                                  again.search_batch(x[:4] + 0.01, 5,
                                                     ef=64)[1])
