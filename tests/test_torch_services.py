"""The port's services (StorageService, IndexingService, EmbeddingService)
held to the contracts of tests/services/test_services.py and of the
test_index_types.py tests whose modes the port has, on the CPU
(``device: cpu`` in every config).

Where the JAX test exists, the same Nodes (numpy seed) go through the JAX
service and the port's, each over its own storage, and the results are
compared:
- flat: equal ids, distances within 1e-5;
- ivf, hnsw and the scan routes: recall@5 against the f32 exact answer,
  the port's no more than RECALL_TOL = 0.01 below JAX's (the packages'
  graphs and bf16 selections may differ in ties; the IVF builds draw
  their k-means initial rows alike, test_torch_ivf._same_init).

Also: the PQ, RP and pool-free beam routes (tests/services/
test_index_types.py:125-160, :230-330, :397-435), each answer equal to the
direct index call the JAX service makes and its recall near the JAX
service's; the autotune and sharded-hnsw configs construct and serve (their
contracts in test_torch_autotune.py, test_torch_sharded.py); an index file
saved by one package's
service reopens in the other's; searches running beside inserts see whole
batches only; the config's device spellings.
"""

import sys
import threading

import numpy as np
import pytest
import torch
import yaml

from vector_db_tpu.services.indexing_service import (
    IndexingService as JaxIndexingService)
from vector_db_tpu.services.storage_service import (
    StorageService as JaxStorageService)
from vector_db_tpu.services.embedding_service import (
    EmbeddingService as JaxEmbeddingService)
from vector_db_tpu_torch.services.embedding_service import EmbeddingService
from vector_db_tpu_torch.services.indexing_service import IndexingService
from vector_db_tpu_torch.services.storage_service import StorageService
from vector_db_tpu_torch.types import Node
from tests.test_torch_ivf import _same_init
from tests.torch_parity import recall
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RECALL_TOL = 0.01
DIST_TOL = 1e-5


# ---- helpers ----

@pytest.fixture
def config_path(tmp_path):
    cfg = {
        "embedding": {"model": "fake-16", "dimension": 16},
        "device": "cpu",
        "index": {"ef_construction": 40, "M": 4, "flush_threshold": 5},
        "vector_db": {
            "file_path": str(tmp_path / "vdb"),
            "dimension": 16,
            "capacity": 64,
        },
    }
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


@pytest.fixture
def storage_service(tmp_path):
    return StorageService(file_path=str(tmp_path / "vdb"), dim=16, capacity=64)


def make_node(i, rng):
    return Node(
        id=i, embedding=rng.standard_normal(16).astype(np.float32),
        metadata={"cat": "a" if i % 2 == 0 else "b"}, content=f"doc{i}",
    )


def make_config(tmp_path, index_type, **extra):
    cfg = {
        "embedding": {"model": "fake-16", "dimension": 16},
        "device": "cpu",
        "index": {"ef_construction": 30, "M": 4, "flush_threshold": 1000,
                  "type": index_type, **extra},
        "vector_db": {"file_path": str(tmp_path / "vdb"), "dimension": 16,
                      "capacity": 256},
    }
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def make_nodes(rng, n, start=0):
    return [Node(id=start + i,
                 embedding=rng.standard_normal(16).astype(np.float32),
                 metadata={"par": (start + i) % 2}) for i in range(n)]


def services(tmp_path, index_type, mp=None, **extra):
    """(JAX service, port service) on one config, each over its own
    StorageService in its own directory. With ``mp`` (a monkeypatch) the
    k-means of both packages draw their initial rows alike
    (test_torch_ivf._same_init), so an IVF build is the same computation
    in either and their recalls compare the services' routes."""
    if mp is not None:
        _same_init(mp, 0)
    cfg = make_config(tmp_path, index_type, **extra)
    out = []
    for name, st_cls, svc_cls in (
            ("jax", JaxStorageService, JaxIndexingService),
            ("port", StorageService, IndexingService)):
        st = st_cls(str(tmp_path / name / "vdb"), dim=16, capacity=256)
        out.append(svc_cls(storage=st.storage, config_path=cfg))
    return out


def both(pair, method, *args, **kwargs):
    return [getattr(svc, method)(*args, **kwargs) for svc in pair]


def exact_ids(nodes, queries, k, allowed=None):
    keep = [n for n in nodes if allowed is None or n.id in allowed]
    x = np.stack([n.embedding for n in keep]).astype(np.float64)
    ids = np.array([n.id for n in keep])
    d = ((queries[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    return ids[np.argsort(d, 1)[:, :k]]


def ids_of(results):
    return [n.id for n, _ in results]


def search_ids(svc, queries, k, **kw):
    """One search call per query, ids padded with -1 to k."""
    rows = [ids_of(svc.search(q, k=k, **kw)) for q in queries]
    return np.array([r + [-1] * (k - len(r)) for r in rows])


def assert_recall_near_jax(pair, queries, truth, k, **kw):
    got = recall(search_ids(pair[1], queries, k, **kw), truth)
    want = recall(search_ids(pair[0], queries, k, **kw), truth)
    assert got >= want - RECALL_TOL, (got, want)
    return got


# ---- StorageService ----

def test_storage_service_validation(tmp_path):
    with pytest.raises(ValueError):
        StorageService(str(tmp_path / "x"), dim=0, capacity=10)
    with pytest.raises(ValueError):
        StorageService(str(tmp_path / "x"), dim=4, capacity=0)


def test_storage_service_crud(storage_service, rng):
    n = make_node(0, rng)
    storage_service.save(n)
    assert storage_service.size() == 1
    assert storage_service.get(0).content == "doc0"
    np.testing.assert_allclose(storage_service.get_embedding(0), n.embedding)
    storage_service.delete(0)
    assert storage_service.get(0) is None


def test_storage_service_file_naming(tmp_path, storage_service):
    assert (tmp_path / "vdb.embeddings.npy").exists()
    assert (tmp_path / "vdb.metadata.npy").exists()


def test_filter_by_metadata(storage_service, rng):
    for i in range(6):
        storage_service.save(make_node(i, rng))
    evens = storage_service.filter_by_metadata({"cat": "a"})
    assert evens == {0, 2, 4}
    assert storage_service.filter_by_metadata({"cat": "z"}) == set()
    assert storage_service.filter_by_metadata({}) == {0, 1, 2, 3, 4, 5}


def test_storage_cross_instance_persistence(tmp_path, rng):
    """The port's files reopen in the port and in the JAX package."""
    s1 = StorageService(str(tmp_path / "p"), dim=16, capacity=32)
    s1.save(make_node(7, rng))
    s1.close()
    s2 = StorageService(str(tmp_path / "p"), dim=16, capacity=32)
    assert s2.size() == 1
    assert s2.get(7).content == "doc7"
    assert s2.filter_by_metadata({"cat": "b"}) == {7}
    s2.close()
    s3 = JaxStorageService(str(tmp_path / "p"), dim=16, capacity=32)
    assert s3.get(7).content == "doc7"


# ---- IndexingService ----

def test_indexing_service_create_and_flags(storage_service, config_path, rng):
    svc = IndexingService(
        storage=storage_service.storage, config_path=config_path
    )
    assert not svc.is_index_loaded()
    assert not svc._index_modified
    assert svc.index.M == 4
    assert svc.index.ef_construction == 40
    assert svc.flush_threshold == 5
    assert svc.device == torch.device("cpu")
    assert svc.index.device == torch.device("cpu")
    svc.insert_node(make_node(0, rng))
    # below threshold: modified flag stays set, no save yet
    assert svc._index_modified
    assert not svc.index_file.exists()


def test_indexing_service_threshold_flush(storage_service, config_path, rng):
    svc = IndexingService(
        storage=storage_service.storage, config_path=config_path
    )
    for i in range(5):
        svc.insert_node(make_node(i, rng))
    # 5th insert hits flush_threshold=5 -> auto save
    assert svc.index_file.exists()
    assert not svc._index_modified


def test_indexing_service_load_existing(storage_service, config_path, rng):
    svc = IndexingService(
        storage=storage_service.storage, config_path=config_path
    )
    for i in range(6):
        svc.insert_node(make_node(i, rng))
    svc.save_index()

    svc2 = IndexingService(
        storage=storage_service.storage, config_path=config_path
    )
    assert svc2.is_index_loaded()
    assert svc2.get_index_size() == 6
    q = storage_service.get_embedding(3)
    results = svc2.search(np.asarray(q), k=1)
    assert results[0][0].id == 3


def test_indexing_service_save_semantics(storage_service, config_path, rng):
    svc = IndexingService(
        storage=storage_service.storage, config_path=config_path
    )
    svc.insert_node(make_node(0, rng))
    svc.save_index()
    assert not svc._index_modified
    mtime = svc.index_file.stat().st_mtime_ns
    svc.save_index()  # unmodified -> no rewrite
    assert svc.index_file.stat().st_mtime_ns == mtime
    svc.force_save_index()  # force -> rewrite
    assert svc.index_file.stat().st_mtime_ns >= mtime


def test_indexing_service_batch_insert(storage_service, config_path, rng):
    svc = IndexingService(
        storage=storage_service.storage, config_path=config_path
    )
    svc.insert_nodes([make_node(i, rng) for i in range(10)])
    assert svc.get_index_size() == 10
    # threshold 5 crossed; batched flushes complete in the background
    svc.wait_for_flush()
    assert svc.index_file.exists()


def test_embedding_service_fake_backend(config_path):
    svc = EmbeddingService(config_path)
    v = svc.embed_text("hello world")
    assert v.shape == (16,)
    # deterministic, and the JAX package's bits
    np.testing.assert_array_equal(v, svc.embed_text("hello world"))
    assert v.tobytes() == JaxEmbeddingService(config_path).embed_text(
        "hello world").tobytes()
    assert not np.allclose(v, svc.embed_text("other text"))
    m = svc.embed_texts(["a", "b", "c"])
    assert m.shape == (3, 16)
    np.testing.assert_array_equal(m[0], svc.embed_text("a"))


def test_embedding_service_dim_validation(tmp_path):
    cfg = {"embedding": {"model": "fake-8", "dimension": 8}}
    p = tmp_path / "c.yaml"
    p.write_text(yaml.safe_dump(cfg))
    svc = EmbeddingService(str(p))
    assert svc.embed_text("x").shape == (8,)
    assert svc.device == "cuda"  # the port's default
    svc._engine.dim = 9
    with pytest.raises(ValueError, match="configured dimension"):
        svc.embed_text("x")


def test_indexing_service_bulk_initial_load(tmp_path, config_path, rng):
    """A first batch of 4096 nodes into an empty hnsw goes to bulk_build
    (in both packages); recall@5 of the port's search against exact no
    more than RECALL_TOL under JAX's."""
    nodes = [Node(id=i, embedding=rng.standard_normal(16).astype(np.float32))
             for i in range(4096)]
    pair = []
    for name, st_cls, svc_cls in (
            ("jax", JaxStorageService, JaxIndexingService),
            ("port", StorageService, IndexingService)):
        big = st_cls(str(tmp_path / name / "big"), dim=16, capacity=8192)
        svc = svc_cls(storage=big.storage, config_path=config_path,
                      index_file=str(tmp_path / name / "big.idx.npz"))
        svc.insert_nodes(nodes)
        assert svc.get_index_size() == 4096
        assert big.get(7) is not None  # payloads stored
        pair.append(svc)
    port = pair[1]
    assert port.index.graph is not None and port.index._levels_host.max() >= 1
    res = port.search(nodes[7].embedding, k=1, ef=30)
    assert res[0][0].id == 7
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries, exact_ids(nodes, queries, 5), 5,
                           ef=30)


def test_batched_insert_async_flush(storage_service, config_path, rng):
    """Batched inserts past the threshold flush through the background
    writer (latest-wins snapshot); wait_for_flush() is the completion
    barrier and the written checkpoint loads cleanly."""
    svc = IndexingService(
        storage=storage_service.storage, config_path=config_path
    )
    assert svc._flush_async
    svc.insert_nodes([make_node(i, rng) for i in range(8)])
    svc.wait_for_flush()
    assert svc.index_file.exists()
    assert not svc._index_modified
    # no stale temp file left behind by the atomic rename
    leftovers = list(svc.index_file.parent.glob("*.tmp.npz"))
    assert leftovers == []

    svc2 = IndexingService(
        storage=storage_service.storage, config_path=config_path
    )
    assert svc2.is_index_loaded()
    assert svc2.get_index_size() == 8
    q = storage_service.get_embedding(3)
    results = svc2.search(np.asarray(q), k=1)
    assert results[0][0].id == 3


def test_single_insert_flush_stays_synchronous(
        storage_service, config_path, rng):
    """Reference parity (indexing_service.py:137-144): the checkpoint file
    exists as soon as the threshold-crossing single-node insert returns —
    no flush barrier needed on the reference's own surface."""
    svc = IndexingService(
        storage=storage_service.storage, config_path=config_path
    )
    for i in range(5):
        svc.insert_node(make_node(i, rng))
    assert svc.index_file.exists()


# ---- index types, against the JAX service ----

def test_flat_index_service(tmp_path, rng):
    pair = services(tmp_path, "flat")
    nodes = make_nodes(rng, 30)
    both(pair, "insert_nodes", nodes)
    svc = pair[1]
    assert svc.get_index_size() == 30
    res = svc.search(nodes[7].embedding, k=3)
    assert res[0][0].id == 7
    assert res[0][1] < 1e-3
    queries = rng.standard_normal((10, 16)).astype(np.float32)
    for q in queries:
        want, got = both(pair, "search", q, k=5)
        assert ids_of(got) == ids_of(want)
        np.testing.assert_allclose([d for _, d in got], [d for _, d in want],
                                   rtol=DIST_TOL, atol=DIST_TOL)
    assert (search_ids(svc, queries, 5) == exact_ids(nodes, queries, 5)).all()
    (dw, iw), (dg, ig) = both(pair, "search_batch", queries, 5,
                              filter_ids={1, 2, 3, 4, 5})
    np.testing.assert_array_equal(ig, iw)
    np.testing.assert_allclose(dg, dw, rtol=DIST_TOL, atol=DIST_TOL)


def test_flat_index_persistence(tmp_path, rng):
    cfg = make_config(tmp_path, "flat")
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 10)
    svc.insert_nodes(nodes)
    svc.save_index()

    svc2 = IndexingService(storage=storage.storage, config_path=cfg)
    assert svc2.is_index_loaded()
    assert svc2.get_index_size() == 10
    assert svc2.search(nodes[3].embedding, k=1)[0][0].id == 3


def test_flat_bf16_precision(tmp_path, rng):
    """bf16 scan mode: same contract as f32, near-identical ranking."""
    pair = services(tmp_path, "flat", precision="bf16")
    nodes = make_nodes(rng, 50)
    both(pair, "insert_nodes", nodes)
    svc = pair[1]
    res = svc.search(nodes[7].embedding, k=1)
    assert res[0][0].id == 7
    assert res[0][1] < 1e-3  # k survivors are exactly re-scored
    # mutations invalidate the mirror: a new node must be findable
    v = rng.standard_normal(16).astype(np.float32)
    svc.insert_node(Node(id=500, embedding=v))
    assert svc.search(v, k=1)[0][0].id == 500
    svc.delete_node(500)
    assert all(n.id != 500 for n, _ in svc.search(v, k=5))
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries, exact_ids(nodes, queries, 5), 5)


def test_ivf_index_service(tmp_path, rng, monkeypatch):
    pair = services(tmp_path, "ivf", monkeypatch, ivf_k=4)
    nodes = make_nodes(rng, 3)
    both(pair, "insert_nodes", nodes)
    svc = pair[1]
    # below ivf_k: pending queue, brute-force search still works
    assert svc.get_index_size() == 3
    assert svc.search(nodes[1].embedding, k=1)[0][0].id == 1

    more = make_nodes(rng, 30, start=100)
    both(pair, "insert_nodes", more)  # crosses ivf_k -> k-means build
    assert svc.index.centroids is not None
    assert svc.get_index_size() == 33

    res = svc.search(more[5].embedding, k=1, n_probe=4)
    assert res[0][0].id == 105

    # filter post-selection
    res = svc.search(nodes[0].embedding, k=5, n_probe=4,
                     filter_ids={n.id for n in nodes})
    assert {n.id for n, _ in res} <= {0, 1, 2}
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    for n_probe in (1, 2):
        assert_recall_near_jax(pair, queries,
                               exact_ids(nodes + more, queries, 5), 5,
                               n_probe=n_probe)


def test_ivf_delete(tmp_path, rng, monkeypatch):
    pair = services(tmp_path, "ivf", monkeypatch, ivf_k=4)
    nodes = make_nodes(rng, 20)
    both(pair, "insert_nodes", nodes)
    both(pair, "delete_node", 5)
    svc = pair[1]
    assert svc.get_index_size() == 19
    res = svc.search(nodes[5].embedding, k=5, n_probe=4)
    assert all(n.id != 5 for n, _ in res)
    assert ids_of(res) == ids_of(pair[0].search(nodes[5].embedding, k=5,
                                                n_probe=4))


def test_ivf_batch_filter_ids(tmp_path, rng, monkeypatch):
    """search_batch must honor filter_ids for IVF (filters often implement
    tenancy/ACL; dropping them silently leaks excluded documents)."""
    pair = services(tmp_path, "ivf", monkeypatch, ivf_k=4)
    nodes = make_nodes(rng, 40)
    both(pair, "insert_nodes", nodes)
    allowed = {n.id for n in nodes if n.metadata["par"] == 0}
    q = np.stack([nodes[1].embedding, nodes[2].embedding])
    (_, want), (_, ids) = both(pair, "search_batch", q, k=5, n_probe=4,
                               filter_ids=allowed)
    got = {int(i) for row in ids for i in row if i >= 0}
    assert got, "filtered batch search returned nothing"
    assert got <= allowed
    truth = exact_ids(nodes, q, 5, allowed=allowed)
    assert recall(ids, truth) >= recall(want, truth) - RECALL_TOL


def test_ivf_n_probe_changes_probing(tmp_path, rng):
    """n_probe must actually change probing: a query whose true nearest
    neighbor sits in its SECOND-nearest cluster misses it at n_probe=1 and
    finds it at n_probe=2."""
    cfg = make_config(tmp_path, "ivf", ivf_k=2)
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    c1 = np.zeros(16, np.float32); c1[0] = 10.0
    c2 = np.zeros(16, np.float32); c2[1] = 10.0
    nodes = []
    for i in range(10):  # tight cluster around c1
        v = c1 + 0.1 * rng.standard_normal(16).astype(np.float32)
        nodes.append(Node(id=i, embedding=v))
    for i in range(10, 20):  # tight cluster around c2
        v = c2 + 0.1 * rng.standard_normal(16).astype(np.float32)
        nodes.append(Node(id=i, embedding=v))
    # id 99: assigned to cluster 2 (closer to c2) but very close to the query
    p2 = np.zeros(16, np.float32); p2[0], p2[1] = 5.0, 6.0
    nodes.append(Node(id=99, embedding=p2))
    svc.insert_nodes(nodes)
    # query: nearest centroid is c1, but the true NN is p2 in cluster 2
    q = np.zeros(16, np.float32); q[0], q[1] = 6.0, 4.9
    near = svc.search(q, k=1, n_probe=1)
    far = svc.search(q, k=1, n_probe=2)
    assert far[0][0].id == 99
    assert near[0][0].id != 99
    # n_probe above ivf_k clamps, as in the JAX service
    assert svc.search(q, k=1, n_probe=50)[0][0].id == 99


def test_ivf_pq_via_config(tmp_path, rng, monkeypatch):
    """index.type: ivf + index.pq activates residual IVFADC probing once
    the corpus passes min_size (ivf_k 8 with n_probe 4: the probe; the
    full scan at n_probe >= ivf_k is test_ivf_pq_full_scan_via_config)."""
    pair = services(tmp_path, "ivf", monkeypatch, ivf_k=8,
                    pq={"chunks": 4, "ksub": 16, "min_size": 16,
                        "residual": True})
    nodes = make_nodes(rng, 64)
    both(pair, "insert_nodes", nodes)
    svc = pair[1]

    res = svc.search(nodes[9].embedding, k=3, n_probe=4)
    assert svc._pq_active
    assert svc.index._pq_residual
    assert res[0][0].id == 9  # exact rerank recovers the true neighbor

    # batch path also probes with PQ
    q = np.stack([nodes[5].embedding, nodes[11].embedding])
    _, ids = svc.search_batch(q, k=1, n_probe=4)
    assert ids[0, 0] == 5 and ids[1, 0] == 11

    fres = svc.search(nodes[9].embedding, k=5, n_probe=4,
                      filter_ids={n.id for n in nodes if n.id % 2 == 0})
    assert all(n.id % 2 == 0 for n, _ in fres)
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries, exact_ids(nodes, queries, 5), 5,
                           n_probe=4)


def test_ivf_pq_add_after_activation(tmp_path, rng, monkeypatch):
    """Nodes inserted after PQ activation must be findable via ADC (codes
    and correction scalars are maintained incrementally by IvfIndex.add)."""
    pair = services(tmp_path, "ivf", monkeypatch, ivf_k=8,
                    pq={"chunks": 4, "ksub": 16, "min_size": 16})
    both(pair, "insert_nodes", make_nodes(rng, 48))
    both(pair, "search", np.zeros(16, np.float32), k=1, n_probe=4)
    svc = pair[1]
    assert svc._pq_active

    late = Node(id=999, embedding=rng.standard_normal(16).astype(np.float32),
                metadata={})
    both(pair, "insert_nodes", [late])
    for s in pair:
        assert s.search(late.embedding, k=1, n_probe=4)[0][0].id == 999


def _hnsw_pair(tmp_path, rng, **extra):
    pair = services(tmp_path, "hnsw", **extra)
    nodes = make_nodes(rng, 40)
    both(pair, "insert_nodes", nodes)
    return pair, nodes


def test_hnsw_wide_mode_service(tmp_path, rng):
    """index.wide activates wide-beam traversal once min_size is crossed;
    self-query stays exact and the single-query path resolves Nodes."""
    pair, nodes = _hnsw_pair(
        tmp_path, rng,
        wide={"dims": 0, "seeds": 64, "frontier": 16, "steps": 8,
              "min_size": 16})
    svc = pair[1]
    res = svc.search(nodes[9].embedding, k=3, ef=32)
    assert svc._wide_active
    assert res[0][0].id == 9
    assert res[0][1] < 1e-3
    d, ids = svc.search_batch(
        np.stack([n.embedding for n in nodes[:4]]), k=1, ef=32)
    assert list(ids[:, 0]) == [0, 1, 2, 3]
    # filtered queries route to the masked scan by default
    # (index.filtered_engine: scan): only matching ids may appear, and
    # the true nearest matching node wins
    assert svc._filtered_engine == "scan"
    resf = svc.search(nodes[9].embedding, k=3, ef=32,
                      filter_ids={n.id for n in nodes[:5]})
    assert all(n.id < 5 for n, _ in resf)
    emb9 = nodes[9].embedding
    want = min(range(5),
               key=lambda i: float(np.sum((emb9 - nodes[i].embedding) ** 2)))
    assert resf[0][0].id == want
    # no card here: merge_kernel "auto" would be off; False by default
    assert not svc._resolve_merge_kernel()
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries, exact_ids(nodes, queries, 5), 5,
                           ef=32)
    allowed = {n.id for n in nodes if n.id % 3 == 0}
    assert_recall_near_jax(pair, queries,
                           exact_ids(nodes, queries, 5, allowed=allowed), 5,
                           ef=32, filter_ids=allowed)


def test_hnsw_filtered_engine_graph(tmp_path, rng):
    """index.filtered_engine: graph keeps the reference's
    navigate-but-exclude two-pool wide traversal for filtered queries."""
    pair, nodes = _hnsw_pair(
        tmp_path, rng, filtered_engine="graph",
        wide={"dims": 0, "seeds": 64, "frontier": 16, "steps": 8,
              "min_size": 16})
    svc = pair[1]
    assert svc._filtered_engine == "graph"
    allowed = {n.id for n in nodes[:5]}
    resf = svc.search(nodes[9].embedding, k=3, ef=32, filter_ids=allowed)
    assert svc._wide_active
    assert all(n.id < 5 for n, _ in resf)
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries,
                           exact_ids(nodes, queries, 3, allowed=allowed), 3,
                           ef=32, filter_ids=allowed)


def test_hnsw_wide_schedule_config(tmp_path, rng):
    """index.wide.schedule routes pool-mode queries through the
    per-segment frontier schedule."""
    pair, nodes = _hnsw_pair(
        tmp_path, rng,
        wide={"dims": 0, "seeds": 64, "min_size": 16,
              "schedule": [[32, 3], [16, 4]]})
    svc = pair[1]
    assert svc._wide_schedule == ((32, 3), (16, 4))
    res = svc.search(nodes[7].embedding, k=3, ef=32)
    assert svc._wide_active
    assert res[0][0].id == 7 and res[0][1] < 1e-3
    queries = rng.standard_normal((20, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries, exact_ids(nodes, queries, 5), 5,
                           ef=32)


def test_scan_batch_threshold_routing(tmp_path, rng, monkeypatch):
    """index.scan_batch_threshold routes big batches to the bf16 scan
    over the same table; small batches keep the wide graph path. Each
    route's answer equals the direct index call the JAX service makes."""
    pair, nodes = _hnsw_pair(
        tmp_path, rng, scan_batch_threshold=8,
        wide={"dims": 0, "seeds": 64, "min_size": 16})
    svc = pair[1]
    qs = np.stack([n.embedding for n in nodes[:8]])
    calls = []
    for name in ("search_batch_scan", "search_batch_wide"):
        real = getattr(svc.index, name)
        monkeypatch.setattr(svc.index, name, lambda *a, _r=real, _n=name,
                            **k: calls.append(_n) or _r(*a, **k))
    d, ids = svc.search_batch(qs, k=1)          # >= threshold -> scan
    assert list(ids[:, 0]) == list(range(8))
    d2, ids2 = svc.index.search_batch_scan(qs, 1, filter_ids=None)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(d, d2)
    _, ids3 = svc.search_batch(qs[:2], k=1, ef=32)  # below -> wide
    assert list(ids3[:, 0]) == [0, 1]
    assert calls == ["search_batch_scan", "search_batch_scan",
                     "search_batch_wide"]
    queries = rng.standard_normal((16, 16)).astype(np.float32)
    truth = exact_ids(nodes, queries, 5)
    (_, want), (_, got) = both(pair, "search_batch", queries, 5)
    assert recall(got, truth) >= recall(want, truth) - RECALL_TOL


# ---- the configs ported last, the device, both packages' files ----

@pytest.mark.parametrize("jax_test,index_type,extra,item", [
    ("test_sharded_hnsw_service", "sharded-hnsw", {}, "A7"),
    ("test_sharded_hnsw_multislice_config", "sharded-hnsw", {"slices": 2},
     "A7"),
    ("tests/services/test_autotune.py", "hnsw",
     {"autotune": {"target_recall": 0.9, "min_size": 16}}, "A6"),
])
def test_autotune_and_sharded_configs_construct_and_serve(
        tmp_path, monkeypatch, rng, jax_test, index_type, extra, item):
    """The configs that raised at construction until their ROADMAP item
    (``item``) was ported now construct and serve: sharded-hnsw over eight
    CPU shards (``make_mesh`` patched, as the JAX tests get eight virtual
    devices), ``index.slices: 2`` as the 2-D mesh, and autotune routing
    through a calibrated decision (``jax_test``'s first contract; the
    whole of each in test_torch_sharded.py and test_torch_autotune.py)."""
    from vector_db_tpu_torch.parallel import mesh as mesh_mod

    real = mesh_mod.make_mesh
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda n_devices=None,
                        devices=None: real(devices=["cpu"] * 8))
    cfg = make_config(tmp_path, index_type, **extra)
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 40)
    svc.insert_nodes(nodes)
    res = svc.search(nodes[9].embedding, k=3, ef=30)
    assert res[0][0].id == 9 and res[0][1] < 1e-3
    if index_type == "sharded-hnsw":
        assert svc.index.n_shards == 8
        assert len(svc.index.mesh.axis_names) == 1 + ("slices" in extra)
    else:
        assert list(svc._autotune.stats()) == ["b8@0.9"]


# ---- the PQ, RP and pool-free beam routes (test_index_types.py) ----

def test_hnsw_pq_via_config(tmp_path, rng, monkeypatch):
    """index.pq on hnsw: the first search past min_size trains PQ (both
    packages' k-means from the same initial rows) and traverses on ADC
    with an exact rerank; an insert marks the codes stale and the next
    search refreshes them and finds the new node. Equal to the direct
    search_batch_pq call (ef, expand 4). The JAX service flags the codes
    stale; the port's index keys them on its table version."""
    pair = services(tmp_path, "hnsw", monkeypatch,
                    pq={"chunks": 4, "ksub": 16, "min_size": 32})
    nodes = make_nodes(rng, 100)
    both(pair, "insert_nodes", nodes)
    stale = (lambda svc: svc._pq_stale,
             lambda svc: svc.index._pq_codes[0] != svc.index._version)
    for svc, is_stale in zip(pair, stale):
        res = svc.search(nodes[11].embedding, k=1, ef=40)
        assert svc._pq_active
        assert res[0][0].id == 11 and res[0][1] < 1e-2
        new = Node(id=500, embedding=rng.standard_normal(16).astype(
            np.float32))
        svc.insert_node(new)
        assert is_stale(svc)
        assert svc.search(new.embedding, k=1, ef=40)[0][0].id == 500
        assert not is_stale(svc)
    port = pair[1]
    q = nodes[3].embedding
    want = port.index.search_batch_pq(q[None, :], 5, ef=40, expand=4)
    got = port.search(q, k=5, ef=40)
    assert ids_of(got) == [int(i) for i in want[1][0] if i >= 0]
    np.testing.assert_allclose([d for _, d in got], want[0][0], rtol=1e-6)
    queries = rng.standard_normal((12, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries,
                           exact_ids(nodes + [new], queries, 5), 5, ef=40)


def test_pq_chunks_request_param(tmp_path, rng):
    """No config pq, but a request's pq_chunks activates PQ traversal on
    hnsw once the corpus is big enough (below min_size it serves the
    classic beam)."""
    cfg = make_config(tmp_path, "hnsw")
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    svc._pq_min_size = 32
    svc._pq_ksub = 16
    nodes = make_nodes(rng, 20)
    svc.insert_nodes(nodes)
    assert svc.search(nodes[5].embedding, k=1, ef=40,
                      pq_chunks=4)[0][0].id == 5
    assert not svc._pq_active
    svc.insert_nodes(make_nodes(rng, 60, start=20))
    res = svc.search(nodes[5].embedding, k=1, ef=40, pq_chunks=4)
    assert svc._pq_active and res[0][0].id == 5


def test_hnsw_rp_via_config(tmp_path, rng):
    """index.rp on hnsw: projected traversal past min_size, equal to the
    direct search_batch_rp call; a late insert is found (the mirror
    rebuilds); filtered searches take the f32 masked beam."""
    pair = services(tmp_path, "hnsw", rp={"dims": 8, "min_size": 16})
    nodes = make_nodes(rng, 48)
    both(pair, "insert_nodes", nodes)
    late = Node(id=777, embedding=rng.standard_normal(16).astype(np.float32),
                metadata={"par": 1})
    for svc in pair:
        assert svc.search(nodes[11].embedding, k=3, ef=40)[0][0].id == 11
        assert svc._rp_active
        svc.insert_nodes([late])
        assert svc.search(late.embedding, k=1, ef=40)[0][0].id == 777
        fres = svc.search(nodes[4].embedding, k=5,
                          filter_ids={n.id for n in nodes if n.id % 2 == 0})
        assert fres and all(n.id % 2 == 0 for n, _ in fres)
    port = pair[1]
    want = port.index.search_batch_rp(nodes[6].embedding[None, :], 3, ef=40,
                                      expand=4)
    got = port.search(nodes[6].embedding, k=3, ef=40)
    assert ids_of(got) == [int(i) for i in want[1][0] if i >= 0]
    queries = rng.standard_normal((12, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries,
                           exact_ids(nodes + [late], queries, 5), 5, ef=40)


@pytest.mark.parametrize("n_probe", [4, 8])
def test_ivf_rp_via_config(tmp_path, rng, monkeypatch, n_probe):
    """index.rp on ivf: RP probing (n_probe 4 of 8) and the full scan
    (n_probe = ivf_k); late adds are found; filters stay inside. Equal to
    the direct search_batch(rp=True) call."""
    pair = services(tmp_path, "ivf", monkeypatch, ivf_k=8,
                    rp={"dims": 8, "min_size": 16})
    nodes = make_nodes(rng, 64)
    both(pair, "insert_nodes", nodes)
    late = Node(id=999, embedding=rng.standard_normal(16).astype(np.float32),
                metadata={})
    for svc in pair:
        assert svc.search(nodes[9].embedding, k=3,
                          n_probe=n_probe)[0][0].id == 9
        assert svc._rp_active
        svc.insert_nodes([late])
        assert svc.search(late.embedding, k=1,
                          n_probe=n_probe)[0][0].id == 999
        fres = svc.search(nodes[8].embedding, k=5, n_probe=n_probe,
                          filter_ids={n.id for n in nodes if n.id % 2 == 0})
        assert all(n.id % 2 == 0 for n, _ in fres)
    port = pair[1]
    q = np.stack([n.embedding for n in nodes[:6]])
    want = port.index.search_batch(q, n_probe=n_probe, top_k=3, rp=True,
                                   filter_ids=None)
    got = port.search_batch(q, k=3, n_probe=n_probe)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    queries = rng.standard_normal((12, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries,
                           exact_ids(nodes + [late], queries, 5), 5,
                           n_probe=n_probe)


def test_ivf_pq_full_scan_via_config(tmp_path, rng, monkeypatch):
    """index.pq on ivf at n_probe = ivf_k: the full-scan IVF-PQ (the
    adc_topk route), equal to the direct call, recall near JAX's."""
    pair = services(tmp_path, "ivf", monkeypatch, ivf_k=8,
                    pq={"chunks": 4, "ksub": 16, "min_size": 16})
    nodes = make_nodes(rng, 64)
    both(pair, "insert_nodes", nodes)
    port = pair[1]
    assert port.search(nodes[9].embedding, k=3, n_probe=8)[0][0].id == 9
    assert port._pq_active
    q = np.stack([n.embedding for n in nodes[:6]])
    want = port.index.search_batch(q, n_probe=8, top_k=3, pq=True,
                                   filter_ids=None)
    got = port.search_batch(q, k=3, n_probe=8)
    np.testing.assert_array_equal(got[1], want[1])
    assert list(got[1][:, 0]) == [n.id for n in nodes[:6]]
    queries = rng.standard_normal((12, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries, exact_ids(nodes, queries, 5), 5,
                           n_probe=8)


@pytest.mark.parametrize("engine", ["scan", "graph"])
def test_hnsw_wide_beam_mode_service(tmp_path, rng, engine):
    """index.wide.mode: beam routes unfiltered hnsw queries (and, under
    filtered_engine: graph, filtered ones) to the pool-free beam, equal to
    the direct search_batch_beam call."""
    pair = services(tmp_path, "hnsw", filtered_engine=engine,
                    wide={"dims": 0, "seeds": 64, "frontier": 16,
                          "steps": 10, "min_size": 16, "mode": "beam"})
    nodes = make_nodes(rng, 40)
    both(pair, "insert_nodes", nodes)
    for svc in pair:
        res = svc.search(nodes[9].embedding, k=3, ef=32)
        assert svc._wide_active and svc._wide_mode == "beam"
        assert res[0][0].id == 9 and res[0][1] < 1e-3
        _, ids = svc.search_batch(
            np.stack([n.embedding for n in nodes[:4]]), k=1, ef=32)
        assert list(ids[:, 0]) == [0, 1, 2, 3]
    port = pair[1]
    q = np.stack([n.embedding for n in nodes[5:9]])
    allowed = {n.id for n in nodes if n.id % 2 == 0}
    for filt in (None, allowed):
        got = port.search_batch(q, k=3, filter_ids=filt)
        if filt is not None and engine == "scan":
            want = port.index.search_batch_scan(q, 3, filter_ids=filt)
        else:
            want = port.index.search_batch_beam(q, 3, frontier=16, steps=10,
                                                hist=2, filter_ids=filt)
        np.testing.assert_array_equal(got[1], want[1])
    queries = rng.standard_normal((12, 16)).astype(np.float32)
    assert_recall_near_jax(pair, queries, exact_ids(nodes, queries, 5), 5,
                           ef=32)


@pytest.mark.parametrize("device", ["cuda", "auto", "tpu", "CPU", "cpu"])
def test_config_device(tmp_path, device):
    """The config's device places the index: cpu on the CPU; cuda and the
    JAX package's auto and tpu on the card, raising without one (never the
    CPU quietly)."""
    cfg = make_config(tmp_path, "hnsw")
    raw = yaml.safe_load(open(cfg))
    raw["device"] = device
    open(cfg, "w").write(yaml.safe_dump(raw))
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    if device.lower() == "cpu" or torch.cuda.is_available():
        svc = IndexingService(storage=storage.storage, config_path=cfg)
        want = "cpu" if device.lower() == "cpu" else "cuda"
        assert svc.index.device.type == want
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IndexingService(storage=storage.storage, config_path=cfg)


@pytest.mark.parametrize("index_type,extra", [
    ("hnsw", {}), ("flat", {}), ("ivf", {"ivf_k": 4}),
    ("ivf", {"ivf_k": 8, "pq": {"chunks": 4, "ksub": 16, "min_size": 16}}),
])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_file_reopens_in_the_other_package(tmp_path, rng, index_type,
                                                 extra, writer):
    """An index file (and its storage) saved by one package's service is
    reopened by the other's, with the same size and the same answers."""
    cfg = make_config(tmp_path, index_type, **extra)
    classes = {"jax": (JaxStorageService, JaxIndexingService),
               "port": (StorageService, IndexingService)}
    reader = "port" if writer == "jax" else "jax"
    st_w, svc_w = classes[writer]
    st = st_w(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = svc_w(storage=st.storage, config_path=cfg)
    nodes = make_nodes(rng, 64)
    svc.insert_nodes(nodes)
    svc.delete_node(3)
    queries = rng.standard_normal((8, 16)).astype(np.float32)
    kw = {"n_probe": 4} if index_type == "ivf" else {"ef": 40}
    want = search_ids(svc, queries, 5, **kw)
    svc.force_save_index()
    st.close()

    st_r, svc_r = classes[reader]
    st2 = st_r(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc2 = svc_r(storage=st2.storage, config_path=cfg)
    assert svc2.is_index_loaded()
    assert svc2.get_index_size() == 63
    got = search_ids(svc2, queries, 5, **kw)
    assert 3 not in got
    if index_type == "hnsw":
        np.testing.assert_array_equal(got, want)  # one graph, same beam
    else:
        truth = exact_ids([n for n in nodes if n.id != 3], queries, 5)
        assert recall(got, truth) >= recall(want, truth) - RECALL_TOL


def test_searches_beside_inserts_see_whole_batches(tmp_path, rng):
    """Two threads: one streams batches of 32 into an hnsw service, the
    other searches meanwhile. Every answer equals the exact answer over
    the index as it stood before or after some whole batch (a search
    never reads a half-committed batch)."""
    cfg = make_config(tmp_path, "hnsw", scan_batch_threshold=4,
                      wide={"dims": 0, "seeds": 64, "min_size": 16})
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 192)
    svc.insert_nodes(nodes[:32])
    queries = np.stack([n.embedding for n in nodes[::12]])
    states = [exact_ids(nodes[:32 * (i + 1)], queries, 3) for i in range(6)]
    answers, errors = [], []

    def writer():
        try:
            for s in range(32, 192, 32):
                svc.insert_nodes(nodes[s:s + 32])
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=writer)
        t.start()
        while t.is_alive():
            answers.append(svc.search_batch(queries, 3)[1])  # the bf16 scan
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive()
    answers.append(svc.search_batch(queries, 3)[1])
    assert not errors
    for got in answers:
        assert any((got == s).all() for s in states), got
    assert (answers[-1] == states[-1]).all()
