"""The contracts of tests/integration/test_api.py over the port's apps
(vector_db_tpu_torch.api.app and .embedding_app) on the CPU
(``device: cpu``): insert-then-search over real storage/indexing services
with a deterministic embedder, metadata filter semantics, empty-filter
short-circuit, extra-params passthrough — plus the embedding service app,
the batch endpoints, and /stats reporting torch's device view. The fake
embedder gives the JAX package's bits, so the same documents embed alike
in both stacks.

Driven through aiohttp's TestClient with asyncio.run (no pytest-asyncio).
"""

import asyncio

import numpy as np
import pytest
import torch
import yaml

from aiohttp.test_utils import TestClient, TestServer

from vector_db_tpu_torch.api.app import create_app
from vector_db_tpu_torch.api.embedding_app import create_app as create_embedding_app
from vector_db_tpu_torch.services.embedding_service import EmbeddingService
from vector_db_tpu_torch.services.indexing_service import IndexingService
from vector_db_tpu_torch.services.storage_service import StorageService
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def config_path(tmp_path):
    cfg = {
        "embedding": {"model": "fake-32", "dimension": 32},
        "device": "cpu",
        "index": {"ef_construction": 40, "M": 4, "flush_threshold": 100},
        "vector_db": {
            "file_path": str(tmp_path / "vdb"),
            "dimension": 32,
            "capacity": 256,
        },
    }
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def run(coro):
    return asyncio.run(coro)


async def _client_for(config_path, tmp_path):
    embedding = EmbeddingService(config_path)
    storage = StorageService(str(tmp_path / "vdb"), dim=32, capacity=256)
    indexing = IndexingService(
        storage=storage.storage, config_path=config_path,
        index_file=str(tmp_path / "vdb.index.npz"),
    )
    app = create_app(
        config_path=config_path,
        embedding_client=embedding,
        storage_service=storage,
        indexing_service=indexing,
    )
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def test_health(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        r = await client.get("/health")
        assert r.status == 200
        body = await r.json()
        assert body["status"] == "healthy"
        assert body["index_size"] == 0
        assert body["storage_size"] == 0
        assert body["index_loaded"] is False
        await client.close()

    run(go())


def test_insert_then_search(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        docs = ["the cat sat", "a dog barked", "quantum mechanics", "tpu kernels"]
        for d in docs:
            r = await client.post(
                "/embed", json={"content": d, "metadata": {"kind": "test"}}
            )
            assert r.status == 200
            body = await r.json()
            assert body["status_code"] == 200

        r = await client.get("/health")
        body = await r.json()
        assert body["index_size"] == 4
        assert body["storage_size"] == 4
        assert body["index_modified"] is True

        r = await client.post(
            "/search", json={"query": "the cat sat", "top_k": 2}
        )
        assert r.status == 200
        body = await r.json()
        assert body["status_code"] == 200
        results = body["results"]
        assert len(results) == 2
        # same text embeds identically -> exact match first with distance ~0
        assert results[0]["content"] == "the cat sat"
        assert results[0]["distance"] < 1e-3
        assert results[0]["metadata"] == {"kind": "test"}
        await client.close()

    run(go())


def test_metadata_filter(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        for i, cat in enumerate(["a", "b", "a", "b", "a"]):
            await client.post(
                "/embed", json={"content": f"document {i}", "metadata": {"cat": cat}}
            )
        r = await client.post(
            "/search",
            json={"query": "document 1", "top_k": 5,
                  "metadata_filter": {"cat": "a"}},
        )
        body = await r.json()
        cats = {res["metadata"]["cat"] for res in body["results"]}
        assert cats == {"a"}
        assert len(body["results"]) == 3
        await client.close()

    run(go())


def test_empty_filter_short_circuit(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        await client.post("/embed", json={"content": "only doc"})
        r = await client.post(
            "/search",
            json={"query": "only doc", "top_k": 5,
                  "metadata_filter": {"cat": "missing"}},
        )
        body = await r.json()
        assert body["status_code"] == 200
        assert body["results"] == []
        await client.close()

    run(go())


def test_extra_params_passthrough(config_path, tmp_path):
    async def go():
        # Unknown params must be ignored by the index (reference
        # hnsw.py:330-341 accepts **kwargs).
        client = await _client_for(config_path, tmp_path)
        await client.post("/embed", json={"content": "something"})
        r = await client.post(
            "/search",
            json={"query": "something", "top_k": 1, "pq_chunks": 4,
                  "params": {"bogus_knob": 7}},
        )
        assert r.status == 200
        body = await r.json()
        assert body["status_code"] == 200
        assert len(body["results"]) == 1
        await client.close()

    run(go())


def test_batch_endpoints(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        docs = [f"batch doc {i}" for i in range(8)]
        r = await client.post(
            "/embed/batch-docs",
            json={"contents": docs,
                  "metadatas": [{"i": i} for i in range(8)]},
        )
        assert r.status == 200
        body = await r.json()
        assert len(body["ids"]) == 8

        r = await client.post(
            "/search/batch",
            json={"queries": ["batch doc 0", "batch doc 5"], "top_k": 1},
        )
        body = await r.json()
        assert body["status_code"] == 200
        assert body["results"][0][0]["content"] == "batch doc 0"
        assert body["results"][1][0]["content"] == "batch doc 5"

        r = await client.get("/metrics")
        m = await r.json()
        assert m["POST /embed/batch-docs"]["requests"] == 1
        assert m["POST /search/batch"]["errors"] == 0
        prog = m["program"]
        assert set(prog) == {"counters", "launches", "spans"}
        # the one batch search above took the classic HNSW route
        assert prog["counters"]["search.requests.hnsw"] >= 1
        assert prog["counters"]["search.queries.hnsw"] >= 2
        assert prog["counters"]["service.lock_wait_ns"] >= 0
        assert "adc_topk" in prog["launches"]
        await client.close()

    run(go())


def test_validation_error_is_422(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        r = await client.post("/embed", json={"not_content": "x"})
        assert r.status == 422
        await client.close()

    run(go())


def test_embedding_service_app(config_path):
    async def go():
        app = create_embedding_app(config_path=config_path)
        client = TestClient(TestServer(app))
        await client.start_server()

        r = await client.get("/health")
        body = await r.json()
        assert body["status"] == "healthy"
        assert body["dimension"] == 32

        r = await client.post("/embed", json={"text": "hello"})
        assert r.status == 200
        body = await r.json()
        assert body["dimension"] == 32
        assert len(body["embedding"]) == 32

        r = await client.post("/embed/batch", json={"texts": ["a", "b"]})
        body = await r.json()
        assert body["count"] == 2
        assert len(body["embeddings"]) == 2
        # determinism across single and batch paths
        r2 = await client.post("/embed", json={"text": "a"})
        single = (await r2.json())["embedding"]
        assert np.allclose(single, body["embeddings"][0])
        await client.close()

    run(go())


def test_stats_endpoint(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        await client.post("/embed", json={"content": "a doc"})
        r = await client.get("/stats")
        assert r.status == 200
        body = await r.json()
        assert body["index"]["type"] == "hnsw"
        assert body["index"]["size"] == 1
        assert body["storage"]["size"] == 1
        assert body["storage"]["dim"] == 32
        dev = body["device"]
        assert set(dev) == {"selected", "accelerator_available",
                            "device_count", "platforms", "devices",
                            "backend"}
        assert dev["backend"] == ("cuda" if torch.cuda.is_available()
                                  else "cpu")
        await client.close()

    run(go())


def test_n_probe_forwarded_to_service(config_path, tmp_path):
    """QueryRequest.n_probe must reach the index (the reference accepts it
    in its schema but its HNSW-only service drops it; our IVF honors it)."""
    seen = {}

    async def go():
        embedding = EmbeddingService(config_path)
        storage = StorageService(str(tmp_path / "vdb"), dim=32, capacity=256)
        indexing = IndexingService(
            storage=storage.storage, config_path=config_path,
            index_file=str(tmp_path / "vdb.index.npz"),
        )
        orig = indexing.search

        def spy(query, k, **kwargs):
            seen.update(kwargs)
            return orig(query, k, **kwargs)

        indexing.search = spy
        from vector_db_tpu_torch.api.app import create_app as mk
        app = mk(config_path=config_path, embedding_client=embedding,
                 storage_service=storage, indexing_service=indexing)
        client = TestClient(TestServer(app))
        await client.start_server()
        await client.post("/embed", json={"content": "a doc"})
        r = await client.post(
            "/search", json={"query": "a doc", "top_k": 1, "n_probe": 3}
        )
        assert r.status == 200
        await client.close()

    run(go())
    assert seen.get("n_probe") == 3


def test_startup_builds_services_from_config(config_path, tmp_path,
                                             monkeypatch):
    """Nothing injected: on startup the app builds the embedding service
    (USE_EMBEDDING_SERVICE=false), storage and indexing services from the
    config, on its device; shutdown saves the index, and a second app on
    the same files serves it from disk."""
    monkeypatch.setenv("USE_EMBEDDING_SERVICE", "false")

    async def go(first):
        app = create_app(config_path=config_path)
        client = TestClient(TestServer(app))
        await client.start_server()
        svc = app["indexing_service"]
        assert svc.index.device.type == "cpu"
        if first:
            r = await client.post("/embed/batch-docs", json={
                "contents": [f"startup doc {i}" for i in range(6)]})
            assert r.status == 200
        r = await client.post("/search", json={"query": "startup doc 4",
                                               "top_k": 1})
        body = await r.json()
        assert body["results"][0]["content"] == "startup doc 4"
        loaded = (await (await client.get("/health")).json())["index_loaded"]
        await client.close()
        return loaded

    assert run(go(True)) is False
    assert (tmp_path / "vdb.index.npz").exists()
    assert run(go(False)) is True


def test_same_answers_as_the_jax_app(config_path, tmp_path):
    """The same requests through the JAX app and the port's, each over its
    own files: the same documents come back in the same order, with
    distances within 1e-5."""
    from vector_db_tpu.api.app import create_app as jax_create_app
    from vector_db_tpu.services.embedding_service import (
        EmbeddingService as JaxEmbedding)
    from vector_db_tpu.services.indexing_service import (
        IndexingService as JaxIndexing)
    from vector_db_tpu.services.storage_service import (
        StorageService as JaxStorage)

    async def answers(make_app, emb_cls, st_cls, svc_cls, where):
        storage = st_cls(str(where / "vdb"), dim=32, capacity=256)
        app = make_app(config_path=config_path,
                       embedding_client=emb_cls(config_path),
                       storage_service=storage,
                       indexing_service=svc_cls(
                           storage=storage.storage, config_path=config_path,
                           index_file=str(where / "vdb.index.npz")))
        client = TestClient(TestServer(app))
        await client.start_server()
        await client.post("/embed/batch-docs", json={
            "contents": [f"parity doc {i}" for i in range(24)],
            "metadatas": [{"g": i % 3} for i in range(24)]})
        out = []
        for body in ({"query": "parity doc 5", "top_k": 4},
                     {"query": "something else", "top_k": 4,
                      "metadata_filter": {"g": 1}}):
            r = await client.post("/search", json=body)
            out.append((await r.json())["results"])
        r = await client.post("/search/batch", json={
            "queries": ["parity doc 1", "parity doc 9"], "top_k": 3})
        out.extend((await r.json())["results"])
        await client.close()
        return out

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = run(answers(jax_create_app, JaxEmbedding, JaxStorage,
                       JaxIndexing, tmp_path / "jax"))
    got = run(answers(create_app, EmbeddingService, StorageService,
                      IndexingService, tmp_path / "port"))
    for g, w in zip(got, want):
        assert [r["content"] for r in g] == [r["content"] for r in w]
        np.testing.assert_allclose([r["distance"] for r in g],
                                   [r["distance"] for r in w],
                                   rtol=1e-5, atol=1e-5)
