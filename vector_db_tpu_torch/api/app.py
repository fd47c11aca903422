"""Indexing + search HTTP service (the port's copy of
vector_db_tpu/api/app.py).

Parity target: reference ``src/vector_db/api/app.py:16-233`` — same three
endpoints (``GET /health``, ``POST /embed``, ``POST /search``) with the
same request/response schemas, the same env vars (``CONFIG_PATH``,
``USE_EMBEDDING_SERVICE``, ``EMBEDDING_SERVICE_URL``), the same lifespan
behavior (build embedding client + storage + indexing services on startup,
save index + close client on shutdown, api/app.py:42-101), the same
metadata pre-filter with empty-filter short-circuit (api/app.py:183-192),
and the same error envelope (FastAPI-style ``{"detail": ...}`` on 5xx).

Differences:
- the HTTP layer is aiohttp (FastAPI is not available in this
  environment); routes, schemas, and env contract are unchanged;
- batch endpoints ``POST /embed/batch-docs`` and ``POST /search/batch``
  expose the engine's one-device-program batch paths;
- ``GET /metrics`` reports per-endpoint request counts and latency, and
  under ``program`` the engine's own counters, kernel launches and span
  totals (``observability.snapshot()``) — the observability the reference
  lacks (SURVEY.md §5: no tracing/metrics).

The index's device comes from the config's ``device`` through
``IndexingService``; ``GET /stats`` reports torch's view of the devices.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
from aiohttp import web
from pydantic import ValidationError

from vector_db_tpu_torch import observability
from vector_db_tpu_torch.api.models import (
    BatchInsertRequest,
    BatchQueryRequest,
    InsertRequest,
    QueryRequest,
)
from vector_db_tpu_torch.config import (
    ENV_CONFIG_PATH,
    ENV_EMBEDDING_SERVICE_URL,
    ENV_USE_EMBEDDING_SERVICE,
    load_config,
)
from vector_db_tpu_torch.services.embedding_client import SyncEmbeddingClient
from vector_db_tpu_torch.services.indexing_service import IndexingService
from vector_db_tpu_torch.services.storage_service import StorageService
from vector_db_tpu_torch.types import Node


class Metrics:
    """Per-endpoint request counters + latency accumulators."""

    def __init__(self) -> None:
        self.counts: Dict[str, int] = {}
        self.errors: Dict[str, int] = {}
        self.total_seconds: Dict[str, float] = {}

    def observe(self, endpoint: str, seconds: float, ok: bool) -> None:
        self.counts[endpoint] = self.counts.get(endpoint, 0) + 1
        self.total_seconds[endpoint] = (
            self.total_seconds.get(endpoint, 0.0) + seconds
        )
        if not ok:
            self.errors[endpoint] = self.errors.get(endpoint, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for ep, n in self.counts.items():
            out[ep] = {
                "requests": n,
                "errors": self.errors.get(ep, 0),
                "avg_latency_ms": 1000.0 * self.total_seconds[ep] / max(n, 1),
            }
        return out


def _error(status: int, detail: str) -> web.Response:
    return web.json_response({"detail": detail}, status=status)


async def _offload(request: web.Request, fn):
    """Run blocking work (sync embedding HTTP calls, device search — the
    first search on the card builds the kernels) in the default executor
    so the event loop keeps serving /health etc. The reference's sync
    FastAPI handlers get this from Starlette's threadpool for free; aiohttp
    handlers must opt in.
    """
    import asyncio

    return await asyncio.get_running_loop().run_in_executor(None, fn)


def _services(request: web.Request):
    app = request.app
    return app.get("embedding_client"), app.get("storage_service"), app.get(
        "indexing_service"
    )


@web.middleware
async def metrics_middleware(request: web.Request, handler):
    start = time.perf_counter()
    try:
        resp = await handler(request)
        ok = resp.status < 500
        return resp
    except Exception:
        ok = False
        raise
    finally:
        metrics: Metrics = request.app["metrics"]
        metrics.observe(
            f"{request.method} {request.path}", time.perf_counter() - start, ok
        )


async def health(request: web.Request) -> web.Response:
    _, storage_service, indexing_service = _services(request)
    return web.json_response(
        {
            "status": "healthy",
            "index_loaded": (
                indexing_service.is_index_loaded() if indexing_service else False
            ),
            "index_size": (
                indexing_service.get_index_size() if indexing_service else 0
            ),
            "storage_size": storage_service.size() if storage_service else 0,
            "index_modified": (
                indexing_service._index_modified if indexing_service else False
            ),
        }
    )


async def metrics_endpoint(request: web.Request) -> web.Response:
    return web.json_response({**request.app["metrics"].snapshot(),
                              "program": observability.snapshot()})


async def stats_endpoint(request: web.Request) -> web.Response:
    """Index/storage/device stats (the reference's only built-in metric is
    IvfIndex.get_cluster_stats, ivf.py:207-215 — here it is exposed, plus
    device info)."""
    _, storage_service, indexing_service = _services(request)
    from vector_db_tpu_torch.embedding.device import get_device_info

    out: Dict[str, Any] = {"device": get_device_info()}
    if indexing_service is not None:
        out["index"] = {
            "type": indexing_service.index_type,
            "size": indexing_service.get_index_size(),
            "flush_threshold": indexing_service.flush_threshold,
            "loaded_from_disk": indexing_service.is_index_loaded(),
        }
        if indexing_service.index_type == "ivf" and getattr(
            indexing_service.index, "centroids", None
        ) is not None:
            out["index"]["clusters"] = (
                indexing_service.index.get_cluster_stats()
            )
        tuner = getattr(indexing_service, "_autotune", None)
        if tuner is not None:
            out["index"]["autotune"] = tuner.stats()
    if storage_service is not None:
        out["storage"] = {
            "size": storage_service.size(),
            "capacity": storage_service.capacity,
            "dim": storage_service.dim,
        }
    return web.json_response(out)


async def embed_document(request: web.Request) -> web.Response:
    embedding_client, storage_service, indexing_service = _services(request)
    if embedding_client is None or storage_service is None or indexing_service is None:
        return _error(503, "Services not initialized")
    try:
        req = InsertRequest(**await request.json())
    except (ValidationError, ValueError) as e:
        return _error(422, str(e))
    try:
        embedding = await _offload(
            request, lambda: embedding_client.embed_text(req.content)
        )
        node_id = storage_service.get_next_id()
        node = Node(
            id=node_id,
            embedding=embedding,
            content=req.content,
            metadata=req.metadata or {},
        )
        storage_service.save(node)
        await _offload(request, lambda: indexing_service.insert_node(node))
        return web.json_response(
            {
                "status_code": 200,
                "message": (
                    f"Document embedded and stored successfully at index {node_id}"
                ),
                "error": None,
            }
        )
    except Exception as e:
        return _error(500, f"Error processing request: {e}")


async def embed_documents_batch(request: web.Request) -> web.Response:
    """Batch ingest: one embedding call + one device insert program."""
    embedding_client, storage_service, indexing_service = _services(request)
    if embedding_client is None or storage_service is None or indexing_service is None:
        return _error(503, "Services not initialized")
    try:
        req = BatchInsertRequest(**await request.json())
    except (ValidationError, ValueError) as e:
        return _error(422, str(e))
    try:
        embeddings = await _offload(
            request, lambda: embedding_client.embed_texts(req.contents)
        )
        metadatas = req.metadatas or [None] * len(req.contents)
        nodes = []
        for content, emb, meta in zip(req.contents, embeddings, metadatas):
            node_id = storage_service.get_next_id()
            nodes.append(Node(
                id=node_id, embedding=np.asarray(emb, np.float32),
                content=content, metadata=meta or {},
            ))
        # one flush per layer, not per document (2 msync/doc capped batch
        # ingest at ~67 docs/s)
        await _offload(request, lambda: storage_service.save_many(nodes))
        await _offload(request, lambda: indexing_service.insert_nodes(nodes))
        return web.json_response(
            {
                "status_code": 200,
                "ids": [n.id for n in nodes],
                "message": f"Embedded and stored {len(nodes)} documents",
                "error": None,
            }
        )
    except Exception as e:
        return _error(500, f"Error processing request: {e}")


async def search_index(request: web.Request) -> web.Response:
    embedding_client, storage_service, indexing_service = _services(request)
    if embedding_client is None or storage_service is None or indexing_service is None:
        return _error(503, "Services not initialized")
    try:
        req = QueryRequest(**await request.json())
    except (ValidationError, ValueError) as e:
        return _error(422, str(e))
    try:
        query_embedding = await _offload(
            request, lambda: embedding_client.embed_text(req.query)
        )

        filter_ids = None
        if req.metadata_filter:
            filter_ids = storage_service.filter_by_metadata(req.metadata_filter)
            if not filter_ids:
                # empty-filter short-circuit (reference api/app.py:187-192)
                return web.json_response(
                    {"status_code": 200, "results": [], "error": None}
                )

        search_kwargs: Dict[str, Any] = {
            "ef": req.ef,
            "filter_ids": filter_ids,
            "n_probe": req.n_probe,  # honored by IVF, ignored elsewhere
        }
        if req.pq_chunks:
            search_kwargs["pq_chunks"] = req.pq_chunks
        if req.params:
            search_kwargs.update(req.params)

        results = await _offload(
            request,
            lambda: indexing_service.search(
                query=query_embedding, k=req.top_k, **search_kwargs
            ),
        )
        formatted = [
            {
                "id": node.id,
                "content": node.content,
                "metadata": node.metadata,
                "distance": float(dist),
            }
            for node, dist in results
        ]
        return web.json_response(
            {"status_code": 200, "results": formatted, "error": None}
        )
    except Exception as e:
        return _error(500, f"Error processing search: {e}")


async def search_index_batch(request: web.Request) -> web.Response:
    """Batch search: embeds all queries at once and answers them in a
    single device program via search_batch."""
    embedding_client, storage_service, indexing_service = _services(request)
    if embedding_client is None or storage_service is None or indexing_service is None:
        return _error(503, "Services not initialized")
    try:
        req = BatchQueryRequest(**await request.json())
    except (ValidationError, ValueError) as e:
        return _error(422, str(e))
    try:
        queries = await _offload(
            request, lambda: embedding_client.embed_texts(req.queries)
        )
        filter_ids = None
        if req.metadata_filter:
            filter_ids = storage_service.filter_by_metadata(req.metadata_filter)
            if not filter_ids:
                return web.json_response(
                    {
                        "status_code": 200,
                        "results": [[] for _ in req.queries],
                        "error": None,
                    }
                )
        dists, ids = await _offload(
            request,
            lambda: indexing_service.search_batch(
                np.asarray(queries, np.float32), req.top_k, ef=req.ef,
                filter_ids=filter_ids, n_probe=req.n_probe,
            ),
        )
        results = []
        for row_ids, row_d in zip(ids, dists):
            row = []
            for nid, d in zip(row_ids, row_d):
                if nid < 0:
                    continue
                node = storage_service.get(int(nid))
                if node is None:
                    continue
                row.append(
                    {
                        "id": node.id,
                        "content": node.content,
                        "metadata": node.metadata,
                        "distance": float(d),
                    }
                )
            results.append(row)
        return web.json_response(
            {"status_code": 200, "results": results, "error": None}
        )
    except Exception as e:
        return _error(500, f"Error processing search: {e}")


def create_app(
    config_path: Optional[str] = None,
    embedding_client: Optional[Any] = None,
    storage_service: Optional[StorageService] = None,
    indexing_service: Optional[IndexingService] = None,
) -> web.Application:
    """Build the indexing service app.

    Pre-built services may be injected (the test pattern the reference uses
    by overriding app module globals, tests/integration/test_search_api.py:66-90);
    anything not injected is built on startup from the config.
    """
    # 64 MB body cap: aiohttp defaults to 1 MB which rejects realistic
    # /embed/batch-docs payloads; the reference's FastAPI/uvicorn stack
    # enforces no request-size limit at all (api/app.py:119-233)
    app = web.Application(middlewares=[metrics_middleware],
                          client_max_size=64 * 1024**2)
    app["metrics"] = Metrics()
    app["config_path"] = config_path or os.getenv(ENV_CONFIG_PATH)
    app["embedding_client"] = embedding_client
    app["storage_service"] = storage_service
    app["indexing_service"] = indexing_service

    async def on_startup(app: web.Application) -> None:
        cfg_path = app["config_path"]
        config = load_config(cfg_path)
        vdb = config.get("vector_db", {})
        emb_cfg = config.get("embedding", {})

        use_http = (
            os.getenv(ENV_USE_EMBEDDING_SERVICE, "true").lower() == "true"
        )
        if app["embedding_client"] is None:
            if use_http:
                url = os.getenv(
                    ENV_EMBEDDING_SERVICE_URL, "http://embedding-service:8001"
                )
                client = SyncEmbeddingClient(base_url=url)
                if not client.health_check():
                    print(
                        f"Warning: Embedding service at {url} is not healthy"
                    )
                app["embedding_client"] = client
            else:
                from vector_db_tpu_torch.services.embedding_service import (
                    EmbeddingService,
                )

                app["embedding_client"] = EmbeddingService(cfg_path)
        if app["storage_service"] is None:
            app["storage_service"] = StorageService(
                file_path=vdb.get("file_path", "../vector_db"),
                dim=emb_cfg.get("dimension", 384),
                capacity=vdb.get("capacity", 1_000_000),
            )
        if app["indexing_service"] is None:
            file_path = vdb.get("file_path", "../vector_db")
            index_file = Path(file_path).with_suffix(".index.npz")
            app["indexing_service"] = IndexingService(
                storage=app["storage_service"].storage,
                config_path=str(cfg_path) if cfg_path else "",
                index_file=str(index_file),
            )

        # Warm the search path so the first user request does not pay the
        # kernels' build (nvcc on the card). Runs in a worker thread so the
        # server accepts requests immediately; best-effort, it reports its
        # own failure and serving goes on. Opt out with VDB_TPU_WARMUP=0.
        if os.getenv("VDB_TPU_WARMUP", "1") == "1":
            import asyncio

            svc = app["indexing_service"]
            dim = int(config.get("embedding", {}).get("dimension", 384))

            def _warm() -> None:
                try:
                    if svc.get_index_size() > 0:
                        t0 = time.perf_counter()
                        svc.search(np.zeros((dim,), np.float32), k=1)
                        print(
                            f"Search path warm "
                            f"({time.perf_counter() - t0:.1f}s)"
                        )
                except Exception as e:  # warmup is best-effort
                    print(f"Warning: search warmup failed: {e}")

            asyncio.get_running_loop().run_in_executor(None, _warm)

    async def on_cleanup(app: web.Application) -> None:
        # shutdown parity (reference api/app.py:96-101)
        if app["indexing_service"] is not None:
            app["indexing_service"].save_index()
        client = app["embedding_client"]
        if client is not None and hasattr(client, "close"):
            res = client.close()
            if res is not None and hasattr(res, "__await__"):
                await res

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)

    app.router.add_get("/health", health)
    app.router.add_get("/metrics", metrics_endpoint)
    app.router.add_get("/stats", stats_endpoint)
    app.router.add_post("/embed", embed_document)
    app.router.add_post("/embed/batch-docs", embed_documents_batch)
    app.router.add_post("/search", search_index)
    app.router.add_post("/search/batch", search_index_batch)
    return app


def main() -> None:  # pragma: no cover - manual entry point
    web.run_app(create_app(), port=int(os.getenv("PORT", "8000")))


if __name__ == "__main__":  # pragma: no cover
    main()
