"""Standalone embedding HTTP service (the port's copy of
vector_db_tpu/api/embedding_app.py).

Parity target: reference ``docker/embedding-service/app.py:16-96`` — the
second microservice (:8001): ``POST /embed`` -> {embedding, dimension},
``POST /embed/batch`` -> {embeddings, dimension, count}, ``GET /health``.
Built on aiohttp (FastAPI not available in this environment).
"""

from __future__ import annotations

import os
from typing import Optional

from aiohttp import web

from vector_db_tpu_torch.config import ENV_CONFIG_PATH
from vector_db_tpu_torch.services.embedding_service import EmbeddingService


def _error(status: int, detail: str) -> web.Response:
    return web.json_response({"detail": detail}, status=status)


async def embed_text(request: web.Request) -> web.Response:
    svc: Optional[EmbeddingService] = request.app.get("embedding_service")
    if svc is None:
        return _error(503, "Embedding service not initialized")
    try:
        body = await request.json()
        text = body["text"]
    except Exception as e:
        return _error(422, str(e))
    try:
        emb = svc.embed_text(text)
        return web.json_response(
            {"embedding": emb.tolist(), "dimension": int(emb.shape[0])}
        )
    except Exception as e:
        return _error(500, f"Error embedding text: {e}")


async def embed_texts(request: web.Request) -> web.Response:
    svc: Optional[EmbeddingService] = request.app.get("embedding_service")
    if svc is None:
        return _error(503, "Embedding service not initialized")
    try:
        body = await request.json()
        texts = body["texts"]
    except Exception as e:
        return _error(422, str(e))
    try:
        embs = svc.embed_texts(texts)
        return web.json_response(
            {
                "embeddings": embs.tolist(),
                "dimension": int(embs.shape[1]) if embs.size else svc.dim,
                "count": int(embs.shape[0]),
            }
        )
    except Exception as e:
        return _error(500, f"Error embedding texts: {e}")


async def health(request: web.Request) -> web.Response:
    svc: Optional[EmbeddingService] = request.app.get("embedding_service")
    return web.json_response(
        {
            "status": "healthy" if svc is not None else "initializing",
            "model": svc.model_name if svc else None,
            "dimension": svc.dim if svc else None,
        }
    )


def create_app(config_path: Optional[str] = None) -> web.Application:
    app = web.Application()
    app["config_path"] = config_path or os.getenv(ENV_CONFIG_PATH)

    async def on_startup(app: web.Application) -> None:
        app["embedding_service"] = EmbeddingService(app["config_path"])

    app.on_startup.append(on_startup)
    app.router.add_post("/embed", embed_text)
    app.router.add_post("/embed/batch", embed_texts)
    app.router.add_get("/health", health)
    return app


def main() -> None:  # pragma: no cover - manual entry point
    web.run_app(create_app(), port=int(os.getenv("PORT", "8001")))


if __name__ == "__main__":  # pragma: no cover
    main()
