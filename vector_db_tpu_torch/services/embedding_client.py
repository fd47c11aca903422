"""HTTP clients for the embedding service (the port's copy of
vector_db_tpu/services/embedding_client.py; the only module of the port
that imports httpx).

Parity target: reference ``EmbeddingClient`` / ``SyncEmbeddingClient``
(src/vector_db/services/embedding_client.py:9-163): httpx async and sync
clients for ``POST /embed``, ``POST /embed/batch``, ``GET /health`` —
the inter-service transport at the user-facing edge.
"""

from __future__ import annotations

from typing import Sequence

import httpx
import numpy as np

DEFAULT_URL = "http://embedding-service:8001"


class EmbeddingClient:
    """Async client (reference embedding_client.py:9-85)."""

    def __init__(self, base_url: str = DEFAULT_URL, timeout: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._client = httpx.AsyncClient(timeout=timeout)

    async def embed_text(self, text: str) -> np.ndarray:
        r = await self._client.post(
            f"{self.base_url}/embed", json={"text": text}
        )
        r.raise_for_status()
        return np.array(r.json()["embedding"], np.float32)

    async def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        # batch calls scale the read timeout with batch size: a 20k-doc
        # /embed/batch on a loaded host legitimately exceeds the 30s
        # single-call budget (observed as a spurious 500 at the API edge)
        r = await self._client.post(
            f"{self.base_url}/embed/batch", json={"texts": list(texts)},
            timeout=httpx.Timeout(self.timeout, read=max(
                self.timeout, 0.02 * len(texts) + self.timeout)),
        )
        r.raise_for_status()
        return np.array(r.json()["embeddings"], np.float32)

    async def health_check(self) -> bool:
        try:
            r = await self._client.get(f"{self.base_url}/health")
            return r.status_code == 200
        except Exception:
            return False

    async def close(self) -> None:
        await self._client.aclose()


class SyncEmbeddingClient:
    """Sync client (reference embedding_client.py:88-163)."""

    def __init__(self, base_url: str = DEFAULT_URL, timeout: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._client = httpx.Client(timeout=timeout)

    def embed_text(self, text: str) -> np.ndarray:
        r = self._client.post(f"{self.base_url}/embed", json={"text": text})
        r.raise_for_status()
        return np.array(r.json()["embedding"], np.float32)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        # see EmbeddingClient.embed_texts: read timeout scales with batch
        r = self._client.post(
            f"{self.base_url}/embed/batch", json={"texts": list(texts)},
            timeout=httpx.Timeout(self.timeout, read=max(
                self.timeout, 0.02 * len(texts) + self.timeout)),
        )
        r.raise_for_status()
        return np.array(r.json()["embeddings"], np.float32)

    def health_check(self) -> bool:
        try:
            r = self._client.get(f"{self.base_url}/health")
            return r.status_code == 200
        except Exception:
            return False

    def close(self) -> None:
        self._client.close()
