"""Deterministic fake embedder (the port's copy of
vector_db_tpu/embedding/fake.py: the same text gives the same bits in
both packages).

The reference fakes its embedding model in tests by injecting MagicMocks
(tests/inference/test_embedding.py:8-10); here the fake is a real,
deterministic component: text -> sha256 -> seeded normal vector ->
L2-normalize. Same text always embeds identically, across processes, with
no model download — it is the offline default and the test backend.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


class HashingEmbedder:
    """Deterministic text embedder (no model weights)."""

    def __init__(self, dimension: int = 384) -> None:
        if dimension <= 0:
            raise ValueError("dimension must be positive")
        self.dim = int(dimension)
        self.model_name = f"fake-{self.dim}"

    def _vector(self, text: str) -> np.ndarray:
        digest = hashlib.sha256(text.encode("utf-8")).digest()
        seed = int.from_bytes(digest[:8], "little")
        rs = np.random.RandomState(np.uint32(seed % (2**32)))
        v = rs.standard_normal(self.dim).astype(np.float32)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def embed_text(self, text: str) -> np.ndarray:
        return self._vector(text)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self._vector(t) for t in texts])

    def close(self) -> None:
        pass
