"""sentence-transformers embedding engine (optional dependency; the port's
copy of vector_db_tpu/embedding/st.py).

Parity target: reference ``EmbeddingService``
(src/vector_db/inference/embedding.py:8-52): wraps a SentenceTransformer,
moves it to the selected device, exposes ``embed_text`` / ``embed_texts``
returning numpy. ``sentence_transformers`` is imported when a model is
built, not when this module is; the model's device comes from
``embedding.device.get_device`` (auto -> cuda -> mps -> cpu).
"""

from __future__ import annotations

import importlib.util
from typing import Optional, Sequence

import numpy as np

from vector_db_tpu_torch.embedding.device import get_device

# bound on the first model build (tests patch it with a fake class)
SentenceTransformer = None


def has_sentence_transformers() -> bool:
    return (SentenceTransformer is not None
            or importlib.util.find_spec("sentence_transformers") is not None)


class SentenceTransformerEmbedder:
    def __init__(self, model_name: str, device: Optional[str] = None) -> None:
        global SentenceTransformer
        if SentenceTransformer is None:
            try:
                from sentence_transformers import SentenceTransformer as cls
            except Exception as e:  # absent or broken optional dependency
                raise RuntimeError(
                    "sentence-transformers is not installed; use the fake "
                    "embedder (model name 'fake-<dim>') or install the "
                    "'embedding' extra"
                ) from e
            SentenceTransformer = cls
        self.model_name = model_name
        self.model = SentenceTransformer(model_name,
                                         device=get_device(device or "auto"))
        self.dim = int(self.model.get_sentence_embedding_dimension())

    def embed_text(self, text: str) -> np.ndarray:
        return np.asarray(
            self.model.encode(text, convert_to_numpy=True), np.float32
        )

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray(
            self.model.encode(list(texts), convert_to_numpy=True), np.float32
        )

    def close(self) -> None:
        pass
