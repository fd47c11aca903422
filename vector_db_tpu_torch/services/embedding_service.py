"""Config-driven embedding service (the port's copy of
vector_db_tpu/services/embedding_service.py).

Parity target: reference services ``EmbeddingService``
(src/vector_db/services/embedding_service.py:23-121): constructed from the
YAML config (model name / dimension / device), validates output dimensions
on every call, and raises if the heavyweight backend is unavailable.

Backend selection: a model name of the form ``fake-<dim>`` (or ``fake``)
selects the deterministic HashingEmbedder — the offline/test backend the
reference lacks (it mocks modules in tests instead). Any other model name
requires sentence-transformers (same failure mode as the reference,
embedding_service.py:45-49).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from vector_db_tpu_torch.config import load_config
from vector_db_tpu_torch.embedding.fake import HashingEmbedder


class EmbeddingService:
    def __init__(self, config_path: Optional[Union[str, Path]] = None) -> None:
        config = load_config(config_path)
        emb = config.get("embedding", {})
        self.model_name: str = emb.get(
            "model", "sentence-transformers/all-MiniLM-L6-v2"
        )
        self.dim: int = int(emb.get("dimension", 384))
        self.device: str = str(config.get("device", "auto")).lower()

        if self.model_name.startswith("fake"):
            self._engine = HashingEmbedder(self.dim)
        else:
            from vector_db_tpu_torch.embedding.st import SentenceTransformerEmbedder

            self._engine = SentenceTransformerEmbedder(
                self.model_name, device=self.device
            )
            if self._engine.dim != self.dim:
                raise ValueError(
                    f"Config dimension {self.dim} != model dimension "
                    f"{self._engine.dim}"
                )

    def _validate(self, out: np.ndarray, expect_2d: bool) -> np.ndarray:
        out = np.asarray(out, np.float32)
        want = 2 if expect_2d else 1
        if out.ndim != want or out.shape[-1] != self.dim:
            raise ValueError(
                f"Embedding output shape {out.shape} does not match "
                f"configured dimension {self.dim}"
            )
        return out

    def embed_text(self, text: str) -> np.ndarray:
        """Embed one text; output dimension validated per call (reference
        embedding_service.py:90-116)."""
        return self._validate(self._engine.embed_text(text), expect_2d=False)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return self._validate(self._engine.embed_texts(texts), expect_2d=True)

    def health_check(self) -> bool:
        return True

    def close(self) -> None:
        self._engine.close()
