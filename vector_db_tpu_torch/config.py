"""Config system (the port's copy of vector_db_tpu/config.py).

Parity target: reference ``src/config.yaml:1-12`` — one YAML file with keyed
sections ``embedding`` (model, dimension), ``device``, ``index``
(ef_construction, M, flush_threshold), and ``vector_db`` (file_path,
dimension, capacity) — read with ``yaml.safe_load`` at each service's init
(reference api/app.py:36-39, services/indexing_service.py:42-46).

Unlike the reference, defaults live here in exactly one place instead of
being duplicated at every read site. ``device`` defaults to ``"cuda"``: the
services place their index on the card unless the file says ``cpu``.
``yaml`` is imported where a file is read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Union

# Env vars honoured by the services/API (reference api/app.py:16,32-33).
ENV_CONFIG_PATH = "CONFIG_PATH"
ENV_USE_EMBEDDING_SERVICE = "USE_EMBEDDING_SERVICE"
ENV_EMBEDDING_SERVICE_URL = "EMBEDDING_SERVICE_URL"

DEFAULTS: Dict[str, Any] = {
    "embedding": {
        "model": "sentence-transformers/all-MiniLM-L6-v2",
        "dimension": 384,
    },
    "device": "cuda",
    "index": {
        "ef_construction": 200,
        "M": 16,
        "flush_threshold": 1000,
    },
    "vector_db": {
        "file_path": "../vector_db",
        "dimension": 384,
        "capacity": 1_000_000,
    },
}


def _merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: Optional[Union[str, Path]] = None) -> Dict[str, Any]:
    """Load YAML config merged over defaults.

    ``path`` resolution order: explicit argument, ``CONFIG_PATH`` env var,
    else pure defaults.
    """
    if path is None:
        path = os.environ.get(ENV_CONFIG_PATH)
    raw: Dict[str, Any] = {}
    if path is not None and Path(path).exists():
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    return _merge(DEFAULTS, raw)


@dataclass
class IndexConfig:
    M: int = 16
    ef_construction: int = 200
    flush_threshold: int = 1000

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "IndexConfig":
        idx = cfg.get("index", {}) or {}
        return cls(
            M=int(idx.get("M", DEFAULTS["index"]["M"])),
            ef_construction=int(
                idx.get("ef_construction", DEFAULTS["index"]["ef_construction"])
            ),
            flush_threshold=int(
                idx.get("flush_threshold", DEFAULTS["index"]["flush_threshold"])
            ),
        )


@dataclass
class VectorDBConfig:
    file_path: str = "../vector_db"
    dimension: int = 384
    capacity: int = 1_000_000

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "VectorDBConfig":
        vdb = cfg.get("vector_db", {}) or {}
        return cls(
            file_path=str(vdb.get("file_path", DEFAULTS["vector_db"]["file_path"])),
            dimension=int(vdb.get("dimension", DEFAULTS["vector_db"]["dimension"])),
            capacity=int(vdb.get("capacity", DEFAULTS["vector_db"]["capacity"])),
        )


@dataclass
class EmbeddingConfig:
    model: str = DEFAULTS["embedding"]["model"]
    dimension: int = 384
    device: str = "cuda"

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "EmbeddingConfig":
        emb = cfg.get("embedding", {}) or {}
        return cls(
            model=str(emb.get("model", DEFAULTS["embedding"]["model"])),
            dimension=int(emb.get("dimension", DEFAULTS["embedding"]["dimension"])),
            device=str(cfg.get("device", DEFAULTS["device"])),
        )


@dataclass
class Config:
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    vector_db: VectorDBConfig = field(default_factory=VectorDBConfig)

    @classmethod
    def load(cls, path: Optional[Union[str, Path]] = None) -> "Config":
        cfg = load_config(path)
        return cls(
            embedding=EmbeddingConfig.from_config(cfg),
            index=IndexConfig.from_config(cfg),
            vector_db=VectorDBConfig.from_config(cfg),
        )
