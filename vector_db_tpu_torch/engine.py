"""Self-contained vector engine: mmap storage + HNSW in one object (the
port's copy of vector_db_tpu/engine.py; the index lives on the config's
``device``, as the indexing service's).

Parity target: reference ``MemoryMappingService``
(src/vector_db/inference/mmap_vector_store.py:12-177): two-layer memmap
storage + a config-driven HNSW (seeded Random(42)), with
write/read/get_embedding/delete/search and the same validation errors.
Kept under the same semantics so existing callers can swap in; the
service-layer path (StorageService + IndexingService) is the API's engine,
as in the reference.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from vector_db_tpu_torch.config import load_config
from vector_db_tpu_torch.device import config_device
from vector_db_tpu_torch.index.hnsw import HNSW
from vector_db_tpu_torch.storage import MMapNodeStorage
from vector_db_tpu_torch.types import Node


class MemoryMappingService:
    def __init__(
        self,
        file_path: str,
        dim: int,
        capacity: int,
        config_path: Optional[str] = None,
        index_file: Optional[str] = None,
    ) -> None:
        if dim <= 0:
            raise ValueError("Dimension must be greater than 0")
        if capacity <= 0:
            raise ValueError("Capacity must be greater than 0")
        if config_path is None:
            raise ValueError("config_path is required")

        self.file_path = Path(file_path)
        self.dim = int(dim)
        self.capacity = int(capacity)

        config = load_config(config_path)
        index_config = config.get("index", {})
        M = index_config.get("M", 16)
        ef_construction = index_config.get("ef_construction", 200)

        self.storage = MMapNodeStorage(
            embedding_file=self.file_path.with_suffix(".embeddings.npy"),
            metadata_file=self.file_path.with_suffix(".metadata.npy"),
            dim=dim,
            capacity=capacity,
        )
        index_path = (
            Path(index_file) if index_file
            else self.file_path.with_suffix(".index.npz")
        )
        self.index = HNSW(
            M=M,
            ef_construction=ef_construction,
            rng=random.Random(42),
            storage=self.storage,
            index_file=index_path,
            device=config_device(config.get("device", "cuda")),
        )
        self.size = self.storage.size()

    def write(
        self,
        embedding: np.ndarray,
        content: Optional[str] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> int:
        if not isinstance(embedding, np.ndarray):
            raise TypeError("Embedding must be a numpy array")
        if embedding.dtype != np.float32:
            embedding = embedding.astype(np.float32)
        if embedding.ndim != 1:
            raise ValueError("Embedding must be a 1D array")
        if embedding.size != self.dim:
            raise ValueError(f"Embedding must be of dimension {self.dim}")

        node_id = self.storage.get_next_id()
        node = Node(
            id=node_id, embedding=embedding, content=content,
            metadata=metadata or {},
        )
        self.storage.save(node)
        self.index.insert_node(node)
        self.size = self.storage.size()
        return node_id

    def read(self, node_id: int) -> Node:
        if not isinstance(node_id, int):
            raise TypeError("Node ID must be an integer")
        node = self.storage.get(node_id)
        if node is None:
            raise IndexError(f"Node {node_id} not found")
        return node

    def get_embedding(self, node_id: int) -> np.ndarray:
        return self.storage.get_embedding(node_id)

    def delete(self, node_id: int) -> None:
        self.index.delete_node(node_id)
        if hasattr(self.storage, "delete"):
            self.storage.delete(node_id)
        self.size = self.storage.size()

    def search(
        self, query: np.ndarray, k: int, ef: int = 50
    ) -> List[Tuple[Node, float]]:
        return self.index.search(query, k=k, ef=ef)
