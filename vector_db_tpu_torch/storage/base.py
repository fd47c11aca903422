"""Node storage contract (the port's copy of vector_db_tpu/storage/base.py).

save/get/get_embedding/get_all_ids/size/delete/get_next_id, plus ``add``
and a bulk ``get_embeddings``. Storage holds embeddings and
metadata/content; index structures hold only graph or table state and
reference storage by id.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

import numpy as np

from vector_db_tpu_torch.types import Node


class NodeStorage(ABC):
    """Abstract node persistence backend."""

    @abstractmethod
    def save(self, node: Node) -> None:
        """Insert or overwrite a node."""

    @abstractmethod
    def get(self, node_id: int) -> Optional[Node]:
        """Fetch a full node record, or None if absent."""

    @abstractmethod
    def get_embedding(self, node_id: int) -> np.ndarray:
        """Fetch just the embedding. Raises KeyError if absent."""

    @abstractmethod
    def get_all_ids(self) -> List[int]:
        """All live node ids."""

    @abstractmethod
    def size(self) -> int:
        """Number of live nodes."""

    @abstractmethod
    def delete(self, node_id: int) -> None:
        """Remove a node. No-op if absent."""

    @abstractmethod
    def get_next_id(self) -> int:
        """Allocate the next unused id (monotonic)."""

    def add(self, node: Node) -> None:
        """Alias for save."""
        self.save(node)

    def get_embeddings(self, ids) -> "tuple[np.ndarray, np.ndarray]":
        """Bulk embedding fetch: (f32[n, dim] — zero rows where missing,
        found bool[n]). Loops :meth:`get_embedding`."""
        ids = list(ids)
        found = np.zeros(len(ids), bool)
        out: Optional[np.ndarray] = None
        for j, nid in enumerate(ids):
            try:
                v = np.asarray(self.get_embedding(int(nid)), np.float32)
            except KeyError:
                continue
            if out is None:
                out = np.zeros((len(ids), v.shape[0]), np.float32)
            out[j] = v
            found[j] = True
        if out is None:
            out = np.zeros((len(ids), 0), np.float32)
        return out, found

    def close(self) -> None:
        """Release resources; default no-op."""
