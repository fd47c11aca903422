"""Dict-backed in-memory storage (the port's copy of
vector_db_tpu/storage/memory.py): a plain dict of nodes plus a
monotonically increasing ``_next_id``."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from vector_db_tpu_torch.storage.base import NodeStorage
from vector_db_tpu_torch.types import Node


class InMemoryNodeStorage(NodeStorage):
    def __init__(self) -> None:
        self._nodes: Dict[int, Node] = {}
        self._next_id = 0

    def save(self, node: Node) -> None:
        self._nodes[node.id] = node
        if node.id >= self._next_id:
            self._next_id = node.id + 1

    def get(self, node_id: int) -> Optional[Node]:
        return self._nodes.get(node_id)

    def get_embedding(self, node_id: int) -> np.ndarray:
        node = self._nodes.get(node_id)
        if node is None:
            raise KeyError(f"Node {node_id} not found")
        return node.embedding

    def get_all_ids(self) -> List[int]:
        return list(self._nodes.keys())

    def size(self) -> int:
        return len(self._nodes)

    def delete(self, node_id: int) -> None:
        self._nodes.pop(node_id, None)

    def get_next_id(self) -> int:
        nid = self._next_id
        self._next_id += 1
        return nid
