"""Core record types (the port's copy of vector_db_tpu/types.py).

The host-facing API keeps the reference's ``Node`` record shape; on the
device, nodes are structure-of-arrays (an f32 table of embeddings, ids on
the host). The port reads only ``.id``, ``.embedding`` and ``.metadata`` of
a node, so a JAX ``Node`` passed in works as well.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np


@dataclass
class Node:
    """A single vector record: integer id, embedding vector, free-form
    metadata dict, and optional raw content."""

    id: int
    embedding: np.ndarray
    metadata: Dict[str, Any] = field(default_factory=dict)
    content: Optional[str] = None

    def __post_init__(self) -> None:
        if self.metadata is None:
            self.metadata = {}
        self.embedding = np.asarray(self.embedding, dtype=np.float32)
