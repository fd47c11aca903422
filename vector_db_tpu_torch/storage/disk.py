"""SQLite + flat-memmap storage (legacy backend; the port's copy of
vector_db_tpu/storage/disk.py).

Parity target: reference ``DiskNodeStorage`` (src/vector_db/storage.py:309-454):
SQLite table for content/metadata + a flat float32 memmap for embeddings,
kept for drop-in compatibility. The reference itself flags it "Legacy …
consider using MMapNodeStorage" (storage.py:312); unused by services/API.
"""

from __future__ import annotations

import json
import sqlite3
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from vector_db_tpu_torch.storage.base import NodeStorage
from vector_db_tpu_torch.types import Node


class DiskNodeStorage(NodeStorage):
    def __init__(
        self,
        db_file: Union[str, Path],
        embedding_file: Union[str, Path],
        dim: int,
        capacity: int = 1_000_000,
    ) -> None:
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.db_file = Path(db_file)
        self.embedding_file = Path(embedding_file)
        self.db_file.parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.db_file)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS nodes ("
            "id INTEGER PRIMARY KEY, row INTEGER NOT NULL, "
            "content TEXT, metadata TEXT)"
        )
        self._conn.commit()
        exists = self.embedding_file.exists()
        self._emb = np.memmap(
            self.embedding_file, dtype=np.float32,
            mode="r+" if exists else "w+",
            shape=(self.capacity, self.dim),
        )
        self._next_row = (
            self._conn.execute("SELECT COALESCE(MAX(row)+1, 0) FROM nodes")
            .fetchone()[0]
        )

    def _row_of(self, node_id: int) -> Optional[int]:
        cur = self._conn.execute(
            "SELECT row FROM nodes WHERE id=?", (node_id,)
        ).fetchone()
        return None if cur is None else int(cur[0])

    def save(self, node: Node) -> None:
        emb = np.asarray(node.embedding, np.float32)
        if emb.shape != (self.dim,):
            raise ValueError(
                f"Embedding dim {emb.shape} != storage dim ({self.dim},)"
            )
        row = self._row_of(node.id)
        if row is None:
            if self._next_row >= self.capacity:
                raise RuntimeError(
                    f"Storage full: capacity {self.capacity} reached"
                )
            row = self._next_row
            self._next_row += 1
        self._emb[row] = emb
        self._emb.flush()
        self._conn.execute(
            "INSERT OR REPLACE INTO nodes (id, row, content, metadata) "
            "VALUES (?, ?, ?, ?)",
            (node.id, row, node.content, json.dumps(node.metadata or {})),
        )
        self._conn.commit()

    def get(self, node_id: int) -> Optional[Node]:
        cur = self._conn.execute(
            "SELECT row, content, metadata FROM nodes WHERE id=?", (node_id,)
        ).fetchone()
        if cur is None:
            return None
        row, content, metadata = cur
        return Node(
            id=node_id,
            embedding=np.array(self._emb[row]),
            metadata=json.loads(metadata) if metadata else {},
            content=content,
        )

    def get_embedding(self, node_id: int) -> np.ndarray:
        row = self._row_of(node_id)
        if row is None:
            raise KeyError(f"Node {node_id} not found")
        return self._emb[row]

    def get_all_ids(self) -> List[int]:
        return [r[0] for r in self._conn.execute("SELECT id FROM nodes")]

    def size(self) -> int:
        return self._conn.execute("SELECT COUNT(*) FROM nodes").fetchone()[0]

    def delete(self, node_id: int) -> None:
        row = self._row_of(node_id)
        if row is None:
            return
        self._emb[row] = 0.0
        self._emb.flush()
        self._conn.execute("DELETE FROM nodes WHERE id=?", (node_id,))
        self._conn.commit()

    def get_next_id(self) -> int:
        nid = self._conn.execute(
            "SELECT COALESCE(MAX(id)+1, 0) FROM nodes"
        ).fetchone()[0]
        return int(nid)

    def close(self) -> None:
        self._emb.flush()
        self._conn.close()
        del self._emb
