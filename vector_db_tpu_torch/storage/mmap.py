"""Two-layer memmap storage (the port's copy of
vector_db_tpu/storage/mmap.py, numpy only).

- layer 1: structured rows ``(id: int64, embedding: float32[dim])``, file
  ``embedding_file``;
- layer 2: ``(id: int64, content: U<content_chars>, metadata_json:
  U<metadata_chars>)``, file ``metadata_file``;
- ``capacity`` rows preallocated; ``save`` truncates content and metadata
  to the field widths and flushes both memmaps per write, ``save_many``
  once per batch;
- on reopen the id -> row map is rebuilt from the live rows (id >= 0 and a
  nonzero embedding), and free rows come from an in-memory free list;
- ``get_embedding`` returns a zero-copy memmap view, ``get_embeddings`` one
  fancy-indexed read for many ids.

Empty and deleted rows carry id = -1.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from vector_db_tpu_torch.storage.base import NodeStorage
from vector_db_tpu_torch.types import Node

CONTENT_CHARS = 10240
METADATA_CHARS = 5120


class MMapNodeStorage(NodeStorage):
    def __init__(
        self,
        embedding_file: Union[str, Path],
        metadata_file: Union[str, Path],
        dim: int,
        capacity: int = 1_000_000,
        content_chars: int = CONTENT_CHARS,
        metadata_chars: int = METADATA_CHARS,
    ) -> None:
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.embedding_file = Path(embedding_file)
        self.metadata_file = Path(metadata_file)
        self.content_chars = int(content_chars)
        self.metadata_chars = int(metadata_chars)
        self._emb_dtype = np.dtype(
            [("id", np.int64), ("embedding", np.float32, (self.dim,))]
        )
        self._meta_dtype = np.dtype(
            [
                ("id", np.int64),
                ("content", f"U{content_chars}"),
                ("metadata_json", f"U{metadata_chars}"),
            ]
        )
        self._id_to_index: Dict[int, int] = {}
        self._next_id = 0
        self._init_embedding_memmap()
        self._init_metadata_memmap()

    # -- init / resume ----------------------------------------------------
    def _init_embedding_memmap(self) -> None:
        exists = self.embedding_file.exists()
        mode = "r+" if exists else "w+"
        self.embedding_file.parent.mkdir(parents=True, exist_ok=True)
        self._emb = np.memmap(
            self.embedding_file, dtype=self._emb_dtype, mode=mode,
            shape=(self.capacity,),
        )
        if not exists:
            self._emb["id"][:] = -1
            self._emb.flush()
        else:
            # Resume: rebuild id->row from the live rows; the
            # nonzero-embedding test lets files whose empty rows default
            # to id=0 resume too.
            ids = np.asarray(self._emb["id"])
            nonzero = np.any(np.asarray(self._emb["embedding"]) != 0, axis=1)
            live = (ids >= 0) & nonzero
            rows = np.nonzero(live)[0]
            self._id_to_index = {int(ids[r]): int(r) for r in rows}
            if rows.size:
                self._next_id = int(ids[rows].max()) + 1
        self._free = sorted(
            set(range(self.capacity)) - set(self._id_to_index.values()),
            reverse=True,
        )

    def _init_metadata_memmap(self) -> None:
        exists = self.metadata_file.exists()
        mode = "r+" if exists else "w+"
        self.metadata_file.parent.mkdir(parents=True, exist_ok=True)
        self._meta = np.memmap(
            self.metadata_file, dtype=self._meta_dtype, mode=mode,
            shape=(self.capacity,),
        )
        if not exists:
            self._meta["id"][:] = -1
            self._meta.flush()

    # -- CRUD ---------------------------------------------------------------
    def save(self, node: Node) -> None:
        row = self._id_to_index.get(node.id)
        if row is None:
            if not self._free:
                raise RuntimeError(
                    f"Storage full: capacity {self.capacity} reached"
                )
            row = self._free.pop()
            self._id_to_index[node.id] = row
        emb = np.asarray(node.embedding, np.float32)
        if emb.shape != (self.dim,):
            raise ValueError(
                f"Embedding dim {emb.shape} != storage dim ({self.dim},)"
            )
        self._emb[row] = (node.id, emb)
        content = (node.content or "")[: self.content_chars]
        meta_json = json.dumps(node.metadata or {})[: self.metadata_chars]
        self._meta[row] = (node.id, content, meta_json)
        self._emb.flush()
        self._meta.flush()
        if node.id >= self._next_id:
            self._next_id = node.id + 1

    def save_many(self, nodes) -> None:
        """Batched save: write every row, flush once per layer (a flush
        per row costs two msync calls). Durability is per batch."""
        for node in nodes:
            row = self._id_to_index.get(node.id)
            if row is None:
                if not self._free:
                    raise RuntimeError(
                        f"Storage full: capacity {self.capacity} reached"
                    )
                row = self._free.pop()
                self._id_to_index[node.id] = row
            emb = np.asarray(node.embedding, np.float32)
            if emb.shape != (self.dim,):
                raise ValueError(
                    f"Embedding dim {emb.shape} != storage dim "
                    f"({self.dim},)"
                )
            self._emb[row] = (node.id, emb)
            content = (node.content or "")[: self.content_chars]
            meta_json = json.dumps(node.metadata or {})[: self.metadata_chars]
            self._meta[row] = (node.id, content, meta_json)
            if node.id >= self._next_id:
                self._next_id = node.id + 1
        self._emb.flush()
        self._meta.flush()

    def get(self, node_id: int) -> Optional[Node]:
        row = self._id_to_index.get(node_id)
        if row is None:
            return None
        m = self._meta[row]
        try:
            metadata = json.loads(str(m["metadata_json"])) if m["metadata_json"] else {}
        except json.JSONDecodeError:
            metadata = {}
        content = str(m["content"]) or None
        return Node(
            id=node_id,
            embedding=np.array(self._emb[row]["embedding"]),
            metadata=metadata,
            content=content,
        )

    def get_embedding(self, node_id: int) -> np.ndarray:
        row = self._id_to_index.get(node_id)
        if row is None:
            raise KeyError(f"Node {node_id} not found")
        # zero-copy memmap view
        return self._emb["embedding"][row]

    def get_all_ids(self) -> List[int]:
        return list(self._id_to_index.keys())

    def size(self) -> int:
        return len(self._id_to_index)

    def delete(self, node_id: int) -> None:
        row = self._id_to_index.pop(node_id, None)
        if row is None:
            return
        self._emb[row] = (-1, np.zeros(self.dim, np.float32))
        self._meta[row] = (-1, "", "")
        self._emb.flush()
        self._meta.flush()
        self._free.append(row)

    def get_next_id(self) -> int:
        nid = self._next_id
        self._next_id += 1
        return nid

    def close(self) -> None:
        self._emb.flush()
        self._meta.flush()
        del self._emb
        del self._meta

    # -- bulk views ------------------------------------------------------------
    def get_embeddings(self, ids) -> "tuple[np.ndarray, np.ndarray]":
        """Bulk fetch as one fancy-indexed memmap read (the base class
        loops ``get_embedding`` per id): (f32[n, dim], zero rows where
        missing; found bool[n])."""
        ids = np.asarray(list(ids), np.int64)
        rows = np.fromiter(
            (self._id_to_index.get(int(i), -1) for i in ids),
            np.int64, count=len(ids),
        )
        found = rows >= 0
        out = np.zeros((len(ids), self.dim), np.float32)
        if found.any():
            out[found] = self._emb["embedding"][rows[found]]
        return out, found

    def iter_metadata(self):
        """Yield (id, metadata dict, content) for all live rows, reading
        only the metadata columns (no embedding copies / Node objects) —
        the StorageService filter-index hydration path."""
        if not self._id_to_index:
            return
        rows = np.asarray(sorted(self._id_to_index.values()), np.int64)
        metas = self._meta["metadata_json"][rows]
        contents = self._meta["content"][rows]
        row_ids = self._meta["id"][rows]
        for nid, mj, content in zip(row_ids, metas, contents):
            try:
                metadata = json.loads(str(mj)) if mj else {}
            except json.JSONDecodeError:
                metadata = {}
            yield int(nid), metadata, (str(content) or None)

    def embedding_matrix(self) -> np.ndarray:
        """Zero-copy structured view of all embedding rows, f32[capacity, dim]."""
        return self._emb["embedding"]

    def live_rows(self) -> np.ndarray:
        """Row indices holding live nodes."""
        return np.asarray(sorted(self._id_to_index.values()), dtype=np.int64)
