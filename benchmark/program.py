"""The system under test, as a client of the benchmark sees it: the port's
``IndexingService``, built from the configuration's file, filled by one
batched ``insert_nodes`` and searched through ``search_batch``, the entry
the API's ``/search/batch`` handler offloads to.

Storage is the in-memory backend. The index file (the graph or the IVF
lists; embeddings live in storage) goes to a fresh directory under the
temporary directory and is removed with it.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path
import numpy as np


class ProgramServer:
    def __init__(self, config_path: Path, corpus: np.ndarray, device, log
                 ) -> None:
        from vector_db_tpu_torch.services.indexing_service import (
            IndexingService)
        from vector_db_tpu_torch.storage.memory import InMemoryNodeStorage
        from vector_db_tpu_torch.types import Node

        if device.type == "cuda":
            from vector_db_tpu_torch import _build

            t = time.perf_counter()
            _build.lib()
            log(f"kernel library ready in {time.perf_counter() - t:.2f} s "
                f"(nvcc build: {_build.build_seconds})")
        self._dir = Path(tempfile.mkdtemp(prefix="bench-index-"))
        self.index_file = self._dir / "index.npz"
        self.service = IndexingService(InMemoryNodeStorage(),
                                       str(config_path),
                                       index_file=str(self.index_file))
        t = time.perf_counter()
        nodes = [Node(id=i, embedding=row) for i, row in enumerate(corpus)]
        log(f"{len(nodes)} nodes in {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        self.service.insert_nodes(nodes)
        log(f"insert_nodes in {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        self.service.wait_for_flush()
        self.index_bytes = (self.index_file.stat().st_size
                            if self.index_file.exists() else 0)
        log(f"threshold flush waited {time.perf_counter() - t:.2f} s; index "
            f"file {self.index_bytes} bytes")

    def __call__(self, queries: np.ndarray, k: int, params: dict):
        return self.service.search_batch(queries, k, **params)

    def release(self) -> None:
        """Drop the index (its device tables go with it) and the index
        file. The service's flush thread keeps the service itself alive,
        so the index is unhooked from it first."""
        self.service.wait_for_flush()
        self.service.index = None
        self.service = None
        shutil.rmtree(self._dir, ignore_errors=True)
