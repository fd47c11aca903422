"""Request/response schemas (the port's copy of vector_db_tpu/api/models.py).

Parity target: reference ``src/vector_db/api/models.py:5-27`` — identical
field names and defaults. Batch variants are additions: the engine
answers whole query batches in one call, so the API exposes that
directly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pydantic import BaseModel


class InsertRequest(BaseModel):
    content: str
    metadata: Optional[Dict[str, Any]] = None


class InsertResponse(BaseModel):
    status_code: int
    message: str
    error: Optional[str] = None


class QueryRequest(BaseModel):
    query: str
    top_k: int = 5
    metadata_filter: Optional[Dict[str, Any]] = None
    pq_chunks: Optional[int] = None  # For PQ-enabled searches
    ef: int = 50  # For HNSW
    n_probe: int = 10  # For IVF
    params: Optional[Dict[str, Any]] = None  # For any additional parameters


class QueryResponse(BaseModel):
    status_code: int
    results: List[Dict[str, Any]]
    error: Optional[str] = None


# ---- batch additions (no reference analog) ----


class BatchInsertRequest(BaseModel):
    contents: List[str]
    metadatas: Optional[List[Optional[Dict[str, Any]]]] = None


class BatchInsertResponse(BaseModel):
    status_code: int
    ids: List[int]
    message: str
    error: Optional[str] = None


class BatchQueryRequest(BaseModel):
    queries: List[str]
    top_k: int = 5
    metadata_filter: Optional[Dict[str, Any]] = None
    ef: int = 50
    n_probe: int = 10  # For IVF
    params: Optional[Dict[str, Any]] = None


class BatchQueryResponse(BaseModel):
    status_code: int
    results: List[List[Dict[str, Any]]]
    error: Optional[str] = None
