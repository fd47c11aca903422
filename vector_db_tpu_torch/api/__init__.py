from vector_db_tpu_torch.api.models import (
    InsertRequest,
    InsertResponse,
    QueryRequest,
    QueryResponse,
)

__all__ = ["InsertRequest", "InsertResponse", "QueryRequest", "QueryResponse"]
