"""The port's services (copies of vector_db_tpu/services/, autotune aside).

Exports are lazy, as the package's own: importing
``vector_db_tpu_torch.services.indexing_service`` loads neither ``httpx``
(the embedding client's) nor ``aiohttp`` (the apps').
"""

__all__ = [
    "StorageService",
    "IndexingService",
    "EmbeddingService",
    "EmbeddingClient",
    "SyncEmbeddingClient",
]

_MODULES = {
    "StorageService": "storage_service",
    "IndexingService": "indexing_service",
    "EmbeddingService": "embedding_service",
    "EmbeddingClient": "embedding_client",
    "SyncEmbeddingClient": "embedding_client",
}


def __getattr__(name):
    if name not in _MODULES:
        raise AttributeError(name)
    import importlib

    module = importlib.import_module(f"{__name__}.{_MODULES[name]}")
    return getattr(module, name)
