from vector_db_tpu_torch.storage.device_store import DeviceVectorStore

__all__ = ["DeviceVectorStore"]
