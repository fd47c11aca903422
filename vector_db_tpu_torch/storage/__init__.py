from vector_db_tpu_torch.storage.base import NodeStorage
from vector_db_tpu_torch.storage.device_store import DeviceVectorStore
from vector_db_tpu_torch.storage.memory import InMemoryNodeStorage
from vector_db_tpu_torch.storage.mmap import MMapNodeStorage

__all__ = ["DeviceVectorStore", "InMemoryNodeStorage", "MMapNodeStorage",
           "NodeStorage"]
