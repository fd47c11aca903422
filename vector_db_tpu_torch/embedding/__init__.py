from vector_db_tpu_torch.embedding.fake import HashingEmbedder
from vector_db_tpu_torch.embedding.device import (
    get_device,
    is_accelerator_available,
    get_device_info,
)

__all__ = [
    "HashingEmbedder",
    "get_device",
    "is_accelerator_available",
    "get_device_info",
]
