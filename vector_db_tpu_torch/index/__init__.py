from vector_db_tpu_torch.index.flat import FlatIndex
from vector_db_tpu_torch.index.ivf import IvfIndex
from vector_db_tpu_torch.index.pq import PQCodec, ProductQuantizationService

__all__ = ["FlatIndex", "IvfIndex", "PQCodec", "ProductQuantizationService"]
