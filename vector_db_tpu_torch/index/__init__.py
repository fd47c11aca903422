from vector_db_tpu_torch.index.flat import FlatIndex
from vector_db_tpu_torch.index.hnsw import HNSW
from vector_db_tpu_torch.index.ivf import IvfIndex
from vector_db_tpu_torch.index.pq import PQCodec, ProductQuantizationService

__all__ = ["FlatIndex", "HNSW", "IvfIndex", "PQCodec",
           "ProductQuantizationService"]
