from vector_db_tpu_torch.index.flat import FlatIndex

__all__ = ["FlatIndex"]
