from vector_db_tpu_torch.util.distance import euclidean_vector_distance
from vector_db_tpu_torch.util.math import top_k_indices_sorted

__all__ = ["euclidean_vector_distance", "top_k_indices_sorted"]
