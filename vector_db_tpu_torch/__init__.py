"""PyTorch + CUDA port of ``vector_db_tpu`` for NVIDIA Hopper (H100).

The JAX package ``vector_db_tpu`` is the reference; this package mirrors its
module paths and names (``ops/exact.py`` <-> ``ops/exact.py``,
``ops/pallas/block_topm.py`` <-> ``ops/cuda/block_topm.py``). It imports
torch and never jax. Host-only modules of the JAX package (``types.Node``,
``storage``, ``datasets``) import no jax and are reused, not copied.

Exports are lazy, so importing the package loads neither torch nor the
kernels: FlatIndex, IvfIndex, PQCodec, ProductQuantizationService,
resolve_device, Node, InMemoryNodeStorage, embedding_like, sift_like.
"""

__version__ = "0.1.0"

__all__ = ["FlatIndex", "IvfIndex", "PQCodec", "ProductQuantizationService",
           "resolve_device", "Node", "InMemoryNodeStorage", "embedding_like",
           "sift_like", "__version__"]


def __getattr__(name):
    if name == "FlatIndex":
        from vector_db_tpu_torch.index.flat import FlatIndex

        return FlatIndex
    if name == "IvfIndex":
        from vector_db_tpu_torch.index.ivf import IvfIndex

        return IvfIndex
    if name in ("PQCodec", "ProductQuantizationService"):
        from vector_db_tpu_torch.index import pq

        return getattr(pq, name)
    if name == "resolve_device":
        from vector_db_tpu_torch.device import resolve_device

        return resolve_device
    if name == "Node":
        from vector_db_tpu.types import Node

        return Node
    if name == "InMemoryNodeStorage":
        from vector_db_tpu.storage import InMemoryNodeStorage

        return InMemoryNodeStorage
    if name == "embedding_like":
        from vector_db_tpu.datasets import embedding_like

        return embedding_like
    if name == "sift_like":
        from vector_db_tpu.datasets import sift_like

        return sift_like
    raise AttributeError(name)
