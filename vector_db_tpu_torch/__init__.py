"""PyTorch + CUDA port of ``vector_db_tpu`` for NVIDIA Hopper (H100).

The JAX package ``vector_db_tpu`` is the reference; this package mirrors its
module paths and names (``ops/exact.py`` <-> ``ops/exact.py``,
``ops/pallas/block_topm.py`` <-> ``ops/cuda/block_topm.py``). It imports
torch and never jax, and nothing of the JAX package: the host-only modules
it needs (``types``, ``storage/{base,memory}``, ``datasets``) are its own
copies, under the same names.

Exports are lazy, so importing the package loads neither torch nor the
kernels: FlatIndex, IvfIndex, HNSW, PQCodec, ProductQuantizationService,
resolve_device, Node, InMemoryNodeStorage, embedding_like, sift_like.
"""

__version__ = "0.1.0"

__all__ = ["FlatIndex", "IvfIndex", "HNSW", "PQCodec",
           "ProductQuantizationService", "ShardedFlatIndex", "ShardedIVF",
           "ShardedHNSW", "make_mesh", "make_mesh_2d", "resolve_device",
           "Node", "InMemoryNodeStorage", "embedding_like", "sift_like",
           "__version__"]

_PARALLEL = ("ShardedFlatIndex", "ShardedIVF", "ShardedHNSW", "make_mesh",
             "make_mesh_2d")


def __getattr__(name):
    if name == "FlatIndex":
        from vector_db_tpu_torch.index.flat import FlatIndex

        return FlatIndex
    if name == "IvfIndex":
        from vector_db_tpu_torch.index.ivf import IvfIndex

        return IvfIndex
    if name == "HNSW":
        from vector_db_tpu_torch.index.hnsw import HNSW

        return HNSW
    if name in ("PQCodec", "ProductQuantizationService"):
        from vector_db_tpu_torch.index import pq

        return getattr(pq, name)
    if name in _PARALLEL:
        from vector_db_tpu_torch import parallel

        return getattr(parallel, name)
    if name == "resolve_device":
        from vector_db_tpu_torch.device import resolve_device

        return resolve_device
    if name == "Node":
        from vector_db_tpu_torch.types import Node

        return Node
    if name == "InMemoryNodeStorage":
        from vector_db_tpu_torch.storage.memory import InMemoryNodeStorage

        return InMemoryNodeStorage
    if name in ("embedding_like", "sift_like"):
        from vector_db_tpu_torch import datasets

        return getattr(datasets, name)
    raise AttributeError(name)
