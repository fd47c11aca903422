"""Host-side single-pair distance, kept for API parity (the port's copy
of vector_db_tpu/util/distance.py).

Parity target: reference ``src/vector_db/util/distance.py:3-4``
(``np.linalg.norm(v1 - v2)`` — the only metric in the reference system).

This host function exists for parity and for tiny host-side checks; the
actual engine never calls a per-pair distance — everything device-side is a
batched matmul-expanded L2 (see ``vector_db_tpu_torch.ops.distance``).
"""

from __future__ import annotations

import numpy as np


def euclidean_vector_distance(v1: np.ndarray, v2: np.ndarray) -> float:
    """Euclidean (L2) distance between two vectors."""
    return float(np.linalg.norm(np.asarray(v1) - np.asarray(v2)))
