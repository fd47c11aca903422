"""Small host-side math helpers (the port's copy of
vector_db_tpu/util/math.py).

Parity target: reference ``src/vector_db/util/math.py:3-5``
(``top_k_indices_sorted`` — argpartition + descending argsort; dead code in
the reference but part of its public surface, so kept here).
"""

from __future__ import annotations

import numpy as np


def top_k_indices_sorted(values: np.ndarray, k: int) -> np.ndarray:
    """Indices of the top-k largest values, sorted descending by value."""
    values = np.asarray(values)
    k = min(k, values.shape[-1])
    part = np.argpartition(values, -k)[-k:]
    return part[np.argsort(values[part])[::-1]]
