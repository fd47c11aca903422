"""The import guard: nothing of JAX, and nothing of the JAX package, may be
loaded in a benchmark run.

Names are compared by their top-level part (before the first dot), whole:
``vector_db_tpu_torch`` is the program under test and passes, while
``vector_db_tpu`` (the JAX package it was ported from) fails.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "vector_db_tpu")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level name
    is one of ``FORBIDDEN``, sorted."""
    names = sys.modules.keys() if names is None else names
    return sorted(n for n in list(names) if n.split(".", 1)[0] in FORBIDDEN)
