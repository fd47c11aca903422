"""Host-facing metadata index: native C++ postings when available, pure
Python dicts otherwise (the port's copy of vector_db_tpu/native/metadata.py).
Same exact-match semantics as the reference's full scan
(src/vector_db/services/storage_service.py:106-128), O(matches) instead of
O(N)."""

from __future__ import annotations

import ctypes
import json
from typing import Any, Dict, Set

from vector_db_tpu_torch.native import load_metadata_lib


def _serialize(value: Any) -> bytes:
    # exact-match semantics: values compare by canonical JSON encoding
    return json.dumps(value, sort_keys=True).encode("utf-8")


class MetadataIndex:
    """Inverted (key, value) -> ids index with exact-match AND queries."""

    def __init__(self, force_python: bool = False) -> None:
        self._lib = None if force_python else load_metadata_lib()
        if self._lib is not None:
            self._h = self._lib.mdx_new()
        else:
            self._postings: Dict[bytes, Set[int]] = {}
            self._tokens_of: Dict[int, list] = {}

    @property
    def native(self) -> bool:
        return self._lib is not None

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.mdx_free(self._h)

    @staticmethod
    def _pairs(metadata: Dict[str, Any]):
        return [(k.encode("utf-8"), _serialize(v))
                for k, v in (metadata or {}).items()]

    def set(self, node_id: int, metadata: Dict[str, Any]) -> None:
        pairs = self._pairs(metadata)
        if self._lib is not None:
            n = len(pairs)
            keys = (ctypes.c_char_p * n)(*[p[0] for p in pairs])
            vals = (ctypes.c_char_p * n)(*[p[1] for p in pairs])
            self._lib.mdx_set(self._h, node_id, keys, vals, n)
        else:
            self.remove(node_id)
            toks = [k + b"\x1f" + v for k, v in pairs]
            for t in toks:
                self._postings.setdefault(t, set()).add(node_id)
            self._tokens_of[node_id] = toks

    def remove(self, node_id: int) -> None:
        if self._lib is not None:
            self._lib.mdx_remove(self._h, node_id)
        else:
            for t in self._tokens_of.pop(node_id, []):
                s = self._postings.get(t)
                if s is not None:
                    s.discard(node_id)
                    if not s:
                        del self._postings[t]

    def size(self) -> int:
        if self._lib is not None:
            return int(self._lib.mdx_size(self._h))
        return len(self._tokens_of)

    def query(self, filter_dict: Dict[str, Any]) -> Set[int]:
        """Ids whose metadata contains ALL of filter_dict's (key, value)
        pairs; empty filter matches everything indexed."""
        pairs = self._pairs(filter_dict or {})
        if self._lib is not None:
            n = len(pairs)
            keys = (ctypes.c_char_p * n)(*[p[0] for p in pairs])
            vals = (ctypes.c_char_p * n)(*[p[1] for p in pairs])
            cap = max(self.size(), 1)
            out = (ctypes.c_int64 * cap)()
            total = self._lib.mdx_query(self._h, keys, vals, n, out, cap)
            if total > cap:  # grew concurrently; retry with exact size
                out = (ctypes.c_int64 * total)()
                total = self._lib.mdx_query(self._h, keys, vals, n, out, total)
            return {int(out[i]) for i in range(min(total, len(out)))}
        if not pairs:
            return set(self._tokens_of.keys())
        toks = [k + b"\x1f" + v for k, v in pairs]
        sets = [self._postings.get(t, set()) for t in toks]
        if any(not s for s in sets):
            return set()
        sets.sort(key=len)
        result = set(sets[0])
        for s in sets[1:]:
            result &= s
        return result
