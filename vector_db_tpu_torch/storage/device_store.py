"""Device-resident vector table with host-side id<->slot bookkeeping
(port of vector_db_tpu/storage/device_store.py).

An ``f32[capacity, dim]`` table and a ``bool[capacity]`` validity mask on
one torch device; on the host a map from node ids to table rows (slots), a
free list and power-of-two growth. Index structures hang per-slot state
off it through ``on_grow``.

Unlike the JAX arrays, the tensors are updated in place (``write``,
``release``): a 1M x 768 table is 3.2 GB, and a copy per mutation would
double the device footprint.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vector_db_tpu_torch.device import resolve_device


class DeviceVectorStore:
    def __init__(
        self,
        capacity: int = 256,
        on_grow: Optional[Callable[[int, int], None]] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self._capacity = int(capacity)
        self._dim: Optional[int] = None
        self.emb: Optional[torch.Tensor] = None
        self.valid: Optional[torch.Tensor] = None
        self._id_of_slot: Optional[np.ndarray] = None
        self._slot_of_id: Dict[int, int] = {}
        self._free_slots: List[int] = []
        self._n_used = 0
        self._on_grow = on_grow
        # lazily-built sorted view of _id_of_slot for vectorized
        # filter_mask; invalidated by any id<->slot mutation
        self._sort_cache = None

    @classmethod
    def from_arrays(cls, emb: np.ndarray, valid: np.ndarray,
                    id_of_slot: np.ndarray, device="cuda",
                    ) -> "DeviceVectorStore":
        """A store holding another store's state: the table ``emb``
        f32[capacity, dim], the mask ``valid`` bool[capacity] and the map
        ``id_of_slot`` int64[capacity] (-1 for a free slot), e.g. a JAX
        store's ``np.asarray(emb)``, ``np.asarray(valid)`` and
        ``export_id_map()``."""
        emb = np.asarray(emb, np.float32)
        valid = np.asarray(valid, bool)
        ids = np.asarray(id_of_slot, np.int64)
        if emb.ndim != 2 or valid.shape != (emb.shape[0],) \
                or ids.shape != valid.shape:
            raise ValueError(
                f"from_arrays: shapes {emb.shape}, {valid.shape}, "
                f"{ids.shape} do not describe one [capacity, dim] table")
        if not np.array_equal(valid, ids >= 0):
            raise ValueError("from_arrays: valid must be exactly the slots "
                             "that id_of_slot maps to an id")
        store = cls(capacity=emb.shape[0], device=device)
        store._dim = emb.shape[1]
        # torch.tensor copies: in-place updates never reach the source
        store.emb = torch.tensor(emb, device=store.device)
        store.valid = torch.tensor(valid, device=store.device)
        store.import_id_map(ids.copy())
        return store

    # -- geometry -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def dim(self) -> Optional[int]:
        return self._dim

    @property
    def size(self) -> int:
        return len(self._slot_of_id)

    def ensure_dim(self, dim: int) -> None:
        if self._dim is None:
            self._dim = int(dim)
            self.emb = torch.zeros((self._capacity, dim), dtype=torch.float32,
                                   device=self.device)
            self.valid = torch.zeros((self._capacity,), dtype=torch.bool,
                                     device=self.device)
            if self._id_of_slot is None:  # may be pre-loaded (import_id_map)
                self._id_of_slot = np.full((self._capacity,), -1, np.int64)
        elif dim != self._dim:
            raise ValueError(f"Embedding dim {dim} != store dim {self._dim}")

    def grow_to(self, need: int) -> None:
        if need <= self._capacity:
            return
        old = self._capacity
        new_cap = self._capacity
        while new_cap < need:
            new_cap *= 2
        pad = new_cap - old
        self.emb = torch.cat([self.emb, self.emb.new_zeros((pad, self._dim))])
        self.valid = torch.cat([self.valid, self.valid.new_zeros((pad,))])
        self._id_of_slot = np.concatenate(
            [self._id_of_slot, np.full((pad,), -1, np.int64)]
        )
        self._capacity = new_cap
        self._sort_cache = None
        if self._on_grow is not None:
            self._on_grow(old, new_cap)

    # -- slots ----------------------------------------------------------------
    def slot_of(self, node_id: int) -> Optional[int]:
        return self._slot_of_id.get(node_id)

    def __contains__(self, node_id: int) -> bool:
        return node_id in self._slot_of_id

    def take_slot(self, node_id: int) -> int:
        if self._free_slots:
            slot = self._free_slots.pop()
        else:
            if self._n_used >= self._capacity:
                self.grow_to(self._n_used + 1)
            slot = self._n_used
            self._n_used += 1
        self._slot_of_id[node_id] = slot
        self._id_of_slot[slot] = node_id
        self._sort_cache = None
        return slot

    def take_slots(self, ids: Sequence[int]) -> np.ndarray:
        need = self._n_used + len(ids) - len(self._free_slots)
        if need > self._capacity:
            self.grow_to(need)
        return np.array([self.take_slot(int(i)) for i in ids], np.int32)

    def release(self, node_id: int) -> Optional[int]:
        """Free a node's slot (tombstone). Returns the slot or None."""
        slot = self._slot_of_id.pop(node_id, None)
        if slot is None:
            return None
        self.valid[slot] = False
        self._id_of_slot[slot] = -1
        self._free_slots.append(slot)
        self._sort_cache = None
        return slot

    # -- data -----------------------------------------------------------------
    def write(self, slots: np.ndarray, embs: np.ndarray) -> None:
        """Write rows; slots < 0 are dropped (padding)."""
        keep = np.asarray(slots) >= 0
        idx = torch.from_numpy(np.asarray(slots)[keep].astype(np.int64))
        idx = idx.to(self.device)
        rows = torch.from_numpy(np.ascontiguousarray(
            np.asarray(embs, np.float32)[keep])).to(self.device)
        self.emb[idx] = rows
        self.valid[idx] = True

    def ids_of(self, slots: np.ndarray) -> np.ndarray:
        """Translate device slot results to user ids (-1 padding kept)."""
        return np.where(
            slots >= 0, self._id_of_slot[np.maximum(slots, 0)], -1
        )

    def filter_mask(self, filter_ids) -> np.ndarray:
        """bool[capacity] mask for a set of node ids.

        Large filter sets translate through a cached sorted view of
        ``_id_of_slot`` (one argsort per mutation epoch, then a vectorized
        searchsorted); small ones through the dict."""
        mask = np.zeros((self._capacity,), bool)
        ids = np.fromiter((int(i) for i in filter_ids), np.int64)
        if ids.size == 0:
            return mask
        if ids.size < 4096:  # small sets: dict loop beats the argsort
            for nid in ids:
                slot = self._slot_of_id.get(int(nid))
                if slot is not None:
                    mask[slot] = True
            return mask
        if self._sort_cache is None:
            order = np.argsort(self._id_of_slot, kind="stable")
            self._sort_cache = (self._id_of_slot[order],
                                order.astype(np.int64))
        sid, order = self._sort_cache
        pos = np.minimum(np.searchsorted(sid, ids), sid.size - 1)
        ok = (sid[pos] == ids) & (ids >= 0)
        mask[order[pos[ok]]] = True
        return mask

    # -- persistence helpers --------------------------------------------------
    def export_id_map(self) -> np.ndarray:
        return self._id_of_slot

    def import_id_map(self, id_of_slot: np.ndarray) -> None:
        self._sort_cache = None
        self._id_of_slot = np.asarray(id_of_slot)
        self._capacity = self._id_of_slot.shape[0]
        self._slot_of_id = {
            int(nid): s for s, nid in enumerate(self._id_of_slot) if nid >= 0
        }
        self._n_used = (
            1 + max(self._slot_of_id.values()) if self._slot_of_id else 0
        )
        used = set(self._slot_of_id.values())
        self._free_slots = [s for s in range(self._n_used) if s not in used]
