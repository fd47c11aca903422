"""Flat (exact brute-force) index on a torch device (port of
vector_db_tpu/index/flat.py).

Four precisions select the scan:

- ``f32``: the exact scan, ``l2_topk`` over the f32 table;
- ``bf16``: ``l2_topk`` over a bf16 mirror, then an exact f32 rescore of
  the k survivors; a self-calibration guard warns or refuses when bf16
  noise exceeds the corpus's neighbour gaps;
- ``blocksel``: the three-phase block-select scan over a PCA bf16 mirror
  (phase 1 ``block_min_scan``);
- ``blocksel2p``: the two-phase block-select scan over the same mirror
  (phase 1 ``block_topm_scan``).

Every precision reports exact f32 distances. The id map and the on-disk
index (npz with ``id_of_slot``) are the JAX package's, so either package
loads what the other saved.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from vector_db_tpu_torch.device import require_f32_matmul, resolve_device
from vector_db_tpu_torch.ops.distance import squared_norms
from vector_db_tpu_torch.ops.exact import (
    approx_search_tiled,
    block_select_search_2p,
    block_select_search_3p,
    exact_search_tiled,
    rescore_exact,
)
from vector_db_tpu_torch.storage import InMemoryNodeStorage, NodeStorage
from vector_db_tpu_torch.storage.device_store import DeviceVectorStore
from vector_db_tpu_torch.types import Node

MIN_CAPACITY = 256
_COV_CHUNK = 65536  # rows per covariance pass


def pca_projection(emb: torch.Tensor, valid: torch.Tensor,
                   dims: int) -> torch.Tensor:
    """The leading ``dims`` principal directions f32[dim, min(dims, dim)]
    of the valid rows (uncentered second moment): the covariance is a
    true-f32 product on the device (raises if CUDA matmuls may use TF32),
    the eigendecomposition runs on the host in float64."""
    require_f32_matmul(emb)
    dim = emb.shape[1]
    cov = emb.new_zeros((dim, dim))
    for s in range(0, emb.shape[0], _COV_CHUNK):
        e = torch.where(valid[s:s + _COV_CHUNK, None],
                        emb[s:s + _COV_CHUNK], 0.0)
        cov += e.T @ e
    n = max(1, int(valid.sum()))
    _, v = np.linalg.eigh(cov.cpu().numpy().astype(np.float64) / n)
    return torch.from_numpy(np.ascontiguousarray(
        v[:, ::-1][:, :min(dims, dim)], np.float32)).to(emb.device)


class FlatIndex:
    def __init__(
        self,
        storage: Optional[NodeStorage] = None,
        capacity: int = MIN_CAPACITY,
        index_file=None,
        metric: str = "l2",
        precision: str = "f32",
        bf16_guard: str = "warn",
        bf16_guard_recall: float = 0.9,
        device="cuda",
    ) -> None:
        if metric not in ("l2", "cosine"):
            raise ValueError(f"Unknown metric: {metric}")
        if precision not in ("f32", "bf16", "blocksel", "blocksel2p"):
            raise ValueError(f"Unknown precision: {precision}")
        if bf16_guard not in ("warn", "refuse", "off"):
            raise ValueError(f"Unknown bf16_guard: {bf16_guard}")
        # cosine: rows are L2-normalized at insert and queries at search,
        # so one L2 scan serves both; on unit vectors cos_dist = l2_sq / 2
        self.metric = metric
        self.precision = precision
        # bf16 selection noise can exceed neighbour gaps on unnormalized
        # low-dim corpora; the mirror self-calibrates against the exact
        # scan and keeps the measured recall in ``bf16_calibration``
        self.bf16_guard = bf16_guard
        self.bf16_guard_recall = float(bf16_guard_recall)
        self.bf16_calibration: Optional[float] = None
        self._calibrated_size = 0
        self.device = resolve_device(device)
        self.storage = storage or InMemoryNodeStorage()
        self.index_file = Path(index_file) if index_file else None
        self._store = DeviceVectorStore(capacity=capacity, device=self.device)
        self._mirror = None  # (emb_bf16, x_sq) cache
        self._mirror_stale = True
        self._proj = None  # (proj, tab_bf16, x_sq) blocksel mirror
        self._proj_stale = True

    @property
    def size(self) -> int:
        return self._store.size

    def insert_nodes(self, nodes: Sequence[Node]) -> None:
        if not nodes:
            return
        for node in nodes:
            self.storage.save(node)
        seen: Set[int] = set()
        fresh = []
        for n in nodes:  # dedupe against the store AND within the batch
            if n.id in self._store or n.id in seen:
                continue
            seen.add(n.id)
            fresh.append(n)
        if not fresh:
            return
        embs = np.stack([np.asarray(n.embedding, np.float32) for n in fresh])
        if self.metric == "cosine":
            embs = embs / np.maximum(
                np.linalg.norm(embs, axis=1, keepdims=True), 1e-12
            )
        self._store.ensure_dim(embs.shape[1])
        slots = self._store.take_slots([n.id for n in fresh])
        self._store.write(slots, embs)
        self._mirror_stale = True
        self._proj_stale = True

    def insert_node(self, node: Node) -> None:
        self.insert_nodes([node])

    def build_index(self, nodes: Sequence[Node]) -> None:
        self.insert_nodes(nodes)

    def load_state(self, emb: np.ndarray, valid: np.ndarray,
                   id_of_slot: np.ndarray) -> None:
        """Adopt another index's device state: a JAX ``FlatIndex``'s
        ``np.asarray(idx._store.emb)``, ``np.asarray(idx._store.valid)``
        and ``idx._store.export_id_map()``. Rows are taken as stored
        (already normalized under the cosine metric)."""
        self._store = DeviceVectorStore.from_arrays(
            emb, valid, id_of_slot, device=self.device)
        self._mirror_stale = True
        self._proj_stale = True
        self._calibrated_size = 0

    def delete_node(self, node_id: int) -> None:
        if self._store.release(node_id) is None:
            return
        self._mirror_stale = True
        self._proj_stale = True
        if hasattr(self.storage, "delete"):
            self.storage.delete(node_id)

    def _bf16_mirror(self):
        """bf16 copy of the table + f32 row norms, refreshed after
        mutations (one cast pass over the table)."""
        if self._mirror is None or self._mirror_stale:
            emb = self._store.emb
            self._mirror = (emb.to(torch.bfloat16), squared_norms(emb))
            self._mirror_stale = False
        return self._mirror

    def _proj_mirror(self, dims: int = 128):
        """(proj f32[dim, ds], tab bf16[capacity, ds], x_sq f32): the PCA
        mirror of the blocksel scans (:func:`pca_projection`)."""
        if self._proj is None or self._proj_stale:
            emb = self._store.emb
            proj = pca_projection(emb, self._store.valid, dims)
            tab = (emb @ proj).to(torch.bfloat16)
            self._proj = (proj, tab, squared_norms(emb))
            self._proj_stale = False
        return self._proj

    def _calibrate_bf16(self) -> None:
        """Self-check the bf16 mirror: recall@10 of bf16 selection vs the
        exact scan on up to 64 live rows, re-run when the corpus doubles.
        Warns (or refuses, per ``bf16_guard``) below
        ``bf16_guard_recall``."""
        if self.bf16_guard == "off" or self.size < 256:
            return
        if self._calibrated_size and self.size < 2 * self._calibrated_size:
            return
        nq, kcal = 64, 10
        valid = self._store.valid
        slots = torch.nonzero(valid).flatten()[:nq]
        slots = torch.cat([slots, slots.new_zeros(nq - slots.numel())])
        qcal = self._store.emb[slots]
        emb16, x_sq = self._bf16_mirror()
        _, approx = approx_search_tiled(
            qcal, emb16, valid, kcal,
            tile=min(self._store.capacity, 125000), x_sq=x_sq)
        _, exact = exact_search_tiled(
            qcal, self._store.emb, valid, kcal,
            tile=min(self._store.capacity, 65536))
        a, e = approx.cpu().numpy(), exact.cpu().numpy()
        hits = sum(
            len(set(a[i].tolist()) & set(e[i].tolist())) for i in range(nq)
        )
        want = int((e >= 0).sum())
        self.bf16_calibration = hits / max(1, want)
        self._calibrated_size = self.size
        if self.bf16_calibration < self.bf16_guard_recall:
            msg = (
                f"bf16 scan calibration recall@{kcal} = "
                f"{self.bf16_calibration:.3f} < {self.bf16_guard_recall} "
                f"on {self.size} live rows: bf16 truncation noise exceeds "
                "this corpus's neighbor gaps (typical on unnormalized "
                "low-dim data). Use precision='blocksel' (exact, "
                "comparable QPS) or 'f32', or normalize the corpus. Set "
                "bf16_guard='off' to silence."
            )
            if self.bf16_guard == "refuse":
                raise RuntimeError(msg)
            warnings.warn(msg, stacklevel=3)

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_ids: Optional[Set[int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(dists f32[B, k], node ids int64[B, k]), (inf, -1) padded;
        distances are L2 (metric='l2') or cosine distance (metric='cosine')."""
        q = np.asarray(queries, np.float32)
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        if self.size == 0:
            return (
                np.full((q.shape[0], k), np.inf, np.float32),
                np.full((q.shape[0], k), -1, np.int64),
            )
        emb = self._store.emb
        valid = self._store.valid
        if filter_ids is not None:
            valid = valid & torch.from_numpy(
                self._store.filter_mask(filter_ids)).to(self.device)
        qd = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        if self.precision == "bf16":
            self._calibrate_bf16()
            emb16, x_sq = self._bf16_mirror()
            _, slots = approx_search_tiled(
                qd, emb16, valid, k,
                tile=min(self._store.capacity, 125000), x_sq=x_sq)
            # selection ran in bf16; report full-precision distances
            d_sq, slots = rescore_exact(qd, emb, slots)
        elif self.precision in ("blocksel", "blocksel2p"):
            proj, tab, x_sq = self._proj_mirror()
            qp = qd @ proj
            if self.precision == "blocksel":
                d_sq, slots = block_select_search_3p(
                    qd, tab, qp, x_sq, emb, valid, k,
                    blocks_k=max(2 * k, 20), rows_k=max(8 * k, 80))
            else:
                # m=2 while k <= 16: the rank-m in-block condition only
                # bites when > m true neighbours share one 128-row block
                d_sq, slots = block_select_search_2p(
                    qd, tab, qp, x_sq, emb, valid, k,
                    block=128, m=2 if k <= 16 else 4, rows_k=max(8 * k, 80))
        else:
            d_sq, slots = exact_search_tiled(qd, emb, valid, k)
        d_sq = d_sq.cpu().numpy()
        slots = slots.cpu().numpy()
        ids = self._store.ids_of(slots)
        if self.metric == "cosine":
            # on unit vectors: cos_dist = 1 - cos = ||a-b||^2 / 2
            dists = np.where(slots >= 0, np.maximum(d_sq, 0.0) / 2.0, np.inf)
        else:
            dists = np.where(
                slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)), np.inf
            )
        return dists.astype(np.float32), ids

    def save_index(self) -> None:
        """Persist the slot->id map; embeddings rehydrate from storage."""
        if self.index_file is None or self._store.emb is None:
            return
        self.index_file.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            self.index_file, id_of_slot=self._store.export_id_map()
        )

    def load_index(self) -> None:
        if self.index_file is None or not self.index_file.exists():
            return
        with np.load(self.index_file) as z:
            id_of_slot = np.asarray(z["id_of_slot"])
        nodes = []
        for nid in id_of_slot[id_of_slot >= 0]:
            node = self.storage.get(int(nid))
            if node is not None:
                nodes.append(node)
        self.insert_nodes(nodes)

    def search(self, query: np.ndarray, k: int, **kwargs) -> List[Tuple[Node, float]]:
        dists, ids = self.search_batch(
            np.asarray(query, np.float32)[None, :], k,
            filter_ids=kwargs.get("filter_ids"),
        )
        out = []
        for nid, d in zip(ids[0], dists[0]):
            if nid < 0:
                continue
            node = self.storage.get(int(nid))
            if node is not None:
                out.append((node, float(d)))
        return out
