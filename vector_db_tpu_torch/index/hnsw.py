"""Host-facing HNSW index on a torch device (port of
vector_db_tpu/index/hnsw.py).

Same constructor ``HNSW(M, ef_construction, rng, storage, index_file)``, the
same level sampling ``int(-ln(U) / ln(M))`` from the caller's
``random.Random`` stream (so levels equal the JAX package's), delete with
entry re-election, and ``search(query, k, ef=, filter_ids=)`` returning
``[(Node, distance)]``. Embeddings live in an f32[capacity, dim] table on
the device (``DeviceVectorStore``) and the graph in fixed-degree neighbor
tables beside it (``hnsw_kernels.Graph``).

What runs on the port: the bulk build from exact or clustered kNN
(``bulk_build``), streaming inserts into a live graph (``insert_nodes``,
``insert_arrays``, ``insert_node``, ``build_index``: storage first, then
exact or beam candidates and the grouped or sequential edge commit, per
batch), delete, the classic best-first search (``search_batch``,
``search``), PQ and projected traversal (``enable_pq``,
``search_batch_pq``, ``refresh_pq_codes``; ``enable_rp``,
``search_batch_rp``), wide-beam search (``enable_wide`` with or without
the int8 inline tables, ``search_batch_wide`` over the exact or the
PQ-decoded mirror) and the pool-free beam (``search_batch_beam``),
persistence in the JAX package's split-adjacency npz (``save_index``,
``load_index``, ``snapshot_for_save``, ``write_snapshot``, with the trained
PQ, RP and wide-beam state; a load re-links rows that storage holds and the
graph does not, ``recover_unlinked``), and the corpus scans over the same
table (``search_batch_scan``: bf16, exact, blocksel). ``load_state``
adopts a JAX index's arrays.

The tables are updated in place; a mutation counter (``_version``)
invalidates the derived mirrors and the PQ codes (the JAX package tracks
array identity, and leaves PQ codes to ``refresh_pq_codes``): each
rebuilds on first use after a change.
"""

from __future__ import annotations

import math
import os
import random
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from vector_db_tpu_torch.device import require_f32_matmul, resolve_device
from vector_db_tpu_torch.index import hnsw_kernels as K
from vector_db_tpu_torch.index import wide_beam as WB
from vector_db_tpu_torch.index.flat import pca_projection
from vector_db_tpu_torch.index.pq import PQCodec, _encode_scan
from vector_db_tpu_torch.observability import count, span
from vector_db_tpu_torch.ops.distance import squared_norms
from vector_db_tpu_torch.ops.exact import (
    approx_search_tiled,
    block_select_search,
    exact_search_tiled,
    rescore_exact,
)
from vector_db_tpu_torch.ops.graph_build import (
    assign_topk_clusters,
    build_forward_edges,
    clustered_knn_merge,
    nn_descent_round,
    occlusion_prune_tiled,
    reverse_merge,
)
from vector_db_tpu_torch.ops.kmeans import kmeans
from vector_db_tpu_torch.storage import InMemoryNodeStorage, NodeStorage
from vector_db_tpu_torch.storage.device_store import DeviceVectorStore
from vector_db_tpu_torch.types import Node

DEFAULT_L_MAX = 6
MIN_CAPACITY = 256

# bulk_build level-size thresholds (module-level so tests can exercise
# every branch on small corpora):
# - up to HOST: plain numpy on the host;
# - above EXACT: O(n^2) exact kNN is too expensive, so the
#   cluster-partitioned pipeline runs instead.
BULK_HOST_THRESHOLD = 8192
BULK_EXACT_THRESHOLD = 262144

# trained state an index file carries besides the graph (f32 arrays)
_AUX_KEYS = ("wb_proj", "rp_proj", "pq_codebooks", "pq_rotation")
# the inline tables' auto qchunk: max frontier * queries a chunk
_INLINE_BUDGET = 262144


def _up2(v: int, lo: int = 8) -> int:
    return max(lo, 1 << (int(v) - 1).bit_length())


def _reverse_merge(fwd_i: np.ndarray, fwd_d: np.ndarray, width: int) -> np.ndarray:
    """Combine forward edges with reverse edges, keeping the closest
    ``width`` per row (the bulk-build analog of append-backlink-then-prune).

    fwd_i/fwd_d: [n, deg] local neighbor indices/distances (-1/inf padded).
    Returns rows int32[n, width].
    """
    n, deg = fwd_i.shape
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = fwd_i.ravel().astype(np.int64)
    dd = fwd_d.ravel()
    keep = dst >= 0
    src, dst, dd = src[keep], dst[keep], dd[keep]
    # undirected edge set (v, u, d), deduped on (v, u)
    v = np.concatenate([src, dst])
    u = np.concatenate([dst, src])
    w = np.concatenate([dd, dd])
    _, first = np.unique(v * n + u, return_index=True)
    v, u, w = v[first], u[first], w[first]
    # rank each node's edges by distance; keep the closest `width`
    order = np.lexsort((w, v))
    v, u = v[order], u[order]
    starts = np.searchsorted(v, np.arange(n), "left")
    ranks = np.arange(v.size) - starts[v]
    sel = ranks < width
    rows = np.full((n, width), -1, np.int32)
    rows[v[sel], ranks[sel]] = u[sel].astype(np.int32)
    return rows


def _clustered_forward(
    embeddings: torch.Tensor,
    deg: int,
    seed: int = 0,
    spill: int = 3,
    lmax_cap: int = 8192,
    refine_rounds: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate forward edges for large corpora by cluster-partitioned
    exact kNN: k-means into ~sqrt(n) cells, every point in its ``spill``
    nearest cells, exact kNN within each cell, the best of the union per
    point, then ``refine_rounds`` NN-descent rounds for the neighbors the
    partition missed. ``embeddings`` is a device tensor; the edge tables
    stay on its device. k-means draws its initial rows from a
    ``torch.Generator`` seeded with ``seed``, so cells differ from the JAX
    package's (``jax.random``)."""
    n = embeddings.shape[0]
    dev = embeddings.device
    c = max(64, 1 << int(round(math.log2(math.sqrt(n)))))
    rng = np.random.default_rng(seed)

    sample_idx = np.sort(rng.choice(n, min(n, 131072), replace=False))
    sample = embeddings[torch.from_numpy(sample_idx).to(dev)]
    cents, _ = kmeans(sample, c, torch.Generator().manual_seed(seed),
                      iters=15)
    del sample
    assign = assign_topk_clusters(embeddings, cents, k=spill).cpu().numpy()

    # padded member table; over-full cells truncate their later-spill
    # entries (primary assignments rank first within each cell, so every
    # point keeps at least its own cell): stable-sort the (cell, point)
    # pairs in spill-major order and rank within the cell
    cl = assign.T.reshape(-1).astype(np.int64)
    pt = np.tile(np.arange(n, dtype=np.int32), spill)
    order = np.argsort(cl, kind="stable")
    cl_s, pt_s = cl[order], pt[order]
    starts = np.searchsorted(cl_s, np.arange(c))
    ranks = np.arange(cl_s.size) - starts[cl_s]
    lmax = int(ranks.max()) + 1 if ranks.size else 1
    lmax = min(max(256, lmax), lmax_cap)
    lmax = ((lmax + 255) // 256) * 256
    keep = ranks < lmax
    members = np.full((c, lmax), -1, np.int32)
    members[cl_s[keep], ranks[keep]] = pt_s[keep]

    fwd_d, fwd_i = clustered_knn_merge(
        embeddings, torch.from_numpy(members).to(dev), deg)
    # the [chunk, deg * sample, dim] gather stays under 1 GB
    nd_sample = max(4, min(8, deg // 2))
    nd_chunk = 2048 if deg * nd_sample <= 128 else 1024
    for _ in range(refine_rounds):
        fwd_d, fwd_i = nn_descent_round(embeddings, fwd_d, fwd_i, deg,
                                        chunk=nd_chunk, sample=nd_sample)
    return fwd_d, fwd_i


class HNSW:
    def __init__(
        self,
        M: int,
        ef_construction: int,
        rng: random.Random,
        storage: Optional[NodeStorage] = None,
        index_file: Optional[Union[str, Path]] = None,
        l_max: int = DEFAULT_L_MAX,
        capacity: int = MIN_CAPACITY,
        max_steps: int = 0,
        precision: str = "f32",
        device="cuda",
    ) -> None:
        self.M = int(M)
        self.M_max = self.M
        self.M_max0 = self.M * 2
        self.ef_construction = int(ef_construction)
        self.rng = rng
        self.storage = storage or InMemoryNodeStorage()
        self.index_file = Path(index_file) if index_file else None
        self.l_max = int(l_max)
        self.level_mult = 1.0 / math.log(self.M) if self.M > 1 else 1.0
        # beam expansion budget; 0 = auto (2*ef + 16 at query time)
        self.max_steps = int(max_steps)
        # traversal precision: "bf16" gathers beam rows from a bf16 mirror;
        # final results are re-scored exactly from the f32 table
        if precision not in ("f32", "bf16"):
            raise ValueError("precision must be 'f32' or 'bf16'")
        self.precision = precision
        # edge commit: "grouped" (batch-parallel) or "sequential" (item at
        # a time)
        self.commit_mode = "grouped"
        # insert candidates: "exact" (a masked scan of the table) or
        # "beam" (per-point construction beam, insert_expand pops a step)
        self.construction_mode = "exact"
        self.insert_expand = 4
        self.device = resolve_device(device)
        self.graph: Optional[K.Graph] = None
        self._levels_host: Optional[np.ndarray] = None
        self._version = 0       # bumped by every table mutation
        self._emb16 = None      # (version, bf16 mirror: traversal, scans)
        self._wb = None         # (version, aug mirror, seeds, inline tables)
        self._wb_pq = None      # (version, PQ-decoded aug mirror)
        self._wb_inline = False  # enable_wide(inline=True): inline tables
        self._scan_sq = None    # (version, f32 row norms for the scans)
        self._pq: Optional[PQCodec] = None
        self._pq_codes = None   # (version, int32[capacity, m] codes)
        self._rp_proj: Optional[torch.Tensor] = None   # f32[dim, dp]
        self._rp = None         # (version, bf16 x^ mirror, f32 ||x||^2)
        self._store = DeviceVectorStore(capacity=capacity,
                                        on_grow=self._grow_graph,
                                        device=self.device)
        if self.index_file and self.index_file.exists():
            self.load_index()

    # -- store aliases (device tables live in DeviceVectorStore) ----------
    @property
    def _emb(self):
        return self._store.emb

    @property
    def _has_emb(self):
        return self._store.valid

    @property
    def _capacity(self) -> int:
        return self._store.capacity

    @property
    def _dim(self):
        return self._store.dim

    @property
    def _id_of_slot(self):
        return self._store.export_id_map()

    @property
    def _slot_of_id(self):
        return self._store._slot_of_id

    @property
    def size(self) -> int:
        return self._store.size

    def __len__(self) -> int:
        return self.size

    def sample_level(self) -> int:
        """Geometric level sampling, clamped to the table depth."""
        lvl = int(-math.log(self.rng.random()) * self.level_mult)
        return min(lvl, self.l_max - 1)

    # ------------------------------------------------------------------
    def _ensure_init(self, dim: int) -> None:
        had_dim = self._store.dim is not None
        self._store.ensure_dim(dim)
        if not had_dim and self.graph is None:
            self.graph = K.empty_graph(self._capacity, self.M, self.l_max,
                                       self.device)
            self._levels_host = np.full((self._capacity,), -1, np.int32)

    def _grow_graph(self, old_cap: int, new_cap: int) -> None:
        """DeviceVectorStore growth hook: pad the graph tables in step."""
        self._version += 1
        if self.graph is None:
            return
        pad = new_cap - old_cap
        g = self.graph
        g.neighbors = torch.cat([g.neighbors, g.neighbors.new_full(
            (pad, g.neighbors.shape[1]), -1)])
        g.levels = torch.cat([g.levels, g.levels.new_full((pad,), -1)])
        if self._levels_host is not None:
            self._levels_host = np.concatenate(
                [self._levels_host, np.full((pad,), -1, np.int32)])

    # ------------------------------------------------------------------
    def insert_node(self, node: Node) -> None:
        self.insert_nodes([node])

    def build_index(self, nodes: Sequence[Node]) -> None:
        self.insert_nodes(nodes)

    def insert_nodes(self, nodes: Sequence[Node], batch_size: int = 1024) -> None:
        """Insert nodes: all of them to storage first (one ``save_many``
        where the storage has it), then the ones not in the index yet, the
        first copy of an id in the batch, into the graph, ``batch_size``
        at a time. Levels come from ``self.rng`` in insertion order, as in
        the JAX package, so both build the same graph from one stream.
        An empty index streams too: ``bulk_build`` is the caller's choice
        (the indexing service routes a first large batch there)."""
        if not nodes:
            return
        save_many = getattr(self.storage, "save_many", None)
        if save_many is not None:
            save_many(list(nodes))
        else:
            for node in nodes:
                self.storage.save(node)
        self.insert_arrays(
            [n.id for n in nodes],
            np.stack([np.asarray(n.embedding, np.float32) for n in nodes]),
            batch_size)

    def insert_arrays(self, ids: Sequence[int], embeddings: np.ndarray,
                      batch_size: int = 1024) -> None:
        """Insert rows into the graph and the device table only (no
        storage write), ``batch_size`` at a time; ids already in the index
        and repeats within the call are skipped."""
        embeddings = np.asarray(embeddings, np.float32)
        seen: Set[int] = set()
        keep = []
        for i, nid in enumerate(ids):
            if nid in self._slot_of_id or nid in seen:
                continue
            seen.add(nid)
            keep.append(i)
        if not keep:
            return
        self._ensure_init(embeddings.shape[1])
        for s in range(0, len(keep), batch_size):
            sel = keep[s:s + batch_size]
            self._insert_rows([int(ids[i]) for i in sel], embeddings[sel])

    def _insert_rows(self, ids: List[int], embs_np: np.ndarray) -> None:
        """One batch: slots, then levels, then the rows into the table
        (valid, at level -1 until the commit), then candidates and the
        commit on the device."""
        slots = self._store.take_slots(ids)
        levels = np.array([self.sample_level() for _ in ids], np.int32)
        self._store.write(slots, embs_np)
        self._levels_host[slots] = levels
        dev = self.device
        new_emb = torch.from_numpy(
            np.ascontiguousarray(embs_np, np.float32)).to(dev)
        new_slots = torch.from_numpy(slots).to(dev)
        new_levels = torch.from_numpy(levels).to(dev)
        if self.construction_mode == "exact":
            K.insert_step_exact(
                self.graph, self._emb, self._has_emb, new_emb, new_slots,
                new_levels, M=self.M, l_max=self.l_max,
                ef_construction=self.ef_construction,
                ef_upper=min(self.ef_construction, 64),
                commit=self.commit_mode)
        else:
            expand = max(1, int(self.insert_expand))
            max_steps = self.max_steps or (2 * self.ef_construction + 16)
            K.insert_step(
                self.graph, self._emb, self._has_emb, new_emb, new_slots,
                new_levels, M=self.M, l_max=self.l_max,
                ef_construction=self.ef_construction,
                max_steps=max(48, max_steps // expand),
                commit=self.commit_mode, expand=expand)
        self._version += 1

    def bulk_build(
        self,
        ids: Sequence[int],
        embeddings: np.ndarray,
        query_chunk: int = 2048,
        cand_factor: int = 4,
        alpha: float = 1.0,
    ) -> None:
        """Bulk construction from kNN tables computed on the device, level
        by level: every node's ``cand_factor * M`` exact nearest neighbors
        among the level's nodes, occlusion-pruned to M forward edges; then
        reverse edges, keeping the closest ``m_limit`` per row (2M at level
        0, M above). A level of at most ``BULK_HOST_THRESHOLD`` nodes runs
        in numpy with the naive closest-M rule; one above
        ``BULK_EXACT_THRESHOLD`` runs the clustered pipeline at full row
        width (alpha != 1 prunes it to M alpha-occluded edges). Requires an
        empty index."""
        if self.size > 0:
            raise ValueError("bulk_build requires an empty index")
        embeddings = np.asarray(embeddings, np.float32)
        ids = list(ids)
        if len(set(ids)) != len(ids):  # keep first occurrence per id
            seen: Set[int] = set()
            keep = []
            for i, nid in enumerate(ids):
                if nid not in seen:
                    seen.add(nid)
                    keep.append(i)
            ids = [ids[i] for i in keep]
            embeddings = embeddings[keep]
        n = embeddings.shape[0]
        if n == 0:
            return
        self._ensure_init(embeddings.shape[1])
        self._store.grow_to(n)

        slots = self._store.take_slots(list(ids))
        levels_np = np.array([self.sample_level() for _ in range(n)], np.int32)
        self._store.write(slots, embeddings)
        self._version += 1

        dev = self.device
        nb = torch.full((self._capacity, K.ncols(self.M, self.l_max)), -1,
                        dtype=torch.int32, device=dev)
        levels_full = np.full((self._capacity,), -1, np.int32)
        levels_full[slots] = levels_np
        self._levels_host = levels_full.copy()

        host_threshold = BULK_HOST_THRESHOLD
        exact_threshold = BULK_EXACT_THRESHOLD
        for level in range(self.l_max):
            sub = np.arange(n) if level == 0 else np.nonzero(
                levels_np >= level)[0]
            if sub.size <= 1:
                continue
            width = K.level_width(level, self.M)
            deg = min(self.M, sub.size - 1)
            start = K.level_col_start(level, self.M)
            sub_slots = slots[sub].astype(np.int64)
            slots_dev = torch.from_numpy(sub_slots).to(dev)

            if sub.size > exact_threshold:
                src = self._store.emb[slots_dev]
                fwd_d, fwd_i = _clustered_forward(
                    src, min(width, sub.size - 1), seed=level)
                if alpha != 1.0:
                    # diversify to M alpha-occluded forward edges (the
                    # reverse merge refills rows back to `width`)
                    fwd_d, fwd_i = occlusion_prune_tiled(
                        src, fwd_d, fwd_i, deg=deg, chunk=2048, alpha=alpha)
                del src
                rows = reverse_merge(fwd_d, fwd_i, width)
                nb[slots_dev, start:start + width] = torch.where(
                    rows >= 0, slots_dev[rows.clamp_min(0).long()].int(), -1)
                continue
            if sub.size <= host_threshold:
                # tiny level: numpy, naive closest-deg selection
                se = embeddings[sub]
                sq = (se * se).sum(-1)
                d = sq[:, None] - 2.0 * (se @ se.T) + sq[None, :]
                np.fill_diagonal(d, np.inf)
                part = np.argpartition(d, min(deg, d.shape[1] - 1),
                                       axis=1)[:, :deg]
                pd = np.take_along_axis(d, part, axis=1)
                order = np.take_along_axis(part, np.argsort(pd, axis=1),
                                           axis=1)
                fwd_i = order.astype(np.int32)
                fwd_d = np.take_along_axis(d, order, axis=1).astype(np.float32)
            else:
                k_cand = min(cand_factor * self.M, sub.size - 1)
                # query chunk sized so the [chunk, n] distances of the
                # plain scan stay ~512 MB
                chunk = min(query_chunk, max(128, (1 << 27) // sub.size))
                chunk = 1 << (chunk.bit_length() - 1)
                src = self._store.emb[slots_dev]
                valid = torch.ones(sub.size, dtype=torch.bool, device=dev)
                fd, fi = build_forward_edges(src, valid, deg=deg,
                                             k_cand=k_cand, chunk=chunk,
                                             alpha=alpha)
                del src
                fwd_d, fwd_i = fd.cpu().numpy(), fi.cpu().numpy()
            rows = _reverse_merge(fwd_i, fwd_d, width)
            mapped = np.where(rows >= 0, sub_slots[np.maximum(rows, 0)], -1)
            nb[slots_dev, start:start + width] = torch.from_numpy(
                mapped.astype(np.int32)).to(dev)

        entry_idx = int(np.argmax(levels_np))
        self.graph = K.Graph(neighbors=nb,
                             levels=torch.from_numpy(levels_full).to(dev),
                             entry=int(slots[entry_idx]),
                             entry_level=int(levels_np[entry_idx]))

    def load_state(self, neighbors, levels, entry, entry_level, emb, valid,
                   id_of_slot, pq_codebooks=None, pq_rotation=None,
                   pq_codes=None, rp_proj=None, wb_proj=None,
                   wb_n_seeds=None, wb_inline=False) -> None:
        """Adopt another index's state: a JAX ``HNSW``'s
        ``np.asarray(graph.neighbors)``, ``np.asarray(graph.levels)``,
        ``int(graph.entry)``, ``int(graph.entry_level)``, and its store's
        ``np.asarray(emb)``, ``np.asarray(valid)`` and
        ``export_id_map()``; with its trained state where given: the PQ
        codec (``_pq.codebooks``, ``_pq.rotation``) and codes
        (``_pq_codes``; re-encoded when omitted), the RP projection
        (``_rp_proj``), and the wide beam's state as ``enable_wide`` leaves
        it (``_wb_proj``, ``_wb_n_seeds``, ``_wb_inline``): with
        ``wb_n_seeds`` the wide beam is enabled with that projection."""
        neighbors = np.asarray(neighbors, np.int32)
        levels = np.asarray(levels, np.int32)
        if neighbors.shape != (levels.shape[0],
                               K.ncols(self.M, self.l_max)):
            raise ValueError(
                f"load_state: neighbors {neighbors.shape} do not match "
                f"capacity {levels.shape[0]}, M={self.M}, l_max={self.l_max}")
        self._store = DeviceVectorStore.from_arrays(
            emb, valid, id_of_slot, device=self.device)
        self._store._on_grow = self._grow_graph
        self.graph = K.Graph(
            neighbors=torch.tensor(neighbors, device=self.device),
            levels=torch.tensor(levels, device=self.device),
            entry=int(entry), entry_level=int(entry_level))
        self._levels_host = levels.copy()
        self._version += 1
        dev = self.device
        self._pq = self._pq_codes = None
        if pq_codebooks is not None:
            self._pq = PQCodec.from_arrays(pq_codebooks, pq_rotation,
                                           device=dev)
            if pq_codes is not None:
                self._pq_codes = (self._version, torch.tensor(
                    np.asarray(pq_codes, np.int32), device=dev))
        self._rp_proj = (None if rp_proj is None else
                         torch.tensor(np.asarray(rp_proj, np.float32),
                                      device=dev))
        self._rp = None
        if wb_n_seeds is not None:
            self._wb_proj = (None if wb_proj is None else torch.tensor(
                np.asarray(wb_proj, np.float32), device=dev))
            self._wb_n_seeds = int(wb_n_seeds)
            self._wb_inline = bool(wb_inline)
            self._wb = self._wb_pq = None

    # ------------------------------------------------------------------
    def delete_node(self, node_id: int) -> None:
        """Delete: unlink edges, re-elect the entry, drop from storage."""
        slot = self._store.release(node_id)
        if slot is None:
            return
        if self._levels_host is not None:
            self._levels_host[slot] = -1
        K.delete_slot(self.graph, slot, M=self.M, l_max=self.l_max)
        self._version += 1
        if hasattr(self.storage, "delete"):
            self.storage.delete(node_id)

    # ------------------------------------------------------------------
    def enable_pq(self, chunks: int = 16, ksub: int = 256, seed: int = 0,
                  restarts: int = 2, opq_iters: int = 0) -> None:
        """PQ traversal: train per-subspace codebooks (after an OPQ rotation
        when ``opq_iters`` > 0) on up to 131,072 live rows and encode the
        table; ``search_batch_pq`` then traverses on ADC estimates and
        reranks exactly, and ``search_batch_wide(score="pq")`` /
        ``search_batch_beam(score="pq")`` score from the PQ-decoded
        mirror."""
        if self._dim is None or self.size == 0:
            raise ValueError("enable_pq requires a populated index")
        ksub = min(ksub, max(2, self.size))
        self._pq = PQCodec(k=ksub, chunks=chunks, dim=self._dim,
                           device=self.device)
        live_slots = np.asarray(sorted(self._slot_of_id.values()))
        if live_slots.size > 131072:
            live_slots = np.random.default_rng(seed).choice(
                live_slots, 131072, replace=False)
        sample = self._emb[torch.from_numpy(live_slots).to(
            self.device)].cpu().numpy()
        self._pq.train(sample, seed=seed, restarts=restarts,
                       opq_iters=opq_iters)
        self.refresh_pq_codes()

    def refresh_pq_codes(self) -> None:
        """Encode the whole table (dead rows too: masked at query time) with
        the trained codebooks, no retraining. The PQ searches call it
        themselves once the table changed since the last encode."""
        if self._pq is None:
            return
        self._pq_codes = (self._version, _encode_scan(
            self._emb, self._pq.codebooks, chunk=8192,
            rotation=self._pq.rotation))

    def _pq_table(self) -> torch.Tensor:
        """The PQ codes of the current table (re-encoded after a change)."""
        if self._pq_codes is None or self._pq_codes[0] != self._version:
            self.refresh_pq_codes()
        return self._pq_codes[1]

    def search_batch_pq(
        self,
        queries: np.ndarray,
        k: int,
        ef: int = 50,
        expand: int = 1,
        rerank: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """PQ-traversal search (requires enable_pq). Same contract as
        search_batch; without ``rerank`` the distances are the ADC
        estimates."""
        if self._pq is None:
            raise ValueError("call enable_pq() first")
        queries = np.asarray(queries, np.float32)
        if self.size == 0:
            b = queries.shape[0]
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int64))
        ef = max(ef, k)
        q_dev = torch.from_numpy(queries).to(self.device)
        d_sq, slots = K.search_batch_pq(
            self.graph, self._pq_table(), self._pq.codebooks, self._emb,
            self._has_emb, q_dev, self._pq.rotate_queries(queries),
            M=self.M, l_max=self.l_max, ef=ef, k=k,
            max_steps=self.max_steps or (2 * ef + 16), expand=expand,
            rerank=rerank)
        return self._to_host(d_sq, slots, queries.shape[0], k)

    def enable_rp(self, dims: int = 128, train_sample: int = 131072,
                  seed: int = 0) -> None:
        """Projected traversal (pHNSW-style): the beam scores a bf16 PCA
        mirror x^ = x @ R of ``dims`` columns with ``||x||^2 - 2 q^ . x^``,
        and the ef candidates are rescored exactly. The mirror rebuilds on
        first use after a change to the table."""
        if self.graph is None or self.size == 0:
            raise ValueError("index must contain vectors before enable_rp")
        self._rp_proj = self._pca_proj(int(min(dims, self._dim)))
        self._rp = None

    def _rp_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x^ bf16[capacity, dims], ||x||^2 f32[capacity]), rebuilt after
        any mutation (cached under ``_version``)."""
        if self._rp is None or self._rp[0] != self._version:
            emb = self._store.emb
            require_f32_matmul(emb)
            self._rp = (self._version,
                        (emb @ self._rp_proj).to(torch.bfloat16),
                        squared_norms(emb))
        return self._rp[1], self._rp[2]

    def search_batch_rp(
        self,
        queries: np.ndarray,
        k: int,
        ef: int = 50,
        expand: int = 1,
        bucket: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Projected-traversal search (requires enable_rp). Same contract
        as search_batch, ef, k and B bucketed as there."""
        if self._rp_proj is None:
            raise ValueError("call enable_rp() first")
        queries = np.asarray(queries, np.float32)
        b_orig, k_orig = queries.shape[0], k
        if self.size == 0 or self.graph is None:
            return (np.full((b_orig, k), np.inf, np.float32),
                    np.full((b_orig, k), -1, np.int64))
        ef = max(ef, k)
        if bucket:
            ef = _up2(ef, lo=16)
            k = min(_up2(k, lo=8), ef)
            b_pad = _up2(b_orig, lo=8) - b_orig
            if b_pad:
                queries = np.concatenate(
                    [queries, np.zeros((b_pad, queries.shape[1]), np.float32)])
        rp, xsq = self._rp_tables()
        q_dev = torch.from_numpy(queries).to(self.device)
        d_sq, slots = K.search_batch_rp(
            self.graph, rp, xsq, self._emb, self._has_emb, q_dev,
            q_dev @ self._rp_proj, M=self.M, l_max=self.l_max, ef=ef, k=k,
            max_steps=self.max_steps or (2 * ef + 16), expand=expand)
        return self._to_host(d_sq, slots, b_orig, k_orig)

    def search_batch_beam(
        self,
        queries: np.ndarray,
        k: int,
        frontier: int = 224,
        steps: int = 12,
        rerank_k: int = 0,
        hist: int = 2,
        bucket: bool = True,
        score: str = "exact",
        filter_ids=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pool-free beam search (requires enable_wide; see
        :func:`wide_beam.beam_search`): same contract as search_batch.
        ``score="pq"`` traverses on the PQ-decoded mirror (requires
        enable_pq), else the inline tables where ``enable_wide(inline=True)``
        built them, else the aug mirror. ``filter_ids`` masks the kept
        trajectory (navigation unfiltered)."""
        if not hasattr(self, "_wb_n_seeds"):
            raise ValueError("call enable_wide() first")
        if score == "pq" and self._pq is None:
            raise ValueError("score='pq' requires enable_pq()")
        queries = np.asarray(queries, np.float32)
        b_orig, k_orig = queries.shape[0], k
        if self.size == 0 or self.graph is None:
            return (np.full((b_orig, k), np.inf, np.float32),
                    np.full((b_orig, k), -1, np.int64))
        if bucket:
            k = _up2(k, lo=8)
            b_pad = _up2(b_orig, lo=8) - b_orig
            if b_pad:
                queries = np.concatenate(
                    [queries, np.zeros((b_pad, queries.shape[1]), np.float32)])
        rerank_k = rerank_k or max(4 * k, 64)
        aug, seeds, inline_tabs = self._wide_scoring(score)
        q_dev = torch.from_numpy(queries).to(self.device)
        qa = WB.aug_queries(q_dev, self._wb_proj, aug.shape[1])
        res_mask = (torch.from_numpy(self._store.filter_mask(filter_ids)).to(
            self.device) if filter_ids is not None else None)
        d_sq, slots = WB.beam_search(
            self.graph.neighbors[:, : 2 * self.M], aug, self._emb,
            self._has_emb, seeds, q_dev, qa, F=frontier, T=steps, k=k,
            rerank_k=rerank_k, hist=hist, inline_tabs=inline_tabs,
            res_mask=res_mask)
        return self._to_host(d_sq, slots, b_orig, k_orig)

    def search_batch_scan(
        self,
        queries: np.ndarray,
        k: int,
        mode: str = "bf16",
        filter_ids: Optional[Set[int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """A corpus scan over this index's device table, no graph
        traversal: batched scans read the table once for the whole batch,
        so at a large B a scan serves more queries than any traversal, from
        the same table. ``mode``: "bf16" (the ``l2_topk`` kernel over a bf16
        mirror, then an exact f32 rescore), "exact" (``l2_topk`` over the
        f32 table) or "blocksel" (``block_select_search``: bf16 block
        minima, then an exact rerank of the best blocks). ``filter_ids``
        folds into the validity mask. k is rounded up to a power of two
        (at least 8) and cut after the exact rescore, as in the JAX
        package, so the approximate modes rescore that many candidates.
        Same return contract as search_batch."""
        if mode not in ("bf16", "exact", "blocksel"):
            raise ValueError(f"Unknown scan mode: {mode}")
        queries = np.asarray(queries, np.float32)
        b_orig, k_orig = queries.shape[0], k
        if self.size == 0 or self._emb is None:
            return (np.full((b_orig, k), np.inf, np.float32),
                    np.full((b_orig, k), -1, np.int64))
        k = _up2(k, lo=8)
        q = torch.from_numpy(queries).to(self.device)
        valid = self._has_emb
        if filter_ids is not None:
            valid = valid & torch.from_numpy(
                self._store.filter_mask(filter_ids)).to(self.device)
        cap = self._capacity
        if mode == "bf16":
            emb16, x_sq = self._scan_mirror()
            _, slots = approx_search_tiled(q, emb16, valid, k,
                                           tile=min(cap, 125000), x_sq=x_sq)
            d_sq, slots = rescore_exact(q, self._emb, slots)
        elif mode == "blocksel":
            emb16, x_sq = self._scan_mirror()
            # any pow2 tile >= 128 works (the 128-row blocks need tile % 128 == 0)
            tile = min(131072, max(128, 1 << (cap - 1).bit_length()))
            d_sq, slots = block_select_search(
                q, emb16, q, x_sq, self._emb, valid, k, tile=tile,
                blocks_k=2 * k)
        else:
            d_sq, slots = exact_search_tiled(q, self._emb, valid, k,
                                             tile=min(cap, 32768))
        return self._to_host(d_sq, slots, b_orig, k_orig)

    def _scan_mirror(self):
        """(bf16 mirror, f32 row norms) of the table for search_batch_scan,
        rebuilt after a mutation (cached under ``_version``)."""
        if self._scan_sq is None or self._scan_sq[0] != self._version:
            self._scan_sq = (self._version, squared_norms(self._store.emb))
        return self._emb_bf16(), self._scan_sq[1]

    # ------------------------------------------------------------------
    def _pca_proj(self, dims: int) -> torch.Tensor:
        """PCA projection f32[dim, dims] of the live rows
        (:func:`pca_projection`)."""
        return pca_projection(self._store.emb, self._has_emb, dims)

    def enable_wide(self, dims: int | None = 120, seeds: int = 4096,
                    train_sample: int = 131072, seed: int = 0,
                    inline: bool = False) -> None:
        """Activate wide-beam search: the PCA projection of the augmented
        bf16 scoring mirror (``dims=None``: the full embedding, no
        projection) and the seed count (the highest-level graph nodes).
        The mirror rebuilds lazily after mutations. ``inline=True`` also
        builds the int8 inline neighbor tables
        (:func:`wide_beam.build_inline_tables`, capacity * 2M * dims bytes),
        which exact-score wide and beam traversal then read."""
        if self.graph is None or self.size == 0:
            raise ValueError("index must contain vectors before enable_wide")
        if dims is None or dims >= self._dim:
            self._wb_proj = None
        else:
            self._wb_proj = self._pca_proj(int(dims))
        self._wb_n_seeds = int(seeds)
        self._wb_inline = bool(inline)
        self._wb = self._wb_pq = None  # force mirror + seed rebuild

    def _wide_tables(self):
        """(aug mirror, seed slots), rebuilt after any mutation; the inline
        tables with them when enabled."""
        if self._wb is None or self._wb[0] != self._version:
            count("wide.mirror_builds")
            self._wb = None     # free the old tables before the new build
            aug = WB.build_aug_table(self._store.emb, self._has_emb,
                                     self._wb_proj)
            inline_tabs = (WB.build_inline_tables(
                self.graph.neighbors[:, : 2 * self.M], self._store.emb,
                self._has_emb, self._wb_proj)
                if self._wb_inline else None)
            levels = self._levels_host
            live = np.nonzero(levels >= 0)[0]
            order = live[np.argsort(-levels[live], kind="stable")]
            s = min(self._wb_n_seeds, order.size)
            seeds = np.full((max(s, 1),), -1, np.int32)
            seeds[:s] = order[:s]
            self._wb = (self._version, aug,
                        torch.from_numpy(seeds).to(self.device), inline_tabs)
        return self._wb[1], self._wb[2]

    def _wide_tables_pq(self):
        """(PQ-decoded aug mirror, seed slots): ADC traversal scores from
        the current codes, rebuilt after any mutation."""
        seeds = self._wide_tables()[1]
        if self._wb_pq is None or self._wb_pq[0] != self._version:
            count("wide.mirror_builds")
            self._wb_pq = (self._version, WB.build_aug_table_pq(
                self._pq_table(), self._pq.codebooks, self._pq.rotation,
                self._has_emb, self._wb_proj))
        return self._wb_pq[1], seeds

    def _wide_scoring(self, score: str):
        """(aug mirror, seeds, inline tables or None) for a wide or beam
        search scored by ``score``: "exact" (the aug mirror, or the inline
        tables when enabled) or "pq" (the PQ-decoded mirror)."""
        if score == "pq":
            aug, seeds = self._wide_tables_pq()
            return aug, seeds, None
        if score != "exact":
            raise ValueError(f"Unknown wide score: {score!r}")
        aug, seeds = self._wide_tables()
        return aug, seeds, self._wb[3]

    def search_batch_wide(
        self,
        queries: np.ndarray,
        k: int,
        ef: int = 256,
        frontier: int = 0,
        steps: int = 0,
        rerank_k: int = 0,
        bucket: bool = True,
        score: str = "exact",
        dedup_window: int = 16,
        seen_mask: bool = True,
        merge_kernel: bool = False,
        schedule=None,
        filter_ids=None,
        qchunk: int | None = None,
        early_exit: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Wide-beam search (requires enable_wide): (L2 dists f32[B, k],
        node ids int64[B, k]). ``merge_kernel`` merges the pool through the
        ``sorted_topk`` kernel. ``schedule`` = ((F1, T1), (F2, T2), ...)
        replaces the fixed frontier/steps. ``qchunk`` splits the batch on
        the host; None keeps max_frontier * padded batch within 2^20 (the
        JAX package's memory envelope; 2^18 with the inline tables), 0 never
        splits. ``score="pq"`` traverses on the PQ-decoded mirror (requires
        enable_pq). ``filter_ids``: non-matching nodes navigate but never
        enter results."""
        if not hasattr(self, "_wb_n_seeds"):
            raise ValueError("call enable_wide() first")
        if score == "pq" and self._pq is None:
            raise ValueError("score='pq' requires enable_pq()")
        queries = np.asarray(queries, np.float32)
        b_orig, k_orig = queries.shape[0], k
        if self.size == 0 or self.graph is None:
            return (np.full((b_orig, k), np.inf, np.float32),
                    np.full((b_orig, k), -1, np.int64))
        if qchunk is None:
            fmax = frontier or max(16, min(((ef // 6 + 31) // 32) * 32, ef))
            if schedule is not None:
                fmax = max(int(f) for f, _ in schedule)
            inline = self._wb_inline and score == "exact"
            budget = _INLINE_BUDGET if inline else 1 << 20
            qchunk = 0
            if fmax * _up2(b_orig) > budget:
                qchunk = max(128, budget // max(1, fmax))
                qchunk = 1 << (qchunk.bit_length() - 1)
        if qchunk > 0 and b_orig > qchunk:
            parts = [
                self.search_batch_wide(
                    queries[s:s + qchunk], k=k, ef=ef, frontier=frontier,
                    steps=steps, rerank_k=rerank_k, bucket=bucket,
                    score=score, dedup_window=dedup_window,
                    seen_mask=seen_mask, merge_kernel=merge_kernel,
                    schedule=schedule, filter_ids=filter_ids,
                    qchunk=0, early_exit=early_exit)
                for s in range(0, b_orig, qchunk)
            ]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        ef = max(ef, k)
        if bucket:
            # rounding ef sets the pool width P, so it changes results
            ef = _up2(ef, lo=64)
            k = min(_up2(k, lo=8), ef)
            b_pad = _up2(b_orig, lo=8) - b_orig
            if b_pad:
                queries = np.concatenate(
                    [queries, np.zeros((b_pad, queries.shape[1]), np.float32)])
        # auto frontier ~ ef/6 (32-aligned), 10 steps
        if not frontier:
            frontier = max(16, min(((ef // 6 + 31) // 32) * 32, ef))
        if not steps:
            steps = 10
        rerank_k = rerank_k or min(ef, max(4 * k, 64))
        nbr0 = self.graph.neighbors[:, : 2 * self.M]
        seg_fs = [f for f, _ in schedule] if schedule else [frontier]
        chunks = WB.score_chunks(queries.shape[0], seg_fs, nbr0.shape[1])
        with span("vdb.wide.prep", device=self.device, B=queries.shape[0],
                  P=ef, F=frontier, T=steps, R=min(max(rerank_k, k), ef),
                  score_chunks=chunks, seen_mask=seen_mask,
                  merge=("sorted_topk" if merge_kernel and ef <= WB.MAX_TOPK
                         else "plain")):
            aug, seeds, inline_tabs = self._wide_scoring(score)
            q_dev = torch.from_numpy(queries).to(self.device)
            qa = WB.aug_queries(q_dev, self._wb_proj, aug.shape[1])
            res_mask = (torch.from_numpy(
                self._store.filter_mask(filter_ids)).to(self.device)
                if filter_ids is not None else None)
        d_sq, slots = WB.wide_search(
            nbr0, aug, self._emb, self._has_emb, seeds, q_dev, qa,
            ef=ef, F=frontier, T=steps, k=k, rerank_k=rerank_k,
            dedup_window=dedup_window, seen_mask=seen_mask,
            inline_tabs=inline_tabs, score_chunks=chunks,
            merge_kernel=merge_kernel,
            schedule=(tuple(tuple(map(int, s)) for s in schedule)
                      if schedule else None),
            res_mask=res_mask, early_exit=early_exit)
        return self._to_host(d_sq, slots, b_orig, k_orig)

    def _to_host(self, d_sq, slots, b: int, k: int):
        """(L2 dists f32[b, k], ids int64[b, k]), (inf, -1) padded."""
        with span("vdb.to_host"):
            d_sq = d_sq.cpu().numpy()[:b, :k]
            slots = slots.cpu().numpy()[:b, :k]
            ids = np.where(slots >= 0,
                           self._id_of_slot[np.maximum(slots, 0)], -1)
            dists = np.where(slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)),
                             np.inf)
            return dists.astype(np.float32), ids

    def _emb_traverse(self) -> torch.Tensor:
        """Table for beam traversal: the f32 source, or the bf16 mirror."""
        return self._emb if self.precision != "bf16" else self._emb_bf16()

    def _emb_bf16(self) -> torch.Tensor:
        """bf16 mirror of the table, rebuilt after mutations."""
        if self._emb16 is None or self._emb16[0] != self._version:
            self._emb16 = (self._version, self._store.emb.to(torch.bfloat16))
        return self._emb16[1]

    def sync_storage(self) -> None:
        """Mask out graph nodes that no longer exist in storage (nodes
        deleted from storage behind the index's back are skipped at query
        time)."""
        if self.graph is None:
            return
        live = np.asarray(self.storage.get_all_ids(), np.int64)
        ids_arr = np.asarray(self._id_of_slot, np.int64)
        has = (ids_arr >= 0) & np.isin(ids_arr, live)
        self._store.valid = torch.from_numpy(has).to(self.device)
        self._version += 1

    # ------------------------------------------------------------------
    def search(self, query: np.ndarray, k: int, **kwargs
               ) -> List[Tuple[Node, float]]:
        """[(Node, L2)] ascending. kwargs: ef (default 50), filter_ids (a
        set of node ids); unknown kwargs are ignored."""
        ef = int(kwargs.get("ef", 50) or 50)
        dists, ids = self.search_batch(
            np.asarray(query, np.float32)[None, :], k, ef=ef,
            filter_ids=kwargs.get("filter_ids"))
        out: List[Tuple[Node, float]] = []
        for nid, d in zip(ids[0], dists[0]):
            if nid < 0:
                continue
            node = self.storage.get(int(nid))
            if node is not None:
                out.append((node, float(d)))
        return out

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        ef: int = 50,
        filter_ids: Optional[Set[int]] = None,
        pool: int = 0,
        max_steps: int = 0,
        expand: int = 1,
        bucket: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Classic best-first search: (L2 dists f32[B, k], node ids
        int64[B, k]); missing results padded with (inf, -1). ``bucket``
        rounds ef and k up to powers of two (a larger ef can only raise
        recall) and B up to a power of two; the survivors are re-scored
        exactly from the f32 table."""
        queries = np.asarray(queries, np.float32)
        b_orig, k_orig = queries.shape[0], k
        if self.size == 0 or self.graph is None:
            return (np.full((b_orig, k), np.inf, np.float32),
                    np.full((b_orig, k), -1, np.int64))
        ef = max(ef, k)
        if bucket:
            ef = _up2(ef, lo=16)
            k = min(_up2(k, lo=8), ef)
            b_pad = _up2(b_orig, lo=8) - b_orig
            if b_pad:
                queries = np.concatenate(
                    [queries, np.zeros((b_pad, queries.shape[1]), np.float32)])
        use_filter = filter_ids is not None
        filter_mask = (torch.from_numpy(self._store.filter_mask(filter_ids)).to(
            self.device) if use_filter else None)
        max_steps = max_steps or self.max_steps or (2 * ef + 16)
        q_dev = torch.from_numpy(queries).to(self.device)
        d_sq, slots = K.search_batch(
            self.graph, self._emb_traverse(), self._has_emb, q_dev,
            filter_mask, M=self.M, l_max=self.l_max, ef=ef, k=k,
            max_steps=max_steps, use_filter=use_filter, pool=max(pool, ef),
            expand=expand)
        # traversal scores only select; reported order and distances come
        # from the f32 table
        d_sq, slots = rescore_exact(q_dev, self._emb, slots)
        return self._to_host(d_sq, slots, b_orig, k_orig)

    # ------------------------------------------------------------------
    @property
    def entry_node_id(self) -> Optional[int]:
        if self.graph is None:
            return None
        e = self.graph.entry
        return int(self._id_of_slot[e]) if e >= 0 else None

    @property
    def max_level(self) -> int:
        return self.graph.entry_level if self.graph is not None else -1

    def neighbors_of(self, node_id: int, level: int) -> List[int]:
        """The node's neighbor ids at ``level``."""
        slot = self._slot_of_id.get(node_id)
        if slot is None or self.graph is None:
            return []
        start = K.level_col_start(level, self.M)
        width = K.level_width(level, self.M)
        row = self.graph.neighbors[slot, start:start + width].cpu().numpy()
        return [int(self._id_of_slot[s]) for s in row if s >= 0]

    # ------------------------------------------------------------------
    def snapshot_for_save(self) -> Optional[dict]:
        """A point-in-time copy of the index on the host, for a save now
        or later (``write_snapshot``); None without an index file or a
        graph. The adjacency is split: the level-0 block of every row, and
        the upper block only of the rows with a level >= 1 (~1/M of them),
        ~3x fewer bytes than the dense table. Levels come from the host
        mirror. Trained state goes with it: the wide beam's projection and
        seed count, the RP projection and the PQ codebooks (and OPQ
        rotation); codes and mirrors are rebuilt from the table at load."""
        if self.index_file is None or self.graph is None:
            return None
        levels = self._levels_host.copy()
        upper = np.flatnonzero(levels >= 1).astype(np.int32)
        m2 = 2 * self.M
        nb = self.graph.neighbors
        snap = {
            "neighbors0": nb[:, :m2].cpu().numpy(),
            "neighbors_up": nb[torch.from_numpy(upper).to(nb.device).long(),
                               m2:].cpu().numpy(),
            "upper_slots": upper,
            "levels": levels,
            "entry": np.asarray(self.graph.entry, np.int32),
            "entry_level": np.asarray(self.graph.entry_level, np.int32),
            "id_of_slot": self._id_of_slot.copy(),
            "M": self.M,
            "ef_construction": self.ef_construction,
            "l_max": self.l_max,
        }
        if getattr(self, "_wb_proj", None) is not None:
            snap["wb_proj"] = self._wb_proj.cpu().numpy()
        if hasattr(self, "_wb_n_seeds"):
            snap["wb_n_seeds"] = np.asarray(self._wb_n_seeds)
        if self._rp_proj is not None:
            snap["rp_proj"] = self._rp_proj.cpu().numpy()
        if self._pq is not None and self._pq.codebooks is not None:
            snap["pq_codebooks"] = self._pq.codebooks.cpu().numpy()
            if self._pq.rotation is not None:
                snap["pq_rotation"] = self._pq.rotation.cpu().numpy()
        return snap

    def write_snapshot(self, snap: dict) -> None:
        """Write a ``snapshot_for_save`` to the index file, uncompressed,
        through a temporary file and ``os.replace``: a crash mid-write
        leaves the previous file whole."""
        self.index_file.parent.mkdir(parents=True, exist_ok=True)
        arrays = {k: (np.asarray(v, np.float32) if k in _AUX_KEYS else v)
                  for k, v in snap.items()}
        tmp = self.index_file.with_name(self.index_file.name + ".tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, self.index_file)

    def save_index(self) -> None:
        """Persist the graph, the id map and the hyperparameters (not the
        embeddings: they live in storage)."""
        snap = self.snapshot_for_save()
        if snap is not None:
            self.write_snapshot(snap)

    def load_index(self) -> None:
        """Load the index file (split or legacy dense ``neighbors``),
        hydrate the device table from storage in one ``get_embeddings``
        read (ids storage lacks stay invalid: skipped at query time), then
        re-link what storage holds and the graph does not
        (``recover_unlinked``)."""
        if self.index_file is None or not self.index_file.exists():
            return
        with np.load(self.index_file) as z:
            self.M = int(z["M"])
            self.M_max = self.M
            self.M_max0 = self.M * 2
            self.ef_construction = int(z["ef_construction"])
            self.l_max = int(z["l_max"])
            self.level_mult = 1.0 / math.log(self.M) if self.M > 1 else 1.0
            if "neighbors" in z:    # dense legacy files
                neighbors = np.asarray(z["neighbors"], np.int32)
            else:
                nbr0 = np.asarray(z["neighbors0"])
                upper = np.asarray(z["upper_slots"])
                neighbors = np.full(
                    (nbr0.shape[0], K.ncols(self.M, self.l_max)), -1,
                    np.int32)
                neighbors[:, :2 * self.M] = nbr0
                if upper.size:
                    neighbors[upper, 2 * self.M:] = z["neighbors_up"]
            levels = np.asarray(z["levels"], np.int32)
            entry, entry_level = int(z["entry"]), int(z["entry_level"])
            id_of_slot = np.asarray(z["id_of_slot"], np.int64)
            aux = {k: np.asarray(z[k]) for k in ("wb_n_seeds",) + _AUX_KEYS
                   if k in z}

        dev = self.device
        self.graph = K.Graph(neighbors=torch.from_numpy(neighbors).to(dev),
                             levels=torch.from_numpy(levels).to(dev),
                             entry=entry, entry_level=entry_level)
        self._levels_host = levels.copy()
        self._store = DeviceVectorStore(capacity=neighbors.shape[0],
                                        on_grow=self._grow_graph, device=dev)
        self._store.import_id_map(id_of_slot)
        if self._slot_of_id:
            ids = np.fromiter(self._slot_of_id.keys(), np.int64,
                              count=len(self._slot_of_id))
            slots = np.fromiter(self._slot_of_id.values(), np.int64,
                                count=len(self._slot_of_id))
            rows, found = self.storage.get_embeddings(ids)
            if found.any():
                self._store.ensure_dim(rows.shape[1])
                self._store.write(slots[found], rows[found])
        self._version += 1
        if "wb_proj" in aux or "wb_n_seeds" in aux:
            self._wb_proj = (torch.from_numpy(aux["wb_proj"]).to(dev)
                             if "wb_proj" in aux else None)
            self._wb_n_seeds = int(aux.get("wb_n_seeds", 4096))
            self._wb = self._wb_pq = None
        # trained state without retraining: mirrors and codes rebuild from
        # the hydrated table on first use
        if "rp_proj" in aux:
            self._rp_proj = torch.from_numpy(
                aux["rp_proj"].astype(np.float32)).to(dev)
            self._rp = None
        if "pq_codebooks" in aux and self._dim is not None:
            self._pq = PQCodec.from_arrays(aux["pq_codebooks"],
                                           aux.get("pq_rotation"), device=dev)
            self._pq_codes = None
        self.recover_unlinked()

    def recover_unlinked(self) -> int:
        """Crash repair: insert every id storage holds and the graph does
        not (``insert_nodes`` writes storage first, so a crash before the
        commit, or an insert after the last save, leaves such rows).
        Idempotent. Returns the number re-linked."""
        if self.graph is None:
            return 0
        live = np.asarray(self.storage.get_all_ids(), np.int64)
        missing = [int(i) for i in live if int(i) not in self._slot_of_id]
        if not missing:
            return 0
        rows, found = self.storage.get_embeddings(
            np.asarray(missing, np.int64))
        ids = [m for m, f in zip(missing, found) if f]
        if ids:
            self.insert_arrays(ids, rows[found])
        return len(ids)
