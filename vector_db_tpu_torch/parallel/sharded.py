"""Sharded indexes: per-shard search on each shard's device and one
top-k merge of the winners (port of vector_db_tpu/parallel/sharded.py).

Replaces the reference's scale-out story (docker-compose full-copy
``replicas``, README.md:123-126) with true sharding over a device mesh
(``parallel.mesh``):

- the corpus splits row-wise across the mesh's devices — each shard owns
  ``cap`` embedding rows (plus, for HNSW, its own fixed-degree neighbor
  tables over those rows), as tensors on its own device;
- queries are replicated (one copy per distinct device); every shard
  answers its local top-k; the per-shard (distance, global slot) pairs
  merge on the first device with one stable top-k per mesh axis, innermost
  first — the only cross-device traffic is B×k pairs a shard;
- streaming inserts route round-robin to shards on the host, and each shard
  runs the construction search and the edge commit on its own sub-batch.

Global addressing: a result's global slot is ``shard * cap + local_slot``
(the shard's linear index over the mesh axes); the host maps global slots
back to user node ids. Routing, level draws and persistence are the JAX
package's: the same ``random.Random(seed)`` levels in the same order, the
same shards and slots, and one npz format, so either package loads the
other's file.

JAX runs one ``shard_map`` program over the mesh; here one process issues
each shard's work to its device in turn. Kernel launches queue without a
host wait, so shards on different cards overlap where a building block does
not wait on its device inside its loop: the classic beam and the
construction search check their loop condition on the host every step, so
their shards run one after another.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vector_db_tpu_torch.device import require_f32_matmul
from vector_db_tpu_torch.index import hnsw_kernels as K
from vector_db_tpu_torch.index import wide_beam as WB
from vector_db_tpu_torch.index.ivf import _ivf_search_batch
from vector_db_tpu_torch.ops.distance import BIG
from vector_db_tpu_torch.ops.exact import exact_search
from vector_db_tpu_torch.ops.graph_build import (
    build_forward_edges,
    reverse_merge,
)
from vector_db_tpu_torch.ops.kmeans import assign_tiled, kmeans
from vector_db_tpu_torch.ops.topk import stable_top_k_smallest
from vector_db_tpu_torch.parallel.mesh import Mesh, make_mesh


# ======================================================================
# merge and addressing
# ======================================================================

def _merge_gathered(local_d: List[torch.Tensor],
                    local_gslots: List[torch.Tensor], k: int, mesh: Mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical gather + top-k merge of per-shard [B, k] (d_sq, global
    slot) pairs, innermost mesh axis first, on the first device of each
    group; the result lands on the mesh's first device.

    For a 1-D ("shard",) mesh this is one gather + top-k. For a 2-D
    ("slice", "shard") mesh each slice first merges its shards, and only
    the per-slice winners — B·k pairs a slice — cross the slice axis. Each
    merge is a stable selection over the shards' lists concatenated in
    shard order, so ties break as ``lax.top_k`` over JAX's
    ``all_gather`` does (the lower shard, then the lower position)."""
    d, s = list(local_d), list(local_gslots)
    for size in reversed(mesh.axis_sizes):
        merged_d, merged_s = [], []
        for g in range(0, len(d), size):
            dev = d[g].device
            cd = torch.cat([x.to(dev) for x in d[g:g + size]], 1)
            cs = torch.cat([x.to(dev) for x in s[g:g + size]], 1)
            if cd.shape[1] < k:
                pad = k - cd.shape[1]
                cd = torch.cat([cd, cd.new_full((cd.shape[0], pad), BIG)], 1)
                cs = torch.cat([cs, cs.new_full((cs.shape[0], pad), -1)], 1)
            md, ms = stable_top_k_smallest(cd, cs, k)
            merged_d.append(md)
            merged_s.append(ms)
        d, s = merged_d, merged_s
    return d[0], s[0]


def _globalize(slots: torch.Tensor, shard: int, cap: int) -> torch.Tensor:
    """Local slot -> global slot: linear shard index (row-major over the
    mesh axes) × cap + slot."""
    return torch.where(slots >= 0, slots + shard * cap, -1)


class _Shards:
    """Host-side state every sharded index shares: the mesh, the id <->
    global-slot maps and the round-robin router."""

    def _init_shards(self, mesh: Optional[Mesh], capacity_per_shard: int
                     ) -> None:
        self.mesh = mesh or make_mesh()
        self._axes = self.mesh.axis_names
        self._axis_sizes = self.mesh.axis_sizes
        self._devices = self.mesh.devices
        self.n_shards = self.mesh.size
        self.cap = int(capacity_per_shard)
        total = self.n_shards * self.cap
        self._id_of_gslot = np.full((total,), -1, np.int64)
        self._gslot_of_id: Dict[int, int] = {}
        self._next_in_shard = [0] * self.n_shards
        self._rr = 0  # round-robin cursor

    @property
    def size(self) -> int:
        return len(self._gslot_of_id)

    def _route(self, node_id: int) -> int:
        """The next shard round-robin (or any shard with room); returns
        the node's global slot."""
        shard = self._rr % self.n_shards
        self._rr += 1
        if self._next_in_shard[shard] >= self.cap:
            # find any shard with room
            for s in range(self.n_shards):
                if self._next_in_shard[s] < self.cap:
                    shard = s
                    break
            else:
                raise RuntimeError("Sharded index full")
        slot = self._next_in_shard[shard]
        self._next_in_shard[shard] += 1
        g = shard * self.cap + slot
        self._gslot_of_id[node_id] = g
        self._id_of_gslot[g] = node_id
        return g

    def _replicate(self, x: np.ndarray) -> List[torch.Tensor]:
        """``x`` as an f32 tensor on each shard's device (one copy per
        distinct device)."""
        host = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        copies: Dict[torch.device, torch.Tensor] = {}
        for dev in self._devices:
            if dev not in copies:
                copies[dev] = host.to(dev)
        return [copies[dev] for dev in self._devices]

    def _shard_masks(self, filter_ids) -> List[torch.Tensor]:
        """bool[cap] mask per shard, on its device, from a set of ids."""
        mask = np.zeros((self.n_shards * self.cap,), bool)
        for nid in filter_ids:
            g = self._gslot_of_id.get(int(nid))
            if g is not None:
                mask[g] = True
        return [torch.from_numpy(mask[s * self.cap:(s + 1) * self.cap]).to(
            dev) for s, dev in enumerate(self._devices)]

    def _merge(self, parts, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-shard (d_sq, local slots) -> merged host (L2 dists f32[B, k],
        node ids int64[B, k]), (inf, -1) padded."""
        d_sq, gslots = _merge_gathered(
            [p[0] for p in parts],
            [_globalize(p[1], s, self.cap) for s, p in enumerate(parts)],
            k, self.mesh)
        d_sq, gslots = d_sq.cpu().numpy(), gslots.cpu().numpy()
        ids = np.where(
            gslots >= 0, self._id_of_gslot[np.maximum(gslots, 0)], -1
        )
        dists = np.where(gslots >= 0, np.sqrt(np.maximum(d_sq, 0)), np.inf)
        return dists.astype(np.float32), ids


# ======================================================================
# sharded exact search
# ======================================================================

class ShardedFlatIndex(_Shards):
    """Row-sharded exact search: the f32 scan per shard (``exact_search``,
    the ``l2_topk`` kernel on the card), then the merge. The recall ground
    truth at any scale."""

    def __init__(self, mesh: Optional[Mesh] = None, dim: int = 384,
                 capacity_per_shard: int = 4096) -> None:
        # row-sharding over EVERY mesh axis: a 1-D ("shard",) mesh splits
        # over devices; a 2-D ("slice", "shard") mesh over slices too, and
        # merges run per axis (see _merge_gathered)
        self._init_shards(mesh, capacity_per_shard)
        self.dim = int(dim)
        self._emb = [torch.zeros((self.cap, self.dim), dtype=torch.float32,
                                 device=dev) for dev in self._devices]
        self._valid = [torch.zeros((self.cap,), dtype=torch.bool, device=dev)
                       for dev in self._devices]

    def insert(self, ids: Sequence[int], embeddings: np.ndarray) -> None:
        embeddings = np.asarray(embeddings, np.float32)
        # look up per element as routing proceeds so a duplicate id within
        # one batch reuses the slot allocated for its first occurrence
        gslots = np.empty((len(ids),), np.int64)
        for j, nid in enumerate(ids):
            g = self._gslot_of_id.get(int(nid), -1)
            gslots[j] = g if g >= 0 else self._route(int(nid))
        shard_of, slots = np.divmod(gslots, self.cap)
        for s, dev in enumerate(self._devices):
            mine = np.nonzero(shard_of == s)[0]
            if mine.size == 0:
                continue
            idx = torch.from_numpy(slots[mine]).to(dev)
            self._emb[s][idx] = torch.from_numpy(embeddings[mine]).to(dev)
            self._valid[s][idx] = True

    def delete(self, node_id: int) -> None:
        g = self._gslot_of_id.pop(node_id, None)
        if g is None:
            return
        self._valid[g // self.cap][g % self.cap] = False
        self._id_of_gslot[g] = -1

    def search_batch(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        q = self._replicate(queries)
        kk = min(k, self.cap)
        return self._merge([
            exact_search(q[s], self._emb[s], self._valid[s], kk)
            for s in range(self.n_shards)], k)


# ======================================================================
# sharded IVF
# ======================================================================

class ShardedIVF(ShardedFlatIndex):
    """Row-sharded IVF: replicated coarse centroids, per-shard padded
    inverted lists over local rows, a per-shard probe and the merge.

    Scale-out for the reference's library-only IVF (reference
    src/vector_db/indexing/ivf.py:13-241): k-means trains once on a sample,
    every shard keeps inverted lists over the rows it owns (local slot ids,
    -1 padded), and every shard probes the same ``n_probe`` cells — the only
    cross-device traffic is the B×k winners. Deletes inherit the flat
    index's valid-mask semantics (a dead slot is masked in the scan, no
    list edit).
    """

    def __init__(self, mesh: Optional[Mesh] = None, dim: int = 384,
                 capacity_per_shard: int = 4096, k_cells: int = 16,
                 max_list: Optional[int] = None) -> None:
        super().__init__(mesh=mesh, dim=dim,
                         capacity_per_shard=capacity_per_shard)
        self.k_cells = int(k_cells)
        self.max_list = int(max_list or max(
            8, 2 * capacity_per_shard // k_cells))
        self._centroids: Optional[List[torch.Tensor]] = None
        self._lists: Optional[List[torch.Tensor]] = None

    def build(self, ids: Sequence[int], embeddings: np.ndarray,
              seed: int = 0) -> None:
        """Insert rows, train the coarse quantizer on the first 65,536 rows
        (k-means on the first device), build per-shard lists. A row whose
        shard-cell list already holds ``max_list`` rows is left out of the
        lists, as in the JAX package; ``cell_fill`` int32[shards, k_cells]
        keeps how many rows each shard-cell was given, dropped ones
        included."""
        self.insert(ids, embeddings)
        x = np.asarray(embeddings, np.float32)
        sample = torch.from_numpy(x[: min(len(x), 65536)]).to(
            self._devices[0])
        cents, _ = kmeans(sample, self.k_cells,
                          torch.Generator().manual_seed(seed), iters=25)
        labels = assign_tiled(torch.from_numpy(x), cents)[:, 0].cpu().numpy()
        lists_np = np.full(
            (self.n_shards, self.k_cells, self.max_list), -1, np.int32)
        fill = np.zeros((self.n_shards, self.k_cells), np.int32)
        for j, nid in enumerate(ids):
            g = self._gslot_of_id[int(nid)]
            s, slot = divmod(g, self.cap)
            c = int(labels[j])
            if fill[s, c] < self.max_list:
                lists_np[s, c, fill[s, c]] = slot
            fill[s, c] += 1
        self.cell_fill = fill
        self._centroids = [cents.to(dev) for dev in self._devices]
        self._lists = [torch.from_numpy(lists_np[s]).to(dev)
                       for s, dev in enumerate(self._devices)]

    def search_batch(
        self, queries: np.ndarray, k: int, n_probe: int = 4
    ) -> Tuple[np.ndarray, np.ndarray]:
        assert self._centroids is not None, "build() first"
        q = self._replicate(queries)
        n_probe = min(n_probe, self.k_cells)
        return self._merge([
            _ivf_search_batch(self._centroids[s], self._lists[s],
                              self._emb[s], self._valid[s], q[s], None,
                              n_probe, k)
            for s in range(self.n_shards)], k)


# ======================================================================
# sharded HNSW
# ======================================================================

class ShardedHNSW(_Shards):
    """Per-shard HNSW graphs, one per device of the mesh.

    Each shard owns an independent graph over its local rows (the standard
    sharded-ANN architecture); queries fan out to all shards and merge by
    distance, so recall matches a single graph of the union at equal ef.
    """

    def __init__(
        self,
        M: int = 16,
        ef_construction: int = 100,
        mesh: Optional[Mesh] = None,
        dim: int = 384,
        capacity_per_shard: int = 4096,
        l_max: int = 5,
        seed: int = 42,
    ) -> None:
        self._init_shards(mesh, capacity_per_shard)
        self.M = int(M)
        self.efc = int(ef_construction)
        self.l_max = int(l_max)
        self.dim = int(dim)
        self.rng = random.Random(seed)
        self.level_mult = 1.0 / math.log(self.M) if self.M > 1 else 1.0
        self._graphs = [K.empty_graph(self.cap, self.M, self.l_max, dev)
                        for dev in self._devices]
        self._emb = [torch.zeros((self.cap, self.dim), dtype=torch.float32,
                                 device=dev) for dev in self._devices]
        self._has_emb = [torch.zeros((self.cap,), dtype=torch.bool,
                                     device=dev) for dev in self._devices]
        self._version = 0   # bumped by every table mutation
        self._wb = None     # (version, per-shard (aug, seeds, proj))

    # -- host-side routing ------------------------------------------------
    def sample_level(self) -> int:
        lvl = int(-math.log(self.rng.random()) * self.level_mult)
        return min(lvl, self.l_max - 1)

    # -- wide-beam (frontier-parallel search) over the mesh -----------------
    def enable_wide(self, dims: Optional[int] = None,
                    seeds: int = 512) -> None:
        """Activate sharded wide-beam search. A SHARED PCA projection is
        trained from the mesh-wide covariance (per-shard partial
        covariances summed on the first device — [dim, dim] crosses to
        the host once, never the rows); per-shard augmented mirrors and
        seed sets stay on their devices. ``dims=None`` scores from the
        full-dim bf16 mirror."""
        if dims is not None and dims < self.dim:
            dev0 = self._devices[0]
            cov = torch.zeros((self.dim, self.dim), dtype=torch.float32,
                              device=dev0)
            n = torch.zeros((), dtype=torch.float32, device=dev0)
            for emb, has in zip(self._emb, self._has_emb):
                require_f32_matmul(emb)
                e = torch.where(has[:, None], emb, 0.0)
                cov += (e.T @ e).to(dev0)
                n += has.sum().float().to(dev0)
            cov = cov.cpu().numpy() / max(1.0, float(n))
            _, v = np.linalg.eigh(cov.astype(np.float64))
            self._wb_proj = torch.from_numpy(
                np.ascontiguousarray(v[:, ::-1][:, : int(dims)],
                                     dtype=np.float32))
        else:
            self._wb_proj = None
        self._wb_seeds = int(seeds)
        self._wb = None

    def _wide_aug(self):
        """Per shard (aug mirror, seed slots, projection on its device),
        rebuilt after a mutation. A shard's seeds are its highest-level
        nodes, ties to the lower slot (``lax.top_k`` of the levels)."""
        if self._wb is None or self._wb[0] != self._version:
            self._wb = None     # free the old tables before the new build
            n_seeds = min(self._wb_seeds, self.cap)
            tabs = []
            for g, emb, has in zip(self._graphs, self._emb, self._has_emb):
                proj = (None if self._wb_proj is None
                        else self._wb_proj.to(emb.device))
                lv, idx = torch.sort(g.levels, descending=True, stable=True)
                seeds = torch.where(lv[:n_seeds] >= 0,
                                    idx[:n_seeds].int(), -1)
                tabs.append((WB.build_aug_table(emb, has, proj), seeds, proj))
            self._wb = (self._version, tabs)
        return self._wb[1]

    def _fan_out(self, queries: np.ndarray, filter_ids, search):
        """``search(shard, graph, emb, has_emb, q, aug, seeds, qa,
        res_mask)`` on every shard over its wide tables."""
        if not hasattr(self, "_wb_seeds"):
            raise ValueError("call enable_wide() first")
        tabs = self._wide_aug()
        q = self._replicate(queries)
        masks = (self._shard_masks(filter_ids) if filter_ids is not None
                 else [None] * self.n_shards)
        out = []
        for s, (aug, seeds, proj) in enumerate(tabs):
            qa = WB.aug_queries(q[s], proj, aug.shape[1])
            out.append(search(self._graphs[s].neighbors[:, : 2 * self.M],
                              aug, self._emb[s], self._has_emb[s], seeds,
                              q[s], qa, masks[s]))
        return out

    def search_batch_wide(
        self, queries: np.ndarray, k: int, ef: int = 256,
        frontier: int = 32, steps: int = 12, rerank_k: int = 0,
        merge_kernel: bool = False, filter_ids=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Wide-beam fan-out: every shard runs the frontier-parallel
        search, results merge hierarchically. Requires enable_wide().
        ``merge_kernel`` merges each shard's pool through the
        ``sorted_topk`` kernel. ``filter_ids`` applies the two-pool
        filtered wide path per shard (navigate-but-exclude)."""
        rerank_k = rerank_k or min(ef, max(4 * k, 64))
        chunks = WB.score_chunks(len(queries), [frontier], 2 * self.M)

        def search(nbr0, aug, emb, has, seeds, q, qa, res_mask):
            return WB.wide_search(
                nbr0, aug, emb, has, seeds, q, qa, ef=max(ef, k),
                F=frontier, T=steps, k=k, rerank_k=rerank_k,
                score_chunks=chunks, merge_kernel=merge_kernel,
                res_mask=res_mask)

        return self._merge(self._fan_out(queries, filter_ids, search), k)

    def search_batch_beam(
        self, queries: np.ndarray, k: int, frontier: int = 64,
        steps: int = 12, rerank_k: int = 0, hist: int = 2,
        filter_ids=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pool-free beam fan-out (see wide_beam.beam_search): every shard
        runs the merge-light traversal, results merge hierarchically.
        Requires enable_wide(). ``filter_ids`` masks each shard's emitted
        trajectory (navigate-but-exclude)."""
        rerank_k = rerank_k or max(4 * k, 64)

        def search(nbr0, aug, emb, has, seeds, q, qa, res_mask):
            return WB.beam_search(
                nbr0, aug, emb, has, seeds, q, qa, F=frontier, T=steps,
                k=k, rerank_k=rerank_k, hist=hist, res_mask=res_mask)

        return self._merge(self._fan_out(queries, filter_ids, search), k)

    def bulk_build(self, ids: Sequence[int], embeddings: np.ndarray) -> None:
        """Bulk construction (the initial-load path): rows route
        round-robin to shards; every shard builds exact-kNN +
        occlusion-pruned + reverse-merged level graphs over its local rows
        (``build_forward_edges``: ``knn_exact`` on ``l2_topk``). Local
        slots are assigned level-descending, so each level's nodes occupy
        a prefix, and a level's kNN pass runs over the prefix whose length
        the JAX package picks (the largest count of any shard, rounded up
        to a power of two, at most ``cap``), with its degree and candidate
        count. Single-device semantics per shard (HNSW.bulk_build); search
        merges across shards as usual."""
        if self.size > 0:
            raise ValueError("bulk_build requires an empty index")
        embeddings = np.asarray(embeddings, np.float32)
        seen: Dict[int, None] = {}
        keep = []
        for j, nid in enumerate(ids):
            if int(nid) not in seen:
                seen[int(nid)] = None
                keep.append(j)
        idx = np.asarray(keep, np.int64)
        ids_arr = np.asarray([int(ids[j]) for j in keep], np.int64)
        embeddings = embeddings[idx]
        n = embeddings.shape[0]
        if n == 0:
            return
        if n > self.n_shards * self.cap:
            raise RuntimeError("Sharded index full")
        if self.dim != embeddings.shape[1]:
            raise ValueError(
                f"dim {embeddings.shape[1]} != index dim {self.dim}"
            )

        levels = np.asarray(
            [self.sample_level() for _ in range(n)], np.int32
        )
        shard_of = np.arange(n) % self.n_shards
        local = []
        for s in range(self.n_shards):
            mine = np.nonzero(shard_of == s)[0]
            # level-descending local slot order => per-level prefixes
            mine = mine[np.argsort(-levels[mine], kind="stable")]
            local.append(mine)
            self._next_in_shard[s] = int(mine.size)
            g = s * self.cap + np.arange(mine.size)
            self._id_of_gslot[g] = ids_arr[mine]
            self._gslot_of_id.update(zip(ids_arr[mine].tolist(), g.tolist()))
        self._rr = int(n)

        # per-level prefix sizes: max live count over shards, rounded up
        # to powers of two
        level_sizes = []
        for level in range(self.l_max):
            c = max(int((levels[mine] >= level).sum()) for mine in local)
            level_sizes.append(0 if c < 2 else min(
                self.cap, 1 << (max(c, 2) - 1).bit_length()))

        for s, (mine, dev) in enumerate(zip(local, self._devices)):
            m = mine.size
            emb = torch.zeros((self.cap, self.dim), dtype=torch.float32,
                              device=dev)
            emb[:m] = torch.from_numpy(embeddings[mine]).to(dev)
            has = torch.zeros((self.cap,), dtype=torch.bool, device=dev)
            has[:m] = True
            lv = torch.full((self.cap,), -1, dtype=torch.int32, device=dev)
            lv[:m] = torch.from_numpy(levels[mine]).to(dev)
            nb = torch.full((self.cap, K.ncols(self.M, self.l_max)), -1,
                            dtype=torch.int32, device=dev)
            for level, p in enumerate(level_sizes):
                if p < 2:
                    continue
                width = K.level_width(level, self.M)
                # query chunk: the [chunk, p] distances of the plain scan
                # stay ~512 MB (the result does not depend on it)
                chunk = min(2048, max(128, (1 << 27) // p))
                fd, fi = build_forward_edges(
                    emb[:p], has[:p] & (lv[:p] >= level),
                    deg=min(self.M, p - 1, width),
                    k_cand=min(4 * self.M, p - 1),
                    chunk=1 << (chunk.bit_length() - 1), alpha=1.0)
                start = K.level_col_start(level, self.M)
                nb[:p, start:start + width] = reverse_merge(fd, fi, width)
            # local slot 0 holds the shard's highest-level node
            self._graphs[s] = K.Graph(
                neighbors=nb, levels=lv, entry=0 if m else -1,
                entry_level=int(levels[mine[0]]) if m else -1)
            self._emb[s], self._has_emb[s] = emb, has
        self._version += 1

    # -- public API ---------------------------------------------------------
    def insert(self, ids: Sequence[int], embeddings: np.ndarray) -> None:
        """Streaming insert: rows route round-robin to shards; each shard
        runs the construction search (``construction_search``, the batched
        beam of the JAX package's insert) and the grouped edge commit (the
        same graph as JAX's item-at-a-time commit up to the order within a
        row) on its sub-batch. Levels are drawn shard by shard, in the JAX
        package's order."""
        embeddings = np.asarray(embeddings, np.float32)
        per_shard_items: List[List[Tuple[int, int]]] = [
            [] for _ in range(self.n_shards)
        ]
        for j, nid in enumerate(ids):
            if int(nid) in self._gslot_of_id:
                continue
            shard, slot = divmod(self._route(int(nid)), self.cap)
            per_shard_items[shard].append((j, slot))
        levels = [[self.sample_level() for _ in items]
                  for items in per_shard_items]
        for s, items in enumerate(per_shard_items):
            if not items:
                continue
            dev = self._devices[s]
            rows = torch.from_numpy(
                embeddings[[j for j, _ in items]]).to(dev)
            slots = torch.tensor([slot for _, slot in items],
                                 dtype=torch.int32, device=dev)
            self._emb[s][slots.long()] = rows
            self._has_emb[s][slots.long()] = True
            K.insert_step(
                self._graphs[s], self._emb[s], self._has_emb[s], rows, slots,
                torch.tensor(levels[s], dtype=torch.int32, device=dev),
                M=self.M, l_max=self.l_max, ef_construction=self.efc,
                max_steps=2 * self.efc + 16, commit="grouped")
        self._version += 1

    def search_batch(
        self, queries: np.ndarray, k: int, ef: int = 50, filter_ids=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """filter_ids semantics match the single-device index: non-matching
        nodes navigate but never enter results (per-shard masks)."""
        use_filter = filter_ids is not None
        masks = (self._shard_masks(filter_ids) if use_filter
                 else [None] * self.n_shards)
        q = self._replicate(queries)
        ef = max(ef, k)
        return self._merge([
            K.search_batch(self._graphs[s], self._emb[s], self._has_emb[s],
                           q[s], masks[s], M=self.M, l_max=self.l_max, ef=ef,
                           k=k, max_steps=2 * ef + 16, use_filter=use_filter)
            for s in range(self.n_shards)], k)

    def delete_batch(self, node_ids: Sequence[int]) -> None:
        """Delete a batch of nodes across shards with full edge unlink
        (single-device ``delete_slot`` parity per shard: one gather pass
        clears every reference to any deleted slot, own rows/levels reset,
        entry re-elected to the highest-level survivor, the first such
        slot)."""
        per_shard: List[List[int]] = [[] for _ in range(self.n_shards)]
        for nid in node_ids:
            g = self._gslot_of_id.pop(int(nid), None)
            if g is None:
                continue
            self._id_of_gslot[g] = -1
            per_shard[g // self.cap].append(g % self.cap)
        for s, items in enumerate(per_shard):
            if not items:
                continue
            graph, dev = self._graphs[s], self._devices[s]
            slots = torch.tensor(items, dtype=torch.int64, device=dev)
            deleted = torch.zeros((self.cap,), dtype=torch.bool, device=dev)
            deleted[slots] = True
            nb = graph.neighbors
            nb.masked_fill_(deleted[nb.clamp_min(0).long()] & (nb >= 0), -1)
            nb[slots] = -1
            graph.levels[slots] = -1
            self._has_emb[s][slots] = False
            if graph.entry >= 0 and graph.entry in set(items):
                best = int(torch.argmax(graph.levels))
                left = int(graph.levels[best])
                graph.entry = best if left >= 0 else -1
                graph.entry_level = left if left >= 0 else -1
        self._version += 1
        # freed local slots are NOT recycled: routing appends monotonically
        # per shard, so stale references (already cleared above) and id
        # aliasing are structurally impossible

    def delete(self, node_id: int) -> None:
        """Single delete: one-element :meth:`delete_batch` (full edge
        unlink + per-shard entry re-election)."""
        self.delete_batch([node_id])

    # -- persistence ---------------------------------------------------------
    def host_state(self) -> Dict[str, np.ndarray]:
        """Every shard's tables concatenated in shard order, and the id
        map, as host arrays: the JAX package's npz keys."""
        def cat(tensors):
            return np.concatenate([t.cpu().numpy() for t in tensors])

        return dict(
            neighbors=cat([g.neighbors for g in self._graphs]),
            levels=cat([g.levels for g in self._graphs]),
            entry=np.asarray([g.entry for g in self._graphs], np.int32),
            entry_level=np.asarray([g.entry_level for g in self._graphs],
                                   np.int32),
            emb=cat(self._emb),
            has_emb=cat(self._has_emb),
            id_of_gslot=self._id_of_gslot,
            next_in_shard=np.asarray(self._next_in_shard),
            rr=self._rr,
            M=self.M, efc=self.efc, l_max=self.l_max, cap=self.cap,
            n_shards=self.n_shards,
        )

    def save_index(self, path) -> None:
        """Persist all shard tables + id map; the mesh layout is re-applied
        on load (the file is layout-independent). The JAX package's keys,
        uncompressed: the f32 tables barely compress, and deflating a 1M-row
        table costs tens of seconds (``np.load`` reads either form)."""
        np.savez(path, **self.host_state())

    def load_index(self, path) -> None:
        with np.load(path) as z:
            if (int(z["n_shards"]) != self.n_shards
                    or int(z["cap"]) != self.cap):
                raise ValueError(
                    "Mesh/capacity mismatch: index saved with "
                    f"{int(z['n_shards'])} shards x {int(z['cap'])}, "
                    f"this mesh has {self.n_shards} x {self.cap}"
                )
            state = {key: z[key] for key in (
                "neighbors", "levels", "entry", "entry_level", "emb",
                "has_emb")}
            self._id_of_gslot = np.asarray(z["id_of_gslot"])
            self._next_in_shard = [int(v) for v in z["next_in_shard"]]
            self._rr = int(z["rr"])
        for s, dev in enumerate(self._devices):
            rows = slice(s * self.cap, (s + 1) * self.cap)
            self._graphs[s] = K.Graph(
                neighbors=torch.tensor(state["neighbors"][rows], device=dev),
                levels=torch.tensor(state["levels"][rows], device=dev),
                entry=int(state["entry"][s]),
                entry_level=int(state["entry_level"][s]))
            self._emb[s] = torch.tensor(state["emb"][rows], device=dev)
            self._has_emb[s] = torch.tensor(state["has_emb"][rows],
                                            device=dev)
        self._gslot_of_id = {
            int(nid): g for g, nid in enumerate(self._id_of_gslot) if nid >= 0
        }
        self._version += 1
