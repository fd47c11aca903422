"""HNSW index lifecycle service (the port of
vector_db_tpu/services/indexing_service.py).

Parity target: reference ``IndexingService``
(src/vector_db/services/indexing_service.py:14-144): loads M /
ef_construction / flush_threshold from the YAML config, seeds the level rng
with 42, derives a default index file from the storage base path, tracks
``_index_loaded`` / ``_index_modified``, and flushes the index to disk once
``index_size >= flush_threshold`` (after which every insert saves, matching
the reference's observable behavior, indexing_service.py:85-89,137-144).

Additions over the reference, as in the JAX package: ``insert_nodes``
batched ingest (a first batch of >= 4096 nodes into an empty HNSW goes to
``bulk_build``), ``search_batch``, ``index.type`` (hnsw | flat | ivf |
sharded-hnsw: one HNSW shard per visible device of the config's device,
``index.slices`` > 1 for the 2-D mesh), PQ
(``index.pq``, or a search's ``pq_chunks``: IVF-PQ probing on ivf, PQ
traversal on hnsw), residual projection (``index.rp``: RP probing on ivf,
projected traversal on hnsw), the wide beam (``index.wide``, ``mode``:
``pool`` or the pool-free ``beam``), the batch scan route
(``index.scan_batch_threshold``), the filtered engine (``scan`` | ``graph``),
calibrated mode routing (``index.autotune``, ``services/autotune.py``) and
the async threshold flush of batched inserts.

The device is the config's ``device``: ``cpu`` is the CPU; ``cuda`` and the
JAX package's names for the accelerator (``auto``, ``tpu``) are the card,
and raise (``config_device``) when there is none.

The port's tables are updated in place, where the JAX package's device
arrays are immutable; every search therefore runs under the ingest lock,
so it sees the index before or after a whole batch, never a half-written
adjacency. The index keeps its derived tables (HNSW PQ codes, mirrors)
current itself, keyed on its table version, so the service holds no stale
flag of its own where the JAX service marks PQ codes stale after a write.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from vector_db_tpu_torch.config import load_config
from vector_db_tpu_torch.device import config_device
from vector_db_tpu_torch.index.hnsw import HNSW
from vector_db_tpu_torch.observability import count, span
from vector_db_tpu_torch.storage import MMapNodeStorage, NodeStorage
from vector_db_tpu_torch.types import Node

logger = logging.getLogger(__name__)


class IndexingService:
    def __init__(
        self,
        storage: NodeStorage,
        config_path: str,
        index_file: Optional[str] = None,
    ) -> None:
        self.storage = storage
        self.config_path = Path(config_path)
        config = load_config(self.config_path)
        index_config = config.get("index", {})
        M = index_config.get("M", 16)
        ef_construction = index_config.get("ef_construction", 200)
        # Index family selection — the reference's API accepts IVF params
        # (QueryRequest.n_probe, api/models.py:20) but only ever builds HNSW
        # (indexing_service.py:56-64); here `index.type` actually selects.
        self.index_type = str(index_config.get("type", "hnsw")).lower()
        self.device = config_device(config.get("device", "cuda"))

        if index_file:
            self.index_file = Path(index_file)
        elif isinstance(storage, MMapNodeStorage):
            base = storage.embedding_file.parent / storage.embedding_file.stem.replace(
                ".embeddings", ""
            )
            self.index_file = base.with_suffix(".index.npz")
        else:
            raise ValueError(
                "index_file is required for non-mmap storage backends"
            )

        # PQ (config: index.pq: {chunks, ksub, min_size}): once the index
        # holds min_size nodes, codebooks train and ivf probing switches to
        # residual ADC scoring, hnsw traversal to ADC scoring, each with an
        # exact rerank.
        pq_cfg = index_config.get("pq") or {}
        self._pq_chunks = int(pq_cfg.get("chunks", 0) or 0)
        self._pq_ksub = int(pq_cfg.get("ksub", 256))
        self._pq_min_size = int(pq_cfg.get("min_size", 4096))
        # OPQ rotation iterations (0 = plain PQ)
        self._pq_opq_iters = int(pq_cfg.get("opq_iters", 0))
        # residual IVFADC is the recall-correct default for index.type: ivf
        self._pq_residual = bool(pq_cfg.get("residual", True))
        # probe-mode LUT scoring formulation (IvfIndex.search_batch adc=):
        # "pallas" is the adc_probe kernel
        self._pq_adc = str(pq_cfg.get("adc", "pallas"))
        self._pq_active = False
        # Residual projection (config: index.rp: {dims, min_size}): RP
        # probing on ivf (preferred over pq when both are set), projected
        # traversal on hnsw
        rp_cfg = index_config.get("rp") or {}
        self._rp_dims = int(rp_cfg.get("dims", 0) or 0)
        self._rp_min_size = int(rp_cfg.get("min_size", 4096))
        self._rp_active = False
        # Wide-beam traversal (config: index.wide: {dims, seeds, frontier,
        # steps, min_size}) — the frontier-parallel graph search
        # (index/wide_beam.py) for unfiltered hnsw queries once active.
        # dims: 0 = full-dim mirror.
        wide_cfg = index_config.get("wide") or {}
        self._wide_on = bool(wide_cfg.get("enabled", bool(wide_cfg)))
        # 120 keeps the augmented mirror row at exactly 128 lanes (see
        # HNSW.enable_wide)
        self._wide_dims = int(wide_cfg.get("dims", 120) or 0) or None
        self._wide_seeds = int(wide_cfg.get("seeds", 4096))
        self._wide_frontier = int(wide_cfg.get("frontier", 0))
        self._wide_steps = int(wide_cfg.get("steps", 0))
        # set seen_mask: true to keep the pre-merge pool-membership compare
        self._wide_seen = bool(wide_cfg.get("seen_mask", False))
        # pool-merge kernel (sorted_topk): "auto" = on when the index
        # lives on the card; true/false force it
        self._wide_merge_kernel = wide_cfg.get("merge_kernel", False)
        self._wide_min_size = int(wide_cfg.get("min_size", 4096))
        # mode: "pool" (wide_search, an ef-wide pool) or "beam"
        # (beam_search: pool-free, the frontier from each step's candidates)
        self._wide_mode = str(wide_cfg.get("mode", "pool"))
        self._wide_hist = int(wide_cfg.get("hist", 2))
        # optional frontier schedule [[F1, T1], [F2, T2], ...] (pool mode):
        # overrides frontier/steps — wide early, narrow late
        sched = wide_cfg.get("schedule")
        self._wide_schedule = (
            tuple((int(f), int(t)) for f, t in sched) if sched else None)
        # batch sizes >= this route to the bf16 scan instead of the graph
        # (scans amortize every table read over the batch; 0 disables)
        self._scan_batch_threshold = int(
            index_config.get("scan_batch_threshold", 0) or 0)
        # Filtered-query engine (index.filtered_engine: scan | graph).
        # "scan" (default) serves filter_ids queries with the masked bf16
        # corpus scan, which returns the true filtered top-k; "graph" keeps
        # the reference's navigate-but-exclude traversal (reference
        # hnsw.py:89-134 filter contract) for parity.
        self._filtered_engine = str(
            index_config.get("filtered_engine", "scan"))
        self._wide_active = False
        # Calibrated mode routing (config: index.autotune: {target_recall,
        # sample, k, ef_ladder, min_size}) — measures each mode's recall
        # and cost against exact ground truth on the index's device and
        # serves the cheapest one meeting the target (services/autotune.py).
        # Takes precedence over scan_batch_threshold/wide for hnsw queries;
        # per-request override via params.target_recall.
        at_cfg = index_config.get("autotune") or {}
        self._autotune = None
        self._autotune_min_size = int(at_cfg.get("min_size", 4096))
        if at_cfg.get("enabled", bool(at_cfg)):
            from vector_db_tpu_torch.services.autotune import AutoTuner

            self._autotune = AutoTuner(
                target_recall=float(at_cfg.get("target_recall", 0.95)),
                sample=int(at_cfg.get("sample", 256)),
                k=int(at_cfg.get("k", 10)),
                ef_ladder=tuple(
                    int(e) for e in at_cfg.get(
                        "ef_ladder", (64, 128, 256, 512, 1024))),
            )

        rng = random.Random(42)
        if self.index_type == "hnsw":
            self.index = HNSW(
                M=M,
                ef_construction=ef_construction,
                rng=rng,
                storage=storage,
                index_file=self.index_file,
                precision=str(index_config.get("precision", "f32")),
                device=self.device,
            )
        elif self.index_type == "flat":
            from vector_db_tpu_torch.index.flat import FlatIndex

            self.index = FlatIndex(
                storage=storage, index_file=self.index_file,
                metric=str(index_config.get("metric", "l2")),
                precision=str(index_config.get("precision", "f32")),
                bf16_guard=str(index_config.get("bf16_guard", "warn")),
                bf16_guard_recall=float(
                    index_config.get("bf16_guard_recall", 0.9)),
                device=self.device,
            )
            if self.index_file.exists():
                self.index.load_index()
        elif self.index_type == "ivf":
            from vector_db_tpu_torch.index.ivf import IvfIndex

            self.ivf_k = int(index_config.get("ivf_k", 100))
            self.index = IvfIndex(
                k=self.ivf_k, storage=storage, index_file=self.index_file,
                device=self.device,
            )
            # the service owns persistence (threshold flush); per-add
            # npz rewrites are O(corpus) and redundant under it
            self.index.autosave = False
            self._ivf_pending: List[Node] = []
        elif self.index_type == "sharded-hnsw":
            self.index = self._sharded_index(config, M, ef_construction)
            if self.index_file.exists():
                self.index.load_index(self.index_file)
        else:
            raise ValueError(f"Unknown index type: {self.index_type}")
        self._index_loaded = self.index_file.exists()
        self._index_modified = False
        self.flush_threshold = index_config.get("flush_threshold", 1000)
        # Ingest and search lock: the id<->slot maps, storage and the
        # device tables all mutate in place (the reference has no locking
        # at all, SURVEY.md §5 — concurrent writers would race).
        self._lock = threading.RLock()
        # Async threshold flush for BATCHED inserts (index.flush_async,
        # default on): a single worker writes the latest snapshot
        # (latest-wins). The snapshot is a host copy taken under the lock
        # (HNSW.snapshot_for_save), so the worker writes numpy only. The
        # reference-parity single-node path still flushes synchronously
        # (reference indexing_service.py:137-144: the file exists as soon
        # as the threshold-crossing insert returns).
        self._flush_async = bool(index_config.get("flush_async", True))
        self._flush_cv = threading.Condition()
        self._flush_pending: Optional[dict] = None
        self._flush_busy = False
        self._flush_thread: Optional[threading.Thread] = None

    def _sharded_index(self, config: dict, M: int, ef_construction: int):
        """A ShardedHNSW over every visible device of the config's device
        (each CUDA device on the card, one shard on ``cpu``), with
        ``vector_db.capacity`` split evenly; ``index.slices`` > 1 lays the
        devices out as the 2-D ("slice", "shard") mesh."""
        from vector_db_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
        from vector_db_tpu_torch.parallel.sharded import ShardedHNSW

        dim = int(config.get("embedding", {}).get("dimension", 384))
        cap_total = int(config.get("vector_db", {}).get(
            "capacity", 1_000_000
        ))
        mesh = make_mesh(devices=None if self.device.type == "cuda"
                         else [self.device])
        n_dev = mesh.size
        # index.slices > 1 builds the multi-slice ("slice", "shard") mesh:
        # hierarchical merges keep the cross-slice traffic at B·k pairs
        n_slices = int(config.get("index", {}).get("slices", 1) or 1)
        if n_slices > 1:
            if n_dev % n_slices:
                raise ValueError(
                    f"index.slices={n_slices} must divide the "
                    f"{n_dev} visible devices"
                )
            mesh = make_mesh_2d(n_slices, n_dev // n_slices,
                                devices=mesh.devices)
        return ShardedHNSW(
            M=M, ef_construction=ef_construction, dim=dim, mesh=mesh,
            capacity_per_shard=max(256, cap_total // n_dev),
        )

    def is_index_loaded(self) -> bool:
        return self._index_loaded

    def insert_node(self, node: Node) -> None:
        self.insert_nodes([node])

    def insert_nodes(self, nodes: Sequence[Node]) -> None:
        """Batched ingest: one candidate search + commit per batch instead
        of one per node."""
        if not nodes:
            return
        with self._lock:
            self._insert_nodes_locked(nodes, batched=len(nodes) > 1)

    def _insert_nodes_locked(self, nodes: Sequence[Node],
                             batched: bool = False) -> None:
        if self.index_type == "ivf":
            self._ivf_insert(nodes)
        elif (
            self.index_type == "hnsw"
            and self.index.size == 0
            and len(nodes) >= 4096
        ):
            # initial load: the bulk construction from exact/clustered kNN
            # is many times faster than streaming inserts
            self._save_nodes(nodes)
            self.index.bulk_build(
                [n.id for n in nodes],
                np.stack([np.asarray(n.embedding, np.float32)
                          for n in nodes]),
            )
        elif self.index_type == "sharded-hnsw":
            self._save_nodes(nodes)
            self.index.insert(
                [n.id for n in nodes],
                np.stack([np.asarray(n.embedding, np.float32)
                          for n in nodes]),
            )
        else:
            self.index.insert_nodes(list(nodes))
        self._index_modified = True
        if self._should_flush():
            if batched and self._flush_async:
                self._schedule_flush()
            else:
                self.save_index()

    def _save_nodes(self, nodes: Sequence[Node]) -> None:
        """Persist a batch through storage.save_many when available (one
        flush per memmap layer per batch, not two msyncs per node)."""
        save_many = getattr(self.storage, "save_many", None)
        if save_many is not None:
            save_many(list(nodes))
        else:
            for node in nodes:
                self.storage.save(node)

    def _ivf_insert(self, nodes: Sequence[Node]) -> None:
        """IVF needs centroids before it can route adds: queue until
        ivf_k nodes exist, then k-means-build, then stream adds."""
        if self.index.centroids is None:
            self._ivf_pending.extend(nodes)
            self._save_nodes(nodes)
            if len(self._ivf_pending) >= self.ivf_k:
                self.index.build_index(self._ivf_pending)
                self._ivf_pending = []
        else:
            for node in nodes:
                self.index.add(node)

    def delete_node(self, node_id: int) -> None:
        with self._lock:
            self._delete_node_locked(node_id)

    def _delete_node_locked(self, node_id: int) -> None:
        if self.index_type == "ivf":
            self.index.delete(node_id)
            self._ivf_pending = [
                n for n in self._ivf_pending if n.id != node_id
            ]
        elif self.index_type == "sharded-hnsw":
            self.index.delete(node_id)
            if hasattr(self.storage, "delete"):
                self.storage.delete(node_id)
        else:
            self.index.delete_node(node_id)
        self._index_modified = True

    def _maybe_enable_pq(self, requested_chunks: Optional[int]) -> bool:
        """Activate PQ when configured (or requested via the search's
        pq_chunks param) and the corpus is big enough to train codebooks:
        residual IVFADC probing on ivf (codes stay current incrementally:
        IvfIndex.add encodes on the spot), PQ traversal on hnsw (the index
        re-encodes its codes at the first PQ search after a write, keyed on
        its table version, the codebooks not retrained; the JAX service
        marks them stale itself and refreshes them here).
        Returns whether PQ search should be used."""
        if self.index_type not in ("hnsw", "ivf"):
            return False
        chunks = self._pq_chunks or int(requested_chunks or 0)
        if chunks <= 0:
            return False
        if not self._pq_active:
            if self.index.size < max(self._pq_min_size, self._pq_ksub):
                return False
            dim = self.index._dim or 0
            if dim == 0 or dim % chunks != 0:
                return False
            with self._lock:
                if not self._pq_active:
                    extra = ({"residual": self._pq_residual}
                             if self.index_type == "ivf" else {})
                    self.index.enable_pq(
                        chunks=chunks, ksub=self._pq_ksub,
                        opq_iters=self._pq_opq_iters, **extra)
                    self._pq_active = True
        return self._pq_active

    def _maybe_enable_rp(self) -> bool:
        """Activate residual-projection probing for index.type: ivf when
        configured and the corpus is big enough for the PCA train pass.
        Rows added later stay current (IvfIndex.add projects in place)."""
        if self.index_type != "ivf" or self._rp_dims <= 0:
            return False
        if not self._rp_active:
            if (self.index.centroids is None
                    or self.index.size < self._rp_min_size):
                return False
            with self._lock:
                if not self._rp_active:
                    self.index.enable_rp(dims=self._rp_dims)
                    self._rp_active = True
        return self._rp_active

    def _maybe_enable_hnsw_rp(self) -> bool:
        """Activate projected traversal for index.type: hnsw when index.rp
        is configured (the PCA mirror re-projects after a table change, so
        later inserts stay current)."""
        if self.index_type != "hnsw" or self._rp_dims <= 0:
            return False
        if not self._rp_active:
            if self.index.size < self._rp_min_size:
                return False
            with self._lock:
                if not self._rp_active:
                    self.index.enable_rp(dims=self._rp_dims)
                    self._rp_active = True
        return self._rp_active

    def _autotune_ready(self, kwargs) -> bool:
        """Calibrated routing applies to unfiltered hnsw/ivf queries once
        the corpus is big enough for the mode ranking to be meaningful
        (tiny corpora: every mode is exact-ish and microseconds apart).
        For ivf the tuner picks n_probe (recall at a fixed n_probe swings
        widely with the corpus), overriding the request's raw n_probe knob.
        Filtered hnsw queries calibrate per selectivity bucket (the
        scan/graph ranking flips with match fraction); filtered ivf keeps
        the direct path (probe lists already fold the mask)."""
        if self._autotune is None:
            return False
        if self.index_type == "ivf":
            return (kwargs.get("filter_ids") is None
                    and self.index.centroids is not None
                    and self.index.size >= self._autotune_min_size)
        return (self.index_type == "hnsw"
                and self.index.size >= self._autotune_min_size)

    def _maybe_enable_wide(self) -> bool:
        """Activate wide-beam traversal for index.type: hnsw when
        index.wide is configured and the corpus crossed min_size."""
        if self.index_type != "hnsw" or not self._wide_on:
            return False
        if not self._wide_active:
            if self.index.size < self._wide_min_size:
                return False
            with self._lock:
                if not self._wide_active:
                    self.index.enable_wide(
                        dims=self._wide_dims, seeds=self._wide_seeds)
                    self._wide_active = True
        return self._wide_active

    def search(
        self, query: np.ndarray, k: int, **kwargs: Any
    ) -> List[Tuple[Node, float]]:
        with self._lock:
            if self.index_type == "ivf":
                return self._ivf_search(query, k, **kwargs)
            if self.index_type == "sharded-hnsw":
                return self._resolve(*self._sharded_search(
                    np.asarray(query, np.float32)[None, :], k, kwargs), k)
            if self._autotune_ready(kwargs):
                return self._resolve(*self._autotune.route(
                    self, np.asarray(query, np.float32)[None, :], k,
                    kwargs.get("target_recall"),
                    filter_ids=kwargs.get("filter_ids")), k)
            if self._maybe_enable_wide():
                ef = int(kwargs.get("ef", 50) or 50)
                dists, ids = self._wide_dispatch(
                    np.asarray(query, np.float32)[None, :], k, ef,
                    kwargs.get("filter_ids"))
                return self._resolve(dists, ids, k)
            unfiltered = kwargs.get("filter_ids") is None
            q1 = np.asarray(query, np.float32)[None, :]
            ef = int(kwargs.get("ef", 50) or 50)
            if unfiltered and self._maybe_enable_hnsw_rp():
                return self._resolve(*self.index.search_batch_rp(
                    q1, k, ef=max(ef, k), expand=4), k)
            if unfiltered and self._maybe_enable_pq(kwargs.get("pq_chunks")):
                return self._resolve(*self.index.search_batch_pq(
                    q1, k, ef=max(ef, k), expand=4), k)
            return self.index.search(query, k=k, **kwargs)

    def _resolve(self, dists, ids, k):
        out = []
        for nid, d in zip(ids[0], dists[0]):
            if nid < 0:
                continue
            node = self.storage.get(int(nid))
            if node is not None:
                out.append((node, float(d)))
        return out[:k]

    def _ivf_search(self, query, k, **kwargs):
        filter_ids = kwargs.get("filter_ids")
        if self.index.centroids is None:
            # not built yet: brute-force the pending queue (exact)
            cands = [
                (float(np.linalg.norm(query - n.embedding)), n)
                for n in self._ivf_pending
                if filter_ids is None or n.id in filter_ids
            ]
            cands.sort(key=lambda t: t[0])
            return [(n, d) for d, n in cands[:k]]
        if self._autotune_ready(kwargs):
            return self._resolve(*self._autotune.route(
                self, np.asarray(query, np.float32)[None, :], k,
                kwargs.get("target_recall")), k)
        n_probe = int(kwargs.get("n_probe", 10) or 10)
        n_probe = max(1, min(n_probe, self.index.k))
        # RP / PQ probing when configured; filters fold into the validity
        # mask inside the approximate modes (IvfIndex.search_batch)
        use_rp = self._maybe_enable_rp()
        use_pq = (not use_rp
                  and self._maybe_enable_pq(kwargs.get("pq_chunks")))
        dists, ids = self.index.search_batch(
            np.asarray(query, np.float32)[None, :], n_probe=n_probe,
            top_k=k, filter_ids=filter_ids, pq=use_pq, rp=use_rp,
            adc=self._pq_adc,
        )
        return self._resolve(dists, ids, k)

    def _sharded_search(self, queries: np.ndarray, k: int, kwargs):
        """ShardedHNSW's classic fan-out at the request's ef and filter."""
        return self.index.search_batch(
            queries, k=k, ef=int(kwargs.get("ef", 50) or 50),
            filter_ids=kwargs.get("filter_ids"))

    def search_batch(self, queries: np.ndarray, k: int, **kwargs: Any):
        with span("vdb.search_batch", batch=len(queries), k=k) as sp:
            t0 = time.perf_counter_ns()
            with self._lock:
                count("service.lock_wait_ns", time.perf_counter_ns() - t0)
                return self._search_batch_locked(sp, queries, k, kwargs)

    def _routed(self, sp, route: str, queries) -> None:
        """Name the request's route on its span and in the counters."""
        sp.set(route=route)
        count(f"search.requests.{route}")
        count(f"search.queries.{route}", len(queries))

    def _search_batch_locked(self, sp, queries: np.ndarray, k: int,
                             kwargs: dict):
        n_probe = kwargs.pop("n_probe", None)
        if self.index_type == "ivf":
            if self._autotune_ready(kwargs):
                self._routed(sp, "ivf.autotune", queries)
                return self._autotune.route(
                    self, np.asarray(queries, np.float32), k,
                    kwargs.get("target_recall"))
            n_probe = int(n_probe or 10)
            n_probe = max(1, min(n_probe, self.index.k))
            # filters implement tenancy/ACL — forward them (mirrors
            # _ivf_search; a dropped filter silently leaks excluded docs)
            use_rp = self._maybe_enable_rp()
            use_pq = (not use_rp
                      and self._maybe_enable_pq(kwargs.get("pq_chunks")))
            if use_rp:
                route = "ivf.rp"
            elif use_pq:    # at n_probe >= k the index scans every cell
                route = "ivf.pq_scan" if n_probe >= self.index.k else "ivf.pq"
            else:
                route = "ivf"
            self._routed(sp, route, queries)
            return self.index.search_batch(
                queries, n_probe=n_probe, top_k=k,
                filter_ids=kwargs.get("filter_ids"), pq=use_pq,
                rp=use_rp, adc=self._pq_adc,
            )
        if self.index_type == "flat":
            # exact search has no ef/beam knobs
            self._routed(sp, "flat", queries)
            return self.index.search_batch(
                queries, k, filter_ids=kwargs.get("filter_ids")
            )
        if self.index_type == "sharded-hnsw":
            self._routed(sp, "sharded", queries)
            return self._sharded_search(queries, k, kwargs)
        if self._autotune_ready(kwargs):
            self._routed(sp, "hnsw.autotune", queries)
            return self._autotune.route(
                self, np.asarray(queries, np.float32), k,
                kwargs.get("target_recall"),
                filter_ids=kwargs.get("filter_ids"))
        if (self._scan_batch_threshold
                and len(queries) >= self._scan_batch_threshold
                and self.index.size >= self._wide_min_size):
            # batch-throughput mode: the bf16 scan over the same table
            self._routed(sp, "hnsw.scan", queries)
            return self.index.search_batch_scan(
                queries, k, filter_ids=kwargs.get("filter_ids"))
        if self._maybe_enable_wide():
            ef = int(kwargs.get("ef", 50) or 50)
            filter_ids = kwargs.get("filter_ids")
            if filter_ids is not None and self._filtered_engine == "scan":
                route = "hnsw.scan"
            else:
                route = "hnsw.beam" if self._wide_mode == "beam" else "hnsw.wide"
            self._routed(sp, route, queries)
            return self._wide_dispatch(queries, k, ef, filter_ids)
        self._routed(sp, "hnsw", queries)
        return self.index.search_batch(queries, k, **kwargs)

    def _wide_dispatch(self, queries: np.ndarray, k: int, ef: int,
                       filter_ids=None):
        """Route an hnsw batch once wide is active, to index.wide.mode's
        formulation (pool: wide_search; beam: the pool-free beam_search).
        Filtered queries go to the masked bf16 scan under
        index.filtered_engine: scan (the true filtered top-k);
        filtered_engine: graph runs the two-pool wide path in pool mode,
        the trajectory mask in beam mode (the reference
        navigate-but-exclude contract)."""
        if filter_ids is not None and self._filtered_engine == "scan":
            return self.index.search_batch_scan(
                queries, k, filter_ids=filter_ids)
        if self._wide_mode == "beam":
            return self.index.search_batch_beam(
                queries, k, frontier=self._wide_frontier or 224,
                steps=self._wide_steps or 12, hist=self._wide_hist,
                filter_ids=filter_ids)
        return self.index.search_batch_wide(
            queries, k, ef=max(4 * max(ef, k), 64),
            frontier=self._wide_frontier, steps=self._wide_steps,
            seen_mask=self._wide_seen, filter_ids=filter_ids,
            schedule=self._wide_schedule,
            merge_kernel=self._resolve_merge_kernel(),
        )

    def _resolve_merge_kernel(self) -> bool:
        mk = self._wide_merge_kernel
        if mk == "auto":
            return self.device.type == "cuda"
        return bool(mk)

    def save_index(self) -> None:
        self.wait_for_flush()  # one checkpoint writer at a time
        with self._lock:
            if self._index_modified:
                self._do_save()
                self._index_modified = False

    def force_save_index(self) -> None:
        self.wait_for_flush()
        with self._lock:
            self._do_save()
            self._index_modified = False

    def _do_save(self) -> None:
        if self.index_type == "sharded-hnsw":
            self.index.save_index(self.index_file)
        else:
            self.index.save_index()

    # -- async threshold flush (batched ingest path) ----------------------
    def _schedule_flush(self) -> None:
        """Queue the current index state for a background checkpoint write
        (latest-wins). Falls back to a synchronous save for index types
        without snapshot support. Called under self._lock."""
        snapshot = getattr(self.index, "snapshot_for_save", None)
        if snapshot is None:
            self.save_index()
            return
        snap = snapshot()
        if snap is None:
            return
        with self._flush_cv:
            self._flush_pending = snap
            if self._flush_thread is None or not self._flush_thread.is_alive():
                self._flush_thread = threading.Thread(
                    target=self._flush_worker, daemon=True,
                    name="vdb-flush")
                self._flush_thread.start()
            self._flush_cv.notify_all()
        self._index_modified = False

    def _flush_worker(self) -> None:
        while True:
            with self._flush_cv:
                while self._flush_pending is None:
                    self._flush_cv.wait()
                snap = self._flush_pending
                self._flush_pending = None
                self._flush_busy = True
            try:
                self.index.write_snapshot(snap)
            except Exception:  # pragma: no cover - logged, not fatal
                logger.exception("async index flush failed")
            finally:
                with self._flush_cv:
                    self._flush_busy = False
                    self._flush_cv.notify_all()

    def wait_for_flush(self) -> None:
        """Block until no background checkpoint write is queued or in
        flight (used before shutdown / reopen / synchronous saves)."""
        with self._flush_cv:
            while self._flush_pending is not None or self._flush_busy:
                self._flush_cv.wait()

    def get_index_size(self) -> int:
        if self.index_type == "ivf":
            built = self.index.get_cluster_stats()["total_vectors"]
            return built + len(self._ivf_pending)
        return self.index.size

    def _should_flush(self) -> bool:
        return self.get_index_size() >= self.flush_threshold
